"""Multi-chip slice sharding: the framework's distributed layer.

The reference's only parallelism is slice threads + frame pipelining over
POSIX threads (SURVEY §2.3, pthread_slice.c / pthread_frame.c).  The
device equivalent: FFV1 slices are fully independent bitstreams, so a
frame's (or a batch of frames') slice lanes shard across a device mesh on
a single "slices" axis; the only cross-device data motion is gathering
per-slice byte counts/payloads for footer-chain assembly — exactly the
NCCL-free analog called out in SURVEY §5.

``encode_lanes_sharded`` runs the *production* scan + finalize under
``shard_map``: each device owns L/ndev lanes (slice streams), scans and
finalizes them locally (zero collectives — slices are independent by
format design, ffv1.c:117-145), and the host assembles the footer chain
from the gathered outputs.  The compiled function is cached module-level
(one trace per (mesh, bits)).  The scan is the one cuda_scan.scan_impl
chooses for the mesh's platform: the CUDA kernel's FFI call runs inside
``shard_map`` on each card's local lanes.

``TPUFFV1Encoder(mesh=...)`` (tpu/encoder.py) routes its fused frame
pipeline through the same shard_map; tests/test_sharding.py asserts the
device-count invariance analog of FATE's thread-count invariance
(tests/fate-run.sh:18-19): identical packets on 1/2/8-device meshes.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .cuda_scan import device_scan, rc_decode_planes, rc_encode_packed
from .rc_scan_lanes import finalize_packed_full

_FN_CACHE: dict = {}


def make_mesh(n_devices: int | None = None, axis: str = "slices") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} "
                f"({devs[0].platform})")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _sharded_fn(mesh: Mesh, bits: int):
    """Build (once per (mesh, bits)) the jitted sharded encode."""
    key = (id(mesh), mesh.axis_names, bits)
    fn = _FN_CACHE.get(key)
    if fn is not None:
        return fn
    scan = device_scan(bits, mesh.devices.flat[0])
    axis = mesh.axis_names[0]
    lane = P(axis)
    repl = P()

    def local(ctx, diff, active, states0, one_tab, zero_tab, lows,
              ranges, prefixes, plens):
        packed, low, rng, states_out = rc_encode_packed(
            scan, ctx, diff, active, states0, one_tab, zero_tab, lows,
            ranges, bits)
        out, counts = finalize_packed_full(packed, low, rng,
                                           prefixes, plens)
        return out, counts, states_out

    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(lane, lane, lane, lane, repl, repl,
                  lane, lane, lane, lane),
        out_specs=(lane, lane, lane),
        # FFI out_shapes carry no vma metadata; outputs are plainly
        # lane-sharded (zero collectives)
        check_vma=False)
    fn = jax.jit(smapped)
    _FN_CACHE[key] = fn
    return fn


def _sharded_dec_fn(mesh: Mesh, specs: tuple, bits: int, five: bool):
    """Build (once per (mesh, geometry)) the jitted sharded decode.
    Decode slices are independent bitstreams exactly like encode slices
    (the decoder's slice threads, ffv1dec.c:991-996), so the lane axis
    shards with zero collectives; only the reconstructed planes are
    gathered for frame assembly."""
    key = ("dec", id(mesh), mesh.axis_names, specs, bits, five)
    fn = _FN_CACHE.get(key)
    if fn is not None:
        return fn
    scan = device_scan(bits, mesh.devices.flat[0])
    axis = mesh.axis_names[0]
    lane = P(axis)
    repl = P()

    def local(bufs, states, one_tab, zero_tab, qt, low0, range0, pos0):
        return rc_decode_planes(scan, bufs, states, one_tab, zero_tab, qt,
                                low0, range0, pos0, specs, bits, five)

    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(lane, lane, repl, repl, repl, lane, lane, lane),
        # (planes tuple, states_out, low, rng, pos) — all lane-major
        out_specs=((lane,) * len(specs), lane, lane, lane, lane),
        check_vma=False)
    fn = jax.jit(smapped)
    _FN_CACHE[key] = fn
    return fn


def decode_lanes_sharded(mesh: Mesh, bufs, states, one_tab, zero_tab,
                         qt, low0, range0, pos0, specs: tuple,
                         bits: int, five: bool):
    """Shard the decode lane dimension over the mesh (the multi-chip
    analog of the decoder's slice-thread pool).  Mirrors
    encode_lanes_sharded; returns what rc_decode_planes_lanes returns,
    lane-sharded."""
    L = bufs.shape[0]
    ndev = mesh.devices.size
    if L % ndev:
        raise ValueError(f"lane count {L} not divisible by mesh size "
                         f"{ndev}; pad with inactive lanes")
    fn = _sharded_dec_fn(mesh, specs, bits, five)
    return fn(bufs, states, one_tab, zero_tab, qt, low0, range0, pos0)


def encode_lanes_sharded(mesh: Mesh, ctx, diff, active, states0,
                         one_tab, zero_tab, lows, ranges, prefixes, plens,
                         bits: int):
    """Shard the lane dimension of the production encode over the mesh.

    ctx/diff/active are (L, N) lane-major streams; all lane-major arrays
    are partitioned on lane dim 0 over the "slices" axis.  State tables
    replicate.
    Returns (bytes uint8[L, CAP], counts int32[L], states_out) sharded
    the same way; the host gathers what it consumes for footer assembly.
    """
    L = ctx.shape[0]
    ndev = mesh.devices.size
    if L % ndev:
        raise ValueError(f"lane count {L} not divisible by mesh size "
                         f"{ndev}; pad with inactive lanes")
    fn = _sharded_fn(mesh, bits)
    return fn(ctx, diff, active, states0,
              one_tab, zero_tab, lows, ranges, prefixes, plens)
