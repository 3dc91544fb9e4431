"""Range-coder lane scans: the choice between the CUDA kernels and the
XLA scans, and the CUDA side's build, registration and JAX wrappers.

The entropy scan is a per-lane serial integer state machine.  On the
GPU it runs as one CUDA launch per scan (native/ffv1_cuda.cu: one block
per lane, the lane's context table in shared memory), called through
``jax.ffi``; on the CPU it runs as the XLA lane scans
(rc_scan_lanes.py, dec_scan_lanes.py), which are also the kernels'
reference.  ``scan_impl`` is the single place the choice is made.

The library is built from the sources under ``native/`` into
``build/`` on first use (``make -C native cuda`` does the same by
hand); a build or load failure raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build")
CUDA_LIB = os.path.join(BUILD_DIR, "libffv1cuda.so")
HOST_LIB = os.path.join(BUILD_DIR, "libffv1scan_host.so")

_ENCODE_TARGET = "ffv1_rc_encode"
_DECODE_TARGET = "ffv1_rc_decode"
_lock = threading.Lock()
_registered = False
_host_lib = None


def scan_impl(platform: str, bits: int) -> str:
    """The range-coder scan for a device platform and coded width:
    ``"cuda"`` on the GPU, ``"xla"`` on the CPU.  Coded widths run
    from 1 to 17 bits (16-bit samples, +1 for RGB and P residuals)."""
    if not 1 <= bits <= 17:
        raise ValueError(f"no range-coder scan for {bits}-bit samples")
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no range-coder scan for platform {platform!r}")


def device_scan(bits: int, device=None) -> str:
    """scan_impl for ``device`` (default: the first JAX device); makes
    the CUDA kernels callable when they are chosen."""
    device = device if device is not None else jax.devices()[0]
    impl = scan_impl(device.platform, bits)
    if impl == "cuda":
        ensure_cuda()
    return impl


# Stream lengths are padded to a multiple of this: the XLA scan advances
# 2 pixels a step and finalize_packed compacts 16-pixel groups.
N_MULTIPLE = 16


def slot_count(bits: int) -> int:
    """Slots per pixel of the packed encode output (the XLA scans'
    decision schedules: rc_scan_fast.chain_order / ext_slots)."""
    return 3 * bits if bits <= 10 else 2 * bits + 1


def _make(target: str, lib: str) -> None:
    cmd = ["make", "-s", "-C", _NATIVE, target, f"PYTHON={sys.executable}"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build {lib}: {e}") from e
    if res.returncode != 0 or not os.path.exists(lib):
        raise RuntimeError(f"building {lib} failed:\n{res.stdout}"
                           f"{res.stderr}")


def ensure_cuda() -> None:
    """Build (if stale) and load the CUDA library and register its FFI
    targets with JAX, once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        _make("cuda", CUDA_LIB)
        lib = ctypes.cdll.LoadLibrary(CUDA_LIB)
        jax.ffi.register_ffi_target(
            _ENCODE_TARGET, jax.ffi.pycapsule(lib.Ffv1RcEncode),
            platform="CUDA")
        jax.ffi.register_ffi_target(
            _DECODE_TARGET, jax.ffi.pycapsule(lib.Ffv1RcDecode),
            platform="CUDA")
        _registered = True


# ----------------------------------------------------------------- encode

def rc_encode_cuda(ctx, diff, active, states0, one_tab, zero_tab, low0,
                   range0, bits: int):
    """CUDA lane scan.  Same inputs as the XLA scans; returns (packed
    int32[N, S, L], low[L], range[L], states uint8[L, CC, 32]) with
    each emitted byte as prov | 1 << 20 at its decision's slot and 0 in
    every other slot."""
    L, N = ctx.shape
    out_types = (
        jax.ShapeDtypeStruct((N, slot_count(bits), L), jnp.int32),
        jax.ShapeDtypeStruct((L,), jnp.int32),
        jax.ShapeDtypeStruct((L,), jnp.int32),
        jax.ShapeDtypeStruct(states0.shape, jnp.uint8))
    return jax.ffi.ffi_call(_ENCODE_TARGET, out_types)(
        ctx.astype(jnp.int32), diff.astype(jnp.int32),
        active.astype(jnp.uint8), states0.astype(jnp.uint8),
        one_tab.astype(jnp.uint8), zero_tab.astype(jnp.uint8),
        low0.astype(jnp.int32), range0.astype(jnp.int32),
        bits=np.int32(bits))


def rc_encode_packed(impl: str, ctx, diff, active, states0, one_tab,
                     zero_tab, low0, range0, bits: int):
    """The lane scan ``impl`` names, in the packed form finalize_packed
    reads: (packed int32[N, S, L] with the emit flag in bit 20, low,
    range, states_out)."""
    if impl == "cuda":
        return rc_encode_cuda(ctx, diff, active, states0, one_tab,
                              zero_tab, low0, range0, bits)
    if impl != "xla":
        raise ValueError(f"unknown scan {impl!r}")
    from .rc_scan_lanes import (rc_encode_scan_lanes_ext,
                                rc_encode_scan_lanes_unrolled)
    if bits <= 10:
        prov, valid, low, rng, states_out = rc_encode_scan_lanes_unrolled(
            ctx, diff, active, states0, one_tab, zero_tab, low0, range0,
            bits, 2)
    else:
        prov, valid, low, rng, states_out = rc_encode_scan_lanes_ext(
            ctx, diff, active, states0, one_tab, zero_tab, low0, range0,
            bits)
    packed = jnp.moveaxis(prov + (valid.astype(jnp.int32) << 20), 1, 2)
    return packed, low, rng, states_out


# ----------------------------------------------------------------- decode

def rc_decode_planes_cuda(bufs, states, one_tab, zero_tab, qt, low0,
                          range0, pos0, plane_specs: tuple, bits: int,
                          five_input: bool):
    """CUDA decode scan with rc_decode_planes_lanes's contract."""
    L = bufs.shape[0]
    sizes = [w * h for (w, h, _b) in plane_specs]
    specs = np.array([[int(w), int(h), int(b)]
                      for (w, h, b) in plane_specs], np.int32).reshape(-1)
    out_types = (
        jax.ShapeDtypeStruct((L, sum(sizes)), jnp.int32),
        jax.ShapeDtypeStruct(states.shape, jnp.uint8),
        jax.ShapeDtypeStruct((L,), jnp.int32),
        jax.ShapeDtypeStruct((L,), jnp.int32),
        jax.ShapeDtypeStruct((L,), jnp.int32))
    flat, states_out, low, rng, pos = jax.ffi.ffi_call(
        _DECODE_TARGET, out_types)(
        bufs.astype(jnp.uint8), states.astype(jnp.uint8),
        one_tab.astype(jnp.uint8), zero_tab.astype(jnp.uint8),
        qt.astype(jnp.int32), low0.astype(jnp.int32),
        range0.astype(jnp.int32), pos0.astype(jnp.int32),
        jnp.asarray(specs), bits=np.int32(bits),
        five=np.int32(bool(five_input)),
        wmax=np.int32(max(w for (w, _h, _b) in plane_specs)))
    planes, off = [], 0
    for (w, h, _b), n in zip(plane_specs, sizes):
        planes.append(flat[:, off:off + n].reshape(L, h, w))
        off += n
    return tuple(planes), states_out, low, rng, pos


def rc_decode_planes(impl: str, bufs, states, one_tab, zero_tab, qt,
                     low0, range0, pos0, plane_specs: tuple, bits: int,
                     five_input: bool):
    """The decode scan ``impl`` names (rc_decode_planes_lanes's
    contract)."""
    if impl == "cuda":
        return rc_decode_planes_cuda(bufs, states, one_tab, zero_tab, qt,
                                     low0, range0, pos0, plane_specs,
                                     bits, five_input)
    if impl != "xla":
        raise ValueError(f"unknown scan {impl!r}")
    from .dec_scan_lanes import rc_decode_planes_lanes
    return rc_decode_planes_lanes(bufs, states, one_tab, zero_tab, qt,
                                  low0, range0, pos0, plane_specs, bits,
                                  five_input)


# ---------------------------------------------- host build (CPU tests)

def _host():
    global _host_lib
    with _lock:
        if _host_lib is None:
            _make("scan-host", HOST_LIB)
            lib = ctypes.cdll.LoadLibrary(HOST_LIB)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.ffv1s_encode.restype = None
            lib.ffv1s_encode.argtypes = [p, p, p, i64, i64, p, i64, p, p, p,
                                         p, i32, p, p, p, p]
            lib.ffv1s_decode.restype = None
            lib.ffv1s_decode.argtypes = [p, i64, i64, p, i64, p, p, p, p, p,
                                         p, p, i32, i32, i32, p, i64, p, p,
                                         p, p]
            _host_lib = lib
        return _host_lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def rc_encode_host(ctx, diff, active, states0, one_tab, zero_tab, low0,
                   range0, bits: int):
    """The CUDA kernels' per-lane encode, compiled for the host: numpy
    in, the outputs of rc_encode_cuda out."""
    ctx = np.ascontiguousarray(ctx, np.int32)
    diff = np.ascontiguousarray(diff, np.int32)
    act = np.ascontiguousarray(active, np.uint8)
    st0 = np.ascontiguousarray(states0, np.uint8)
    one = np.ascontiguousarray(one_tab, np.uint8)
    zero = np.ascontiguousarray(zero_tab, np.uint8)
    lo0 = np.ascontiguousarray(low0, np.int32)
    ra0 = np.ascontiguousarray(range0, np.int32)
    L, N = ctx.shape
    packed = np.empty((N, slot_count(bits), L), np.int32)
    low = np.empty(L, np.int32)
    rng = np.empty(L, np.int32)
    states = np.empty_like(st0)
    i64 = ctypes.c_int64
    _host().ffv1s_encode(
        _ptr(ctx), _ptr(diff), _ptr(act), i64(L), i64(N), _ptr(st0),
        i64(st0.shape[1]), _ptr(one), _ptr(zero), _ptr(lo0), _ptr(ra0),
        ctypes.c_int32(bits), _ptr(packed), _ptr(low), _ptr(rng),
        _ptr(states))
    return packed, low, rng, states


def rc_decode_host(bufs, states0, one_tab, zero_tab, qt, low0, range0,
                   pos0, plane_specs: tuple, bits: int, five_input: bool):
    """The CUDA kernels' per-lane decode, compiled for the host."""
    bufs = np.ascontiguousarray(bufs, np.uint8)
    st0 = np.ascontiguousarray(states0, np.uint8)
    one = np.ascontiguousarray(one_tab, np.uint8)
    zero = np.ascontiguousarray(zero_tab, np.uint8)
    qt = np.ascontiguousarray(qt, np.int32)
    lo0 = np.ascontiguousarray(low0, np.int32)
    ra0 = np.ascontiguousarray(range0, np.int32)
    po0 = np.ascontiguousarray(pos0, np.int32)
    specs = np.ascontiguousarray(np.array(plane_specs, np.int32).reshape(-1))
    L, cap = bufs.shape
    sizes = [w * h for (w, h, _b) in plane_specs]
    flat = np.empty((L, sum(sizes)), np.int32)
    states = np.empty_like(st0)
    low = np.empty(L, np.int32)
    rng = np.empty(L, np.int32)
    pos = np.empty(L, np.int32)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    _host().ffv1s_decode(
        _ptr(bufs), i64(L), i64(cap), _ptr(st0), i64(st0.shape[1]),
        _ptr(one), _ptr(zero), _ptr(qt), _ptr(lo0), _ptr(ra0), _ptr(po0),
        _ptr(specs), i32(len(plane_specs)), i32(bits),
        i32(bool(five_input)), _ptr(flat), i64(flat.shape[1]),
        _ptr(states), _ptr(low), _ptr(rng), _ptr(pos))
    planes, off = [], 0
    for (w, h, _b), n in zip(plane_specs, sizes):
        planes.append(flat[:, off:off + n].reshape(L, h, w))
        off += n
    return tuple(planes), states, low, rng, pos
