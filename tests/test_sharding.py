"""Device-count invariance of the sharded encode path.

The reference validates its parallelism by bit-exactness under every
thread count (tests/fate-run.sh:18-19 parameterizes `threads`; the same
FATE goldens must pass).  The device analog: the full production
encode pipeline under shard_map must emit byte-identical packets on
1-, 2- and 8-device meshes, and identical to the unsharded host encoder.
Runs on the conftest's 8 virtual CPU devices.
"""
import numpy as np
import pytest

from tpu_ffv1.codec.encoder import FFV1Encoder
from tpu_ffv1.codec.params import EncoderParams


def _frames(W, H, n, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n):
        y = ((np.add.outer(np.arange(H), np.arange(W)) + 5 * t) % 256 +
             rng.randint(0, 16, (H, W))).astype(np.uint8)
        u = rng.randint(90, 110, (H // 2, W // 2)).astype(np.uint8)
        v = rng.randint(150, 170, (H // 2, W // 2)).astype(np.uint8)
        out.append([y, u, v])
    return out


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_packet_invariance(ndev):
    """Full TPUFFV1Encoder pipeline on an ndev mesh == host encoder."""
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    from tpu_ffv1.tpu.sharding import make_mesh

    params = EncoderParams(width=64, height=32, pix_fmt="yuv420p",
                           level=3, coder=-2, slices=4, slicecrc=1,
                           gop_size=2)
    mesh = make_mesh(ndev)
    enc = TPUFFV1Encoder(params, batch=2, mesh=mesh)  # L=8 lanes
    hosts = [FFV1Encoder(params, engine="spec") for _ in range(2)]
    for t, fr in enumerate(_frames(64, 32, 2)):
        got = enc.encode_frames([fr, fr])
        for b in range(2):
            ref = hosts[b].encode_frame(fr)
            assert got[b][1] == ref[1]
            assert got[b][0] == ref[0], f"ndev={ndev} frame {t} stream {b}"


def test_encode_lanes_sharded_jits_once():
    """The sharded encode fn is built and compiled once per
    (mesh, bits) — the round-1 version retraced every call."""
    import jax.numpy as jnp
    from tpu_ffv1.core import tables as T
    from tpu_ffv1.core.rac import default_state_tables
    from tpu_ffv1.tpu import sharding as sh

    mesh = sh.make_mesh(2)
    CC = T.CONTEXT_COUNTS[0]
    one, zero = default_state_tables()
    one_t, zero_t = jnp.asarray(one), jnp.asarray(zero)
    rng = np.random.RandomState(0)
    L, N = 4, 64
    args = dict(
        ctx=jnp.asarray(rng.randint(0, CC, (L, N)), jnp.int32),
        diff=jnp.asarray(rng.randint(-100, 100, (L, N)), jnp.int32),
        active=jnp.ones((L, N), bool),
        states0=jnp.full((L, CC, 32), 128, jnp.uint8),
        lows=jnp.zeros(L, jnp.int32),
        ranges=jnp.full(L, 0xFF00, jnp.int32),
        prefixes=jnp.zeros((L, 8), jnp.int32),
        plens=jnp.zeros(L, jnp.int32),
    )
    sh._FN_CACHE.clear()
    out1, cnt1, st1 = sh.encode_lanes_sharded(
        mesh, args["ctx"], args["diff"], args["active"], args["states0"],
        one_t, zero_t, args["lows"], args["ranges"], args["prefixes"],
        args["plens"], 8)
    assert len(sh._FN_CACHE) == 1
    fn = next(iter(sh._FN_CACHE.values()))
    n0 = fn._cache_size()
    out2, cnt2, st2 = sh.encode_lanes_sharded(
        mesh, args["ctx"], args["diff"], args["active"], args["states0"],
        one_t, zero_t, args["lows"], args["ranges"], args["prefixes"],
        args["plens"], 8)
    assert len(sh._FN_CACHE) == 1 and fn._cache_size() == n0
    assert np.array_equal(np.asarray(out1), np.asarray(out2))
    assert np.array_equal(np.asarray(cnt1), np.asarray(cnt2))

    # and the sharded bytes equal the unsharded scan + finalize
    from tpu_ffv1.tpu.rc_scan_lanes import (finalize_packed_full,
                                            rc_encode_scan_lanes)
    prov, valid, low, rng2, st = rc_encode_scan_lanes(
        args["ctx"], args["diff"], args["active"], args["states0"],
        one_t, zero_t, args["lows"], args["ranges"], 8)
    packed = jnp.moveaxis(prov + (valid.astype(jnp.int32) << 20), 1, 2)
    out_ref, cnt_ref = finalize_packed_full(
        packed, low, rng2, args["prefixes"], args["plens"])
    cn = np.asarray(cnt_ref)
    for li in range(L):
        assert np.array_equal(np.asarray(out1)[li, :cn[li]],
                              np.asarray(out_ref)[li, :cn[li]])
    assert np.array_equal(np.asarray(st1), np.asarray(st))


def test_dryrun_multichip_entry():
    """The driver artifact itself: must pass in-process regardless of
    environment (it self-forces the CPU mesh)."""
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_decode_invariance(ndev):
    """TPUFFV1Decoder on an ndev mesh reconstructs host-encoded GOP
    streams losslessly — the decode-side device-count invariance
    (decode slice lanes shard like the reference's decoder slice
    threads, ffv1dec.c:991-996)."""
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.sharding import make_mesh

    params = EncoderParams(width=64, height=32, pix_fmt="yuv420p",
                           level=3, coder=2, slices=4, slicecrc=1,
                           gop_size=2)
    frames = _frames(64, 32, 3)
    encs = [FFV1Encoder(params) for _ in range(2)]
    streams = [[e.encode_frame(f)[0] for f in frames] for e in encs]
    dec = TPUFFV1Decoder(64, 32, encs[0].extradata, batch=2,
                         mesh=make_mesh(ndev))  # L=8 lanes
    for t in range(len(frames)):
        got = dec.decode_frames([streams[0][t], streams[1][t]])
        for b in range(2):
            planes, kf = got[b]
            assert kf == (t % 2 == 0)
            for a, w in zip(planes, frames[t]):
                assert np.array_equal(np.asarray(a), w), \
                    f"ndev={ndev} frame {t} stream {b}"


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_golomb_invariance(ndev):
    """Golomb-Rice (coder=0) encode sharded over a mesh == host encoder
    (the VLC scan shard_maps exactly like the range-coder path: slice
    lanes are independent bitstreams)."""
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    from tpu_ffv1.tpu.sharding import make_mesh

    params = EncoderParams(width=64, height=32, pix_fmt="yuv420p",
                           level=3, coder=0, slices=4, slicecrc=1)
    mesh = make_mesh(ndev)
    enc = TPUFFV1Encoder(params, batch=2, mesh=mesh)
    hosts = [FFV1Encoder(params, engine="spec") for _ in range(2)]
    for t, fr in enumerate(_frames(64, 32, 2)):
        got = enc.encode_frames([fr, fr])
        for b in range(2):
            ref = hosts[b].encode_frame(fr)
            assert got[b][0] == ref[0], f"ndev={ndev} frame {t} stream {b}"


def test_mesh_deep_bit_invariance():
    """16-bit encode AND decode under shard_map (2 devices): the
    extended encode schedule and the clipped-row decode scan both ride
    the mesh path byte-exactly."""
    import numpy as np
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    from tpu_ffv1.tpu.sharding import make_mesh

    W, H = 48, 32
    params = EncoderParams(width=W, height=H, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, slicecrc=1,
                           gop_size=2)
    rng = np.random.RandomState(6)
    frames = [[rng.randint(0, 65536, (H, W)).astype(np.uint16)
               for _ in range(3)] for _ in range(3)]
    host = FFV1Encoder(params, engine="spec")
    ref = [host.encode_frame(f) for f in frames]
    enc = TPUFFV1Encoder(params, mesh=make_mesh(2))
    for t, f in enumerate(frames):
        got = enc.encode_frames([f])[0]
        assert got == ref[t], f"frame {t}"
    dec = TPUFFV1Decoder(W, H, host.extradata, mesh=make_mesh(2))
    for t, (pkt, _k) in enumerate(ref):
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, frames[t]):
            assert np.array_equal(np.asarray(a), b), t


def test_mesh_decode_honors_scan_choice(monkeypatch):
    """The mesh decode runs the scan cuda_scan.scan_impl picks for the
    mesh's platform and the stream's coded width (the XLA scan on this
    CPU mesh), and reconstructs a 16-bit stream losslessly."""
    import tpu_ffv1.tpu.sharding as sharding
    from tpu_ffv1.tpu.cuda_scan import scan_impl
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.sharding import make_mesh

    W, H = 48, 32
    params = EncoderParams(width=W, height=H, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4)
    rng = np.random.RandomState(2)
    frame = [rng.randint(0, 65536, (H, W)).astype(np.uint16)
             for _ in range(3)]
    host = FFV1Encoder(params, engine="spec")
    pkt, _ = host.encode_frame(frame)

    seen = []
    real = sharding.rc_decode_planes

    def spy(impl, *a):
        seen.append((impl, a[-2]))
        return real(impl, *a)

    monkeypatch.setattr(sharding, "rc_decode_planes", spy)
    sharding._FN_CACHE.clear()
    mesh = make_mesh(2)
    dec = TPUFFV1Decoder(W, H, host.extradata, mesh=mesh)
    want = scan_impl(mesh.devices.flat[0].platform, 16)
    assert dec.scan == want == "xla"
    planes, _ = dec.decode_frame(pkt)
    assert seen == [(want, 16)]          # traced once, inside shard_map
    for a, b in zip(planes, frame):
        assert np.array_equal(np.asarray(a), b)
