"""The range-coder scan choice and the CUDA kernels' surroundings.

The CUDA kernels (native/ffv1_cuda.cu) have no interpret mode, so the
CPU tests check what surrounds them — the scan choice, the FFI
wrappers' shapes against the XLA scans', the encoder's padding — and
their arithmetic through the host build of the same per-lane routines
(native/ffv1_scan.h) against the XLA scans.  The `gpu` test compares
the kernels themselves with the XLA scans at 1080p on the card.
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import custom_state_tables, default_state_tables
from tpu_ffv1.tpu import cuda_scan as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,bits,want", [
    ("gpu", 8, "cuda"), ("gpu", 10, "cuda"), ("gpu", 16, "cuda"),
    ("gpu", 17, "cuda"), ("cpu", 8, "xla"), ("cpu", 17, "xla"),
    ("tpu", 8, ValueError), ("gpu", 18, ValueError),
    ("cpu", 0, ValueError)])
def test_scan_impl(platform, bits, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            cs.scan_impl(platform, bits)
    else:
        assert cs.scan_impl(platform, bits) == want


def test_device_scan_on_cpu_is_xla():
    assert cs.device_scan(8) == "xla"
    assert not cs._registered        # nothing CUDA was built or loaded


def _enc_args(L, N, CC):
    s = jax.ShapeDtypeStruct
    return (s((L, N), jnp.int32), s((L, N), jnp.int32), s((L, N), bool),
            s((L, CC, 32), jnp.uint8), s((256,), jnp.uint8),
            s((256,), jnp.uint8), s((L,), jnp.int32), s((L,), jnp.int32))


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_encode_wrapper_shapes_match_xla(bits):
    L, N, CC = 6, 64, 40
    got = jax.eval_shape(
        lambda *a: cs.rc_encode_cuda(*a, bits), *_enc_args(L, N, CC))
    want = jax.eval_shape(
        lambda *a: cs.rc_encode_packed("xla", *a, bits),
        *_enc_args(L, N, CC))
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in want]
    assert got[0].shape == (N, cs.slot_count(bits), L)


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_decode_wrapper_shapes_match_xla(bits):
    s = jax.ShapeDtypeStruct
    L, CC = 4, 50
    specs = ((24, 6, 0), (12, 3, 25), (12, 3, 25))
    args = (s((L, 4096), jnp.uint8), s((L, CC, 32), jnp.uint8),
            s((256,), jnp.uint8), s((256,), jnp.uint8),
            s((5, 256), jnp.int32), s((L,), jnp.int32),
            s((L,), jnp.int32), s((L,), jnp.int32))
    got = jax.eval_shape(
        lambda *a: cs.rc_decode_planes_cuda(*a, specs, bits, True), *args)
    want = jax.eval_shape(
        lambda *a: cs.rc_decode_planes("xla", *a, specs, bits, True), *args)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert [(x.shape, x.dtype) for x in gl] == \
        [(x.shape, x.dtype) for x in wl]


@pytest.mark.parametrize("w,h,pix_fmt,slices", [
    (1920, 1080, "yuv420p", 24), (100, 60, "yuv444p16le", 4)])
def test_encoder_pads_to_scan_multiple(w, h, pix_fmt, slices):
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    enc = TPUFFV1Encoder(EncoderParams(width=w, height=h, pix_fmt=pix_fmt,
                                       level=3, coder=2, slices=slices))
    assert enc.scan == "xla"
    assert enc.n_max % cs.N_MULTIPLE == 0
    assert 0 <= enc.n_max - max(enc.stream_lens) < cs.N_MULTIPLE
    assert enc.finalize_ng == enc.n_max // 16


def _tables(custom):
    return custom_state_tables(T.VER2_STATE) if custom \
        else default_state_tables()


@pytest.mark.parametrize("bits,custom", [
    (8, False), (9, True), (10, False), (12, True), (16, False),
    (17, True)])
def test_host_encode_matches_xla(bits, custom):
    """Every emitted byte at the XLA scan's slot, and the same coder
    state and context tables, on mixed small/large residuals."""
    rng = np.random.RandomState(bits)
    L, N, CC = 3, 128, 24
    lim = 1 << (bits - 1)
    diff = np.where(rng.rand(L, N) < 0.7, rng.randint(-4, 5, (L, N)),
                    rng.randint(-lim, lim, (L, N))).astype(np.int32)
    ctx = rng.randint(0, CC, (L, N)).astype(np.int32)
    act = np.ones((L, N), bool)
    act[1, 100:] = False
    act[2, ::7] = False
    st0 = rng.randint(1, 255, (L, CC, 32)).astype(np.uint8)
    one, zero = _tables(custom)
    lo0 = rng.randint(0, 0xFF00, L).astype(np.int32)
    ra0 = np.full(L, 0xFF00, np.int32)
    px, lx, rx, sx = cs.rc_encode_packed(
        "xla", *(jnp.asarray(a) for a in (ctx, diff, act, st0, one, zero,
                                          lo0, ra0)), bits)
    ph, lh, rh, sh = cs.rc_encode_host(ctx, diff, act, st0, one, zero,
                                       lo0, ra0, bits)
    px = np.asarray(px)
    assert np.array_equal(px * ((px >> 20) & 1), ph)
    assert ((ph >> 20) & 1).sum() > 0
    for a, b in ((lx, lh), (rx, rh), (sx, sh)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("bits,five", [(8, False), (8, True), (10, True),
                                       (16, False), (17, True)])
def test_host_decode_matches_xla(bits, five):
    """Decode of arbitrary bytes (valid streams and the exponent cap of
    corrupt ones alike): same planes, states and coder state."""
    rng = np.random.RandomState(100 + bits)
    L, cap = 3, 2048
    specs = ((13, 5, 0), (7, 3, 20), (7, 3, 20))
    CC = 20 + 160
    bufs = rng.randint(0, 256, (L, cap)).astype(np.uint8)
    st0 = rng.randint(1, 255, (L, CC, 32)).astype(np.uint8)
    qt = np.clip(np.asarray(T.default_quant_tables(8)[1], np.int32), -3, 3)
    if not five:
        qt[3:] = 0
    one, zero = _tables(bits % 2 == 1)
    lo0 = rng.randint(0, 0xFF00, L).astype(np.int32)
    ra0 = np.full(L, 0xFF00, np.int32)
    po0 = np.full(L, 2, np.int32)
    want = cs.rc_decode_planes(
        "xla", *(jnp.asarray(a) for a in (bufs, st0, one, zero, qt, lo0,
                                          ra0, po0)), specs, bits, five)
    got = cs.rc_decode_host(bufs, st0, one, zero, qt, lo0, ra0, po0, specs,
                            bits, five)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    from tpu_ffv1 import cache
    if env is None:
        monkeypatch.delenv(cache.ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv(cache.ENV, want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.cache_dir() == want
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_needs_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_scans_match_xla_1080p(gpu_device, bits):
    """The CUDA kernels against the XLA scans at 1080p geometry (24
    slices of 480x90 luma + chroma lanes), encode and decode."""
    cs.ensure_cuda()
    rng = np.random.RandomState(bits)
    L, N, CC = 24, 480 * 90 * 3 // 2, 2 * T.CONTEXT_COUNTS[0]
    lim = 1 << (bits - 1)
    diff = np.where(rng.rand(L, N) < 0.9, rng.randint(-4, 5, (L, N)),
                    rng.randint(-lim, lim, (L, N))).astype(np.int32)
    one, zero = default_state_tables()
    enc_args = [jnp.asarray(a) for a in (
        rng.randint(0, CC, (L, N)).astype(np.int32), diff,
        np.ones((L, N), bool), np.full((L, CC, 32), 128, np.uint8), one,
        zero, np.zeros(L, np.int32), np.full(L, 0xFF00, np.int32))]
    got = jax.jit(lambda *a: cs.rc_encode_packed("cuda", *a, bits))(
        *enc_args)
    want = jax.jit(lambda *a: cs.rc_encode_packed("xla", *a, bits))(
        *enc_args)
    pw = np.asarray(want[0])
    assert np.array_equal(np.asarray(got[0]), pw * ((pw >> 20) & 1))
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    specs = ((480, 90, 0), (240, 45, CC // 2), (240, 45, CC // 2))
    qt = np.asarray(T.default_quant_tables(8)[0], np.int32)
    dec_args = [jnp.asarray(a) for a in (
        rng.randint(0, 256, (L, 1 << 17)).astype(np.uint8),
        np.full((L, CC, 32), 128, np.uint8), one, zero, qt,
        np.zeros(L, np.int32), np.full(L, 0xFF00, np.int32),
        np.full(L, 2, np.int32))]
    got = jax.jit(lambda *a: cs.rc_decode_planes(
        "cuda", *a, specs, bits, False))(*dec_args)
    want = jax.jit(lambda *a: cs.rc_decode_planes(
        "xla", *a, specs, bits, False))(*dec_args)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
