"""Device-path parity: the device stencil + scan kernels must produce the
same bytes as the spec path (and hence as the reference binary)."""
import numpy as np
import pytest

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

W, H, N = 48, 40, 4


def _frames(bits, seed=3):
    rng = np.random.RandomState(seed)
    hi = 1 << bits
    dt = np.uint8 if bits <= 8 else np.uint16
    frames = []
    for t in range(N):
        y = ((np.add.outer(np.arange(H), np.arange(W)) * max(hi // 64, 1)
              + t * 7 + rng.randint(0, max(hi // 32, 2), (H, W))) % hi)
        u = rng.randint(0, hi, (H // 2, W // 2))
        v = np.full((H // 2, W // 2), hi // 2)
        frames.append([y.astype(dt), u.astype(dt), v.astype(dt)])
    return frames


CONFIGS = [
    ("420_range_custom", "yuv420p", 8, dict(coder=2, slices=4)),
    ("420_range_default", "yuv420p", 8, dict(coder=-2, slices=4)),
    ("420_ctx1", "yuv420p", 8, dict(coder=2, slices=4, context_model=1)),
    ("420p10", "yuv420p10le", 10, dict(coder=2, slices=4)),
    ("420p16", "yuv420p16le", 16, dict(coder=2, slices=4)),
    ("420_gop2", "yuv420p", 8, dict(coder=2, slices=4, gop_size=2)),
]


@pytest.mark.parametrize("label,pix,bits,kw", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_tpu_encoder_byte_exact(label, pix, bits, kw):
    frames = _frames(bits)
    params = EncoderParams(width=W, height=H, pix_fmt=pix, level=3, **kw)
    spec = FFV1Encoder(params)
    tpu = TPUFFV1Encoder(params)
    assert spec.extradata == tpu.extradata
    for i, f in enumerate(frames):
        sp, sk = spec.encode_frame(f)
        tp, tk = tpu.encode_frame(f)
        assert sk == tk
        assert sp == tp, f"frame {i}: device bytes differ from spec"


@pytest.mark.parametrize("label,pix,bits,kw", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_tpu_decoder_lossless(label, pix, bits, kw):
    frames = _frames(bits)
    params = EncoderParams(width=W, height=H, pix_fmt=pix, level=3, **kw)
    enc = FFV1Encoder(params)
    dec = TPUFFV1Decoder(W, H, enc.extradata)
    for i, f in enumerate(frames):
        pkt, _ = enc.encode_frame(f)
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(a, b), f"frame {i} plane mismatch"


def test_tpu_end_to_end_with_spec_decoder():
    """The device encoder's stream must decode on the spec decoder (and thus on
    the reference binary, by test_vs_reference transitivity)."""
    frames = _frames(8, seed=9)
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=3)
    enc = TPUFFV1Encoder(params)
    dec = FFV1Decoder(W, H, enc.extradata)
    for f in frames:
        pkt, _ = enc.encode_frame(f)
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(a, b)


def test_tpu_batch_streams_byte_exact():
    """batch>1: independent streams in lockstep must each match the
    per-stream spec encoder bytes."""
    B = 2
    streams = [_frames(8, seed=20 + b) for b in range(B)]
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
    tpu = TPUFFV1Encoder(params, batch=B)
    specs = [FFV1Encoder(params) for _ in range(B)]
    for t in range(3):
        results = tpu.encode_frames([streams[b][t] for b in range(B)])
        for b in range(B):
            sp, sk = specs[b].encode_frame(streams[b][t])
            tp, tk = results[b]
            assert sk == tk and sp == tp, f"stream {b} frame {t}"


def test_finalize_packed_matches_finalize_lanes():
    """The resolve-then-compact finalize (invalid slots as neutral carry
    propagators + single key|byte sort) must produce the same bytes as
    the compact-then-resolve reference formulation, including overflow
    pixels (> 4 emissions) via the full-width variant."""
    import jax.numpy as jnp
    from tpu_ffv1.tpu.rc_scan_lanes import (
        finalize_lanes, finalize_packed, finalize_packed_full)

    rng = np.random.RandomState(11)
    Npix, L, S = 64, 5, 13
    for trial in range(6):
        valid = rng.rand(Npix, L, S) < (0.25 if trial % 2 else 0.6)
        if trial < 2:
            # sparse trials: <= 4 emissions per pixel AND <= 24 per
            # 16-pixel group (the two compaction caps) so the
            # non-overflow path is the one being compared
            keep = np.cumsum(valid, axis=2) <= 4
            valid = valid & keep
            vt = valid.transpose(0, 2, 1).reshape(Npix // 16, 16 * S, L)
            vt = vt & (np.cumsum(vt, axis=1) <= 24)
            valid = vt.reshape(Npix // 16, 16, S, L) \
                .transpose(0, 1, 3, 2).reshape(Npix, L, S)
        prov = rng.randint(0, 1 << 17, (Npix, L, S)).astype(np.int32)
        # force long 0xFF propagator runs to stress the carry chain
        ffmask = rng.rand(Npix, L, S) < 0.3
        prov = np.where(ffmask, (prov & ~0x1FF) | 0xFF | (1 << 16), prov)
        low = rng.randint(0, 1 << 16, L).astype(np.int32) << 8
        rg = rng.randint(0x100, 0xFF00, L).astype(np.int32)
        pcap = 8
        plen = rng.randint(1, pcap, L).astype(np.int32)
        prefix = rng.randint(0, 1 << 17, (L, pcap)).astype(np.int32)

        o1, c1 = finalize_lanes(jnp.asarray(prov),
                                jnp.asarray(valid), jnp.asarray(low),
                                jnp.asarray(rg), jnp.asarray(prefix),
                                jnp.asarray(plen))
        packed = jnp.moveaxis(
            jnp.asarray(prov) +
            (jnp.asarray(valid).astype(jnp.int32) << 20), 1, 2)
        o2, c2, ovf = finalize_packed(packed, jnp.asarray(low),
                                      jnp.asarray(rg),
                                      jnp.asarray(prefix),
                                      jnp.asarray(plen))
        ovf = np.asarray(ovf).any()
        if bool(ovf):
            o2, c2 = finalize_packed_full(packed, jnp.asarray(low),
                                          jnp.asarray(rg),
                                          jnp.asarray(prefix),
                                          jnp.asarray(plen))
        assert bool(ovf) == (trial >= 2)  # both paths must be exercised
        c1n, c2n = np.asarray(c1), np.asarray(c2)
        assert (c1n == c2n).all()
        o1n, o2n = np.asarray(o1), np.asarray(o2)
        for li in range(L):
            assert (o1n[li, :c1n[li]] == o2n[li, :c2n[li]]).all(), \
                f"trial {trial} lane {li}"


def test_tpu_pipelined_submit_collect_byte_exact():
    """Depth-2 submit/collect pipelining must produce the same bytes as
    sequential encode_frames (device context chain is unaffected by the
    overlap), including across a GOP boundary."""
    frames = _frames(8, seed=31)
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
    seq = TPUFFV1Encoder(params)
    pipe = TPUFFV1Encoder(params)
    want = [seq.encode_frame(f) for f in frames]

    got = []
    pipe.submit_frames([frames[0]])
    pipe.submit_frames([frames[1]])
    for k in range(2, len(frames)):
        got.append(pipe.collect_frames()[0])
        pipe.submit_frames([frames[k]])
    got.append(pipe.collect_frames()[0])
    got.append(pipe.collect_frames()[0])

    assert len(got) == len(want)
    for t, ((wp, wk), (gp, gk)) in enumerate(zip(want, got)):
        assert wk == gk and wp == gp, f"frame {t}"


def test_tpu_device_source_byte_exact():
    """submit_device_frames (planes already on device, upload skipped)
    must produce the same bytes as the host-source path, across a GOP
    boundary and with batch > 1."""
    import jax.numpy as jnp
    frames = _frames(8, seed=17)
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
    host = TPUFFV1Encoder(params, batch=2)
    dev = TPUFFV1Encoder(params, batch=2)
    want, got = [], []
    for t in range(len(frames) - 1):
        streams = [frames[t], frames[t + 1]]
        want.append(host.encode_frames(streams))
        planes = tuple(
            jnp.asarray(np.stack([s[k] for s in streams]))
            for k in range(3))
        dev.submit_device_frames(planes)
        got.append(dev.collect_frames())
    for t, (wl, gl) in enumerate(zip(want, got)):
        for (wp, wk), (gp, gk) in zip(wl, gl):
            assert wk == gk and wp == gp, f"frame {t}"


def test_tpu_device_transcode_chain():
    """Full on-device transcode: TPUFFV1Decoder(device_out=True) planes
    feed TPUFFV1Encoder.submit_device_frames directly — no pixel ever
    crosses to the host.  The re-encoded packets must equal encoding
    the original frames (lossless decode => identical input pixels)."""
    frames = _frames(8, seed=23)
    src_params = EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                               level=3, coder=2, slices=4)
    src = FFV1Encoder(src_params)
    pkts = [src.encode_frame(f)[0] for f in frames]

    out_params = EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                               level=3, coder=2, slices=4, gop_size=2)
    want = [FFV1Encoder(out_params)]
    wpk = []
    for f in frames:
        wpk.append(want[0].encode_frame(f))

    dec = TPUFFV1Decoder(W, H, src.extradata, device_out=True)
    enc = TPUFFV1Encoder(out_params)
    got = []
    for pkt in pkts:
        planes, _kf = dec.decode_frames([pkt])
        enc.submit_device_frames(planes)
        got.append(enc.collect_frames()[0])
    for t, ((wp, wk), (gp, gk)) in enumerate(zip(wpk, got)):
        assert wk == gk and wp == gp, f"frame {t}"


def test_tpu_batch_decode_lossless():
    """Lane-major batched decode: independent streams decode in lockstep
    losslessly, with GOP context inheritance riding device states."""
    B = 2
    streams = [_frames(8, seed=30 + b) for b in range(B)]
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2, slicecrc=1)
    encs = [FFV1Encoder(params) for _ in range(B)]
    dec = TPUFFV1Decoder(W, H, encs[0].extradata, batch=B)
    for t in range(3):
        pkts = [encs[b].encode_frame(streams[b][t])[0] for b in range(B)]
        results = dec.decode_frames(pkts)
        for b in range(B):
            planes, _ = results[b]
            for a, want in zip(planes, streams[b][t]):
                assert np.array_equal(a, want), f"stream {b} frame {t}"


def test_tpu_decode_pipeline_overlap():
    """submit/collect decode pipelining returns the same frames as the
    synchronous path."""
    frames = _frames(8, seed=41)
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=3)
    enc = FFV1Encoder(params)
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = TPUFFV1Decoder(W, H, enc.extradata)
    dec.submit_frames([pkts[0]])
    dec.submit_frames([pkts[1]])   # one frame in flight while collecting
    got0 = dec.collect_frames()[0][0]
    dec.submit_frames([pkts[2]])
    got1 = dec.collect_frames()[0][0]
    got2 = dec.collect_frames()[0][0]
    for got, want in zip((got0, got1, got2), frames):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_tpu_golomb_device_encode_byte_exact():
    """Device Golomb-Rice path (coder=0 — the reference's default
    coder, ffv1enc.c:326-367) vs the host engine, incl. GOP carry of
    the VlcState tables and batch lockstep."""
    frames = _frames(8)
    kw = dict(width=W, height=H, pix_fmt="yuv420p", level=3, coder=0,
              slices=4, gop_size=2)
    host = FFV1Encoder(EncoderParams(**kw))
    ref = [host.encode_frame(f) for f in frames]
    dev = TPUFFV1Encoder(EncoderParams(**kw), batch=2)
    assert dev.golomb
    for fi, f in enumerate(frames):
        for pkt, kf in dev.encode_frames([f, f]):
            assert pkt == ref[fi][0]
            assert kf == ref[fi][1]


def test_tpu_golomb_gray_and_444():
    for pix in ("gray", "yuv444p"):
        frames = [[p[:1] if False else p for p in f][:1] if pix == "gray"
                  else f for f in _frames(8, seed=9)]
        kw = dict(width=W, height=H, pix_fmt=pix, level=3, coder=0,
                  slices=4)
        if pix == "yuv444p":
            rng = np.random.RandomState(4)
            frames = [[rng.randint(0, 256, (H, W)).astype(np.uint8)
                       for _ in range(3)] for _ in range(2)]
        else:
            frames = [[f[0]] for f in frames[:2]]
        host = FFV1Encoder(EncoderParams(**kw))
        ref = [host.encode_frame(f) for f in frames]
        dev = TPUFFV1Encoder(EncoderParams(**kw))
        for fi, f in enumerate(frames):
            pkt, kf = dev.encode_frame(f)
            assert pkt == ref[fi][0], pix


def test_tpu_rgb_device_encode_byte_exact():
    """Device RGB path (colorspace=1): packed bgr0/bgra with the RCT as
    part of the stencil (ffv1enc.c:447-453), row-interleaved plane
    coding order (ffv1enc.c:428-470), GOP state carry."""
    rng = np.random.RandomState(3)

    def frame(t, alpha):
        f = np.zeros((H, W, 4), np.uint8)
        f[..., 0] = (np.add.outer(np.arange(H), np.arange(W)) + t * 7) % 256
        f[..., 1] = rng.randint(0, 256, (H, W))
        f[..., 2] = (np.add.outer(np.arange(H) * 2, np.arange(W)) + t) % 256
        if alpha:
            f[..., 3] = rng.randint(0, 256, (H, W))
        return f

    for pix in ("bgr0", "bgra"):
        frames = [frame(t, pix == "bgra") for t in range(3)]
        kw = dict(width=W, height=H, pix_fmt=pix, level=3, coder=2,
                  slices=4, gop_size=2)
        host = FFV1Encoder(EncoderParams(**kw))
        ref = [host.encode_frame(f) for f in frames]
        dev = TPUFFV1Encoder(EncoderParams(**kw))
        assert dev.rgb
        for fi, f in enumerate(frames):
            pkt, kf = dev.encode_frame(f)
            assert pkt == ref[fi][0] and kf == ref[fi][1], (pix, fi)


def test_tpu_rgb_device_decode_byte_exact():
    """Device RGB decode (ffv1dec.c:226-280): bgr0/bgra/gbrp9 streams
    reconstruct losslessly with batch lockstep and GOP state carry;
    output layout matches FFV1Decoder (BGRA array / b,g,r planes)."""
    rng = np.random.RandomState(5)

    def frame8(t, alpha):
        f = np.zeros((H, W, 4), np.uint8)
        f[..., 0] = (np.add.outer(np.arange(H), np.arange(W)) + t * 7) % 256
        f[..., 1] = rng.randint(0, 256, (H, W))
        f[..., 2] = (np.add.outer(np.arange(H) * 2, np.arange(W)) + t) % 256
        if alpha:
            f[..., 3] = rng.randint(0, 256, (H, W))
        return f

    for pix in ("bgr0", "bgra", "gbrp9le"):
        kw = dict(width=W, height=H, pix_fmt=pix, level=3, coder=2,
                  slices=4, gop_size=2, slicecrc=1)
        if pix == "gbrp9le":
            frames = [[rng.randint(0, 512, (H, W)).astype(np.uint16)
                       for _ in range(3)] for _ in range(3)]
        else:
            frames = [frame8(t, pix == "bgra") for t in range(3)]
        enc = FFV1Encoder(EncoderParams(**kw))
        pkts = [enc.encode_frame(f)[0] for f in frames]
        hd = FFV1Decoder(W, H, enc.extradata)
        dev = TPUFFV1Decoder(W, H, enc.extradata, batch=2)
        assert dev.rgb
        for t, pkt in enumerate(pkts):
            want, wkf = hd.decode_frame(pkt)
            for planes, kf in dev.decode_frames([pkt, pkt]):
                assert kf == wkf
                assert len(planes) == len(want)
                for a, wp in zip(planes, want):
                    assert np.array_equal(np.asarray(a), wp), (pix, t)


def test_tpu_gbrp9_device_encode_batch():
    """Planar >8-bit RGB on the device path (gbrp9 -> 10-bit coded;
    the reference reads plane 0 into its 'b' variable,
    ffv1enc.c:441-444), batch lockstep."""
    rng = np.random.RandomState(11)
    frames = [[rng.randint(0, 512, (H, W)).astype(np.uint16)
               for _ in range(3)] for _ in range(3)]
    kw = dict(width=W, height=H, pix_fmt="gbrp9le", level=3, coder=2,
              slices=4, gop_size=2)
    host = FFV1Encoder(EncoderParams(**kw))
    ref = [host.encode_frame(f) for f in frames]
    dev = TPUFFV1Encoder(EncoderParams(**kw), batch=2)
    for fi, f in enumerate(frames):
        for pkt, kf in dev.encode_frames([f, f]):
            assert pkt == ref[fi][0] and kf == ref[fi][1], fi


def test_tpu_pcm_fallback_worst_case():
    """Version-4 PCM retry (ffv1enc.c:1207-1217): a geometry whose
    per-slice budget (ffv1enc.c:1281-1311) cannot hold range-coded
    16-bit noise flips slices to slice_coding_mode=1.  The stream must
    stay decodable with contexts reset on PCM slices (ffv1enc.c:
    1054-1056, ffv1dec.c:419-420).  (The reference binary ABORTS on
    this input — its PCM retry re-fails the encode_line w*35 margin
    check, ffv1enc.c:283-287 + the av_assert0 at :1208 — so survival
    here is strictly better than the reference.)"""
    from tpu_ffv1.codec.decoder import FFV1Decoder as HostDecoder
    Wd, Hd = 1024, 4
    rng = np.random.RandomState(2)
    frames = [[rng.randint(0, 65536, (Hd, Wd)).astype(np.uint16)
               for _ in range(3)] for _ in range(2)]
    enc = TPUFFV1Encoder(EncoderParams(
        width=Wd, height=Hd, pix_fmt="yuv444p16le", level=4, strict=-2,
        coder=2, slices=4, gop_size=2))
    pcm_size = None
    dec = HostDecoder(Wd, Hd, enc.extradata)
    for fi, f in enumerate(frames):
        pkt, _ = enc.encode_frame(f)
        if pcm_size is None:
            pcm_size = len(pkt)
        # all-PCM packets are content-independent in size
        assert len(pkt) == pcm_size
        # PCM is 2 bytes/sample + headers; range coding of this noise
        # would need ~2.8+
        assert len(pkt) < Wd * Hd * 3 * 2 + 512
        out, _ = dec.decode_frame(pkt)
        for a, b in zip(out, f):
            assert np.array_equal(np.asarray(a), b)


def test_tpu_golomb_decode():
    """Device Golomb-Rice decode (coder=0): lane-major VLC/run scan vs
    host-encoded streams, across a GOP and batched streams
    (ffv1dec.c:139-170, golomb.h:268-300)."""
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    W2, H2 = 64, 32
    rng = np.random.RandomState(6)
    streams = []
    for s in range(2):
        frames = []
        for t in range(3):
            y = ((np.add.outer(np.arange(H2), np.arange(W2)) * (s + 2)
                  + 3 * t) % 256).astype(np.uint8)
            # flat regions exercise run mode; texture exercises VLC
            y[H2 // 2:] = rng.randint(0, 256, (H2 // 2, W2))
            u = np.full((H2 // 2, W2 // 2), 100 + t, np.uint8)
            v = rng.randint(0, 256, (H2 // 2, W2 // 2)).astype(np.uint8)
            frames.append([y, u, v])
        streams.append(frames)
    params = EncoderParams(width=W2, height=H2, pix_fmt="yuv420p",
                           level=3, coder=0, slices=4, slicecrc=1,
                           gop_size=2)
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[encs[s].encode_frame(f)[0] for f in streams[s]]
            for s in range(2)]
    dec = TPUFFV1Decoder(W2, H2, encs[0].extradata, batch=2)
    assert dec.golomb
    for t in range(3):
        res = dec.decode_frames([pkts[0][t], pkts[1][t]])
        for s in range(2):
            for a, b in zip(res[s][0], streams[s][t]):
                assert np.array_equal(np.asarray(a), b), (t, s)


def test_tpu_golomb_decode_10bit():
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    W2, H2 = 48, 16
    rng = np.random.RandomState(8)
    frames = [[(rng.randint(0, 1024, (H2, W2))).astype(np.uint16),
               np.full((H2 // 2, W2 // 2), 300, np.uint16),
               (rng.randint(0, 1024, (H2 // 2, W2 // 2))).astype(np.uint16)]
              for _ in range(2)]
    params = EncoderParams(width=W2, height=H2, pix_fmt="yuv420p10le",
                           level=3, coder=0, slices=4)
    enc = FFV1Encoder(params)
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = TPUFFV1Decoder(W2, H2, enc.extradata)
    for t, pkt in enumerate(pkts):
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, frames[t]):
            assert np.array_equal(np.asarray(a), b), t


def test_tpu_hostcompact_finalize_byte_exact():
    """Opt-in host-compact finalize (device carry resolution + C
    segment-copy concatenation, FFV1_TPU_HOSTCOMPACT=1) must produce
    the same bytes as the device-sort finalize."""
    from tpu_ffv1 import native
    if not native.available():
        pytest.skip("native tier not built")
    B = 2
    streams = [_frames(8, seed=30 + b) for b in range(B)]
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
    tpu = TPUFFV1Encoder(params, batch=B)
    tpu.host_compact = True      # as FFV1_TPU_HOSTCOMPACT=1 would
    specs = [FFV1Encoder(params) for _ in range(B)]
    for t in range(3):
        results = tpu.encode_frames([streams[b][t] for b in range(B)])
        for b in range(B):
            sp, sk = specs[b].encode_frame(streams[b][t])
            tp, tk = results[b]
            assert sk == tk and sp == tp, f"stream {b} frame {t}"
