"""Device-resident FFV1-P: byte-exactness vs the host FFV1PEncoder and
full roundtrip through the host/device decoders."""
import numpy as np
import pytest

from tpu_ffv1.codec.params import EncoderParams
from tpu_ffv1.pframe.codec import FFV1PDecoder, FFV1PEncoder

W, H = 96, 64


def _moving_scene(n=6, w=W, h=H, seed=5):
    rng = np.random.RandomState(seed)
    base = (np.add.outer(np.arange(h + 64), np.arange(w + 64)) * 5
            % 256).astype(np.uint8)
    tex = rng.randint(0, 12, (h + 64, w + 64)).astype(np.uint8)
    frames = []
    for t in range(n):
        y = (base[t:t + h, 2 * t:2 * t + w] +
             tex[t:t + h, 2 * t:2 * t + w]).astype(np.uint8)
        u = (np.full((h // 2, w // 2), 100) + 2 * t).astype(np.uint8)
        v = (np.full((h // 2, w // 2), 160) - t).astype(np.uint8)
        frames.append([y.copy(), u, v])
    return frames


def _params(**kw):
    d = dict(width=W, height=H, pix_fmt="yuv420p", level=3, coder=2,
             slices=4, gop_size=3, slicecrc=1)
    d.update(kw)
    return EncoderParams(**d)


import pytest


@pytest.fixture(scope="module")
def dev1():
    """One compiled batch-1 device P-encoder for the whole module;
    tests call reset() (the flush analog) instead of recompiling a
    fresh instance (the pipeline lowering dominates suite time)."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    return TPUFFV1PEncoder(_params(), experimental=True)


@pytest.fixture(scope="module")
def dev2():
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    return TPUFFV1PEncoder(_params(), experimental=True, batch=2)


def test_tpu_pframe_byte_exact_gop(dev1):
    frames = _moving_scene()
    host = FFV1PEncoder(_params(), experimental=True)
    ref = [host.encode_frame(f) for f in frames]
    dev = dev1
    dev.reset()
    for fi, f in enumerate(frames):
        pkt, kf = dev.encode_frames([f])[0]
        assert kf == ref[fi][1], f"frame {fi} keyflag"
        assert pkt == ref[fi][0], f"frame {fi} bytes differ"


def test_tpu_pframe_batch_streams(dev2):
    streams = [_moving_scene(seed=5), _moving_scene(seed=9)]
    hosts = [FFV1PEncoder(_params(), experimental=True) for _ in range(2)]
    refs = [[h.encode_frame(f) for f in s]
            for h, s in zip(hosts, streams)]
    dev = dev2
    dev.reset()
    for fi in range(len(streams[0])):
        res = dev.encode_frames([streams[0][fi], streams[1][fi]])
        for bi in range(2):
            assert res[bi][0] == refs[bi][fi][0], (bi, fi)


def test_tpu_pframe_roundtrip_and_compression(dev1):
    frames = _moving_scene(n=5)
    dev = dev1
    dev.reset()
    pkts = [dev.encode_frames([f])[0] for f in frames]
    dec = FFV1PDecoder(W, H, dev.extradata)
    for fi, (pkt, kf) in enumerate(pkts):
        planes, k2 = dec.decode_frame(pkt)
        assert k2 == kf
        for a, b in zip(planes, frames[fi]):
            assert np.array_equal(np.asarray(a), b), fi
    # P frames must actually win vs intra on panning content
    from tpu_ffv1.codec.encoder import FFV1Encoder
    intra = FFV1Encoder(_params(gop_size=0))
    isizes = [len(intra.encode_frame(f)[0]) for f in frames]
    psizes = [len(p) for p, k in pkts if not k]
    assert np.mean(psizes) < np.mean(isizes[1:]), (psizes, isizes)


def test_tpu_pframe_pipelined_submit(dev1):
    frames = _moving_scene(n=6)
    host = FFV1PEncoder(_params(), experimental=True)
    ref = [host.encode_frame(f) for f in frames]
    dev = dev1
    dev.reset()
    dev.submit_frames([frames[0]])
    dev.submit_frames([frames[1]])
    got = []
    for fi in range(2, len(frames)):
        got.append(dev.collect_frames()[0])
        dev.submit_frames([frames[fi]])
    got.append(dev.collect_frames()[0])
    got.append(dev.collect_frames()[0])
    for fi, (pkt, kf) in enumerate(got):
        assert pkt == ref[fi][0], fi


def test_tpu_pframe_decoder_roundtrip(dev1):
    from tpu_ffv1.pframe.tpu import TPUFFV1PDecoder
    frames = _moving_scene(n=6)
    enc = dev1
    enc.reset()
    pkts = [enc.encode_frames([f])[0] for f in frames]
    dec = TPUFFV1PDecoder(W, H, enc.extradata)
    for fi, (pkt, kf) in enumerate(pkts):
        planes, k2 = dec.decode_frame(pkt)
        assert k2 == kf
        for a, b in zip(planes, frames[fi]):
            assert np.array_equal(np.asarray(a), b), fi


def test_tpu_pframe_decoder_batch_and_damage(dev2):
    from tpu_ffv1.pframe.tpu import TPUFFV1PDecoder
    streams = [_moving_scene(seed=5), _moving_scene(seed=11)]
    enc = dev2
    enc.reset()
    pkts = [enc.encode_frames([streams[0][fi], streams[1][fi]])
            for fi in range(len(streams[0]))]
    dec = TPUFFV1PDecoder(W, H, enc.extradata, batch=2)
    for fi in range(len(pkts)):
        res = dec.decode_frames([pkts[fi][0][0], pkts[fi][1][0]])
        for bi in range(2):
            for a, b in zip(res[bi][0], streams[bi][fi]):
                assert np.array_equal(np.asarray(a), b), (fi, bi)
    # trash a P packet byte: decoder must flag + conceal, then recover
    # at the next keyframe (reset = the flush/seek analog, reusing the
    # compiled pipeline)
    dec.reset()
    dec2 = dec
    good0 = dec2.decode_frames([pkts[0][0][0], pkts[0][1][0]])
    bad = bytearray(pkts[1][0][0])
    # flip a byte inside slice 0's PAYLOAD (a footer-field flip breaks
    # the chain walk, which raises like the reference, ffv1dec.c:957)
    s0_start, s0_end = dec2.base._split_slices(bytes(bad))[0]
    bad[(s0_start + s0_end) // 2 - 6] ^= 0x5A
    res = dec2.decode_frames([bytes(bad), pkts[1][1][0]])
    assert dec2.slice_damaged[0].any()
    # damaged rects must equal the PREVIOUS frame's content
    g = dec2.base.geoms
    for si, flag in enumerate(dec2.slice_damaged[0]):
        if not flag:
            continue
        gm = g[si]
        got = np.asarray(res[0][0][0])[gm.y:gm.y + gm.height,
                                       gm.x:gm.x + gm.width]
        want = np.asarray(good0[0][0][0])[gm.y:gm.y + gm.height,
                                          gm.x:gm.x + gm.width]
        assert np.array_equal(got, want)
    # undamaged stream in the same batch stays exact
    for a, b in zip(res[1][0], streams[1][1]):
        assert np.array_equal(np.asarray(a), b)


def test_tpu_pframe_10bit_422():
    """BASELINE config 5's codec shape (10-bit 422 P-frame): device
    encode byte-exact vs host; host decoder roundtrip.  Residuals code
    at 11 bits through the extended schedule."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    w, h = 96, 64
    rng = np.random.RandomState(4)
    base = (np.add.outer(np.arange(h + 32), np.arange(w + 32)) * 9
            % 1024).astype(np.uint16)
    frames = []
    for t in range(4):
        y = ((base[t:t + h, 2 * t:2 * t + w] +
              rng.randint(0, 24, (h, w))) & 1023).astype(np.uint16)
        u = (rng.randint(0, 40, (h, w // 2)) + 300).astype(np.uint16)
        v = (rng.randint(0, 40, (h, w // 2)) + 600).astype(np.uint16)
        frames.append([y, u, v])
    params = EncoderParams(width=w, height=h, pix_fmt="yuv422p10le",
                           level=3, coder=2, slices=4, gop_size=3,
                           slicecrc=1)
    host = FFV1PEncoder(params, experimental=True)
    ref = [host.encode_frame(f) for f in frames]
    dev = TPUFFV1PEncoder(params, experimental=True)
    assert dev.p_bits == 11
    for fi, f in enumerate(frames):
        pkt, kf = dev.encode_frames([f])[0]
        assert pkt == ref[fi][0], f"frame {fi}"
    dec = FFV1PDecoder(w, h, host.extradata)
    for fi, (pkt, kf) in enumerate(ref):
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, frames[fi]):
            assert np.array_equal(np.asarray(a), b), fi


def test_tpu_pframe_decoder_ctx1():
    """5-input context model (context_model=1) through the device
    P-frame decoder: the residual scan must use the quant table /
    context model the slice headers carry (was hardcoded to table 0)."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PDecoder
    frames = _moving_scene(n=4)
    params = _params(context_model=1, strict=-2)
    host = FFV1PEncoder(params, experimental=True)
    pkts = [host.encode_frame(f) for f in frames]
    dec = TPUFFV1PDecoder(W, H, host.extradata)
    for fi, (pkt, kf) in enumerate(pkts):
        planes, k2 = dec.decode_frame(pkt)
        assert k2 == kf
        for a, b in zip(planes, frames[fi]):
            assert np.array_equal(np.asarray(a), b), fi


def test_epzs_search_parity_and_lossless():
    """me='epzs' (predictor-seeded two-stage search): host and device
    encoders share the one jax search function, so packets must stay
    byte-identical, and any MV field decodes losslessly (the decoder is
    search-agnostic).  Also sanity-check the mode actually changes the
    MV choice vs full search on some frame (otherwise the lever is
    dead code)."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder

    # smooth (box-blurred) random texture panned by (1, 2)/frame: the
    # content class pruned search is built for — SAD descends toward
    # the true vector.  _moving_scene's periodic diagonal gradient
    # aliases along dy+dx=const and defeats ANY coarse-to-fine search
    # (EPZS included); motion.py documents that trade.
    rng = np.random.RandomState(8)
    field = rng.randint(0, 255, (H + 80, W + 80)).astype(np.float64)
    k = 7
    c = np.cumsum(np.cumsum(field, 0), 1)
    c = np.pad(c, ((k, 0), (k, 0)))
    smooth = ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
              / (k * k)).astype(np.uint8)
    frames = []
    for t in range(5):
        y = smooth[t:t + H, 2 * t:2 * t + W].copy()
        u = (np.full((H // 2, W // 2), 100) + t).astype(np.uint8)
        v = np.full((H // 2, W // 2), 160, np.uint8)
        frames.append([y, u, v])
    host = FFV1PEncoder(_params(), experimental=True, me="epzs")
    dev = TPUFFV1PEncoder(_params(), experimental=True, me="epzs")
    full = FFV1PEncoder(_params(), experimental=True)  # me="full"
    dec = FFV1PDecoder(W, H, host.extradata)
    differs = False
    sz_e = sz_f = 0
    for t, f in enumerate(frames):
        pkt, kf = host.encode_frame(f)
        got = dev.encode_frames([f])[0]
        assert got == (pkt, kf), f"frame {t}"
        pkt_full, _ = full.encode_frame(f)
        differs |= pkt_full != pkt
        sz_e += len(pkt)
        sz_f += len(pkt_full)
        planes, _ = dec.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(np.asarray(a), b), f"frame {t}"
    # in-GOP sizes should be in the same ballpark — the pruned search
    # trades a little compression for ~4x fewer SAD evaluations
    assert sz_e < sz_f * 1.15, (sz_e, sz_f)


def test_me_mode_validation():
    import pytest as _pytest
    with _pytest.raises(ValueError, match="me must be"):
        FFV1PEncoder(_params(), experimental=True, me="diamond")
