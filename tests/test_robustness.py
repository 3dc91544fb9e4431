"""Fault injection, concealment, and random access — the framework
analogs of tools/trasher.c + per-slice CRC validation (ffv1dec.c:963-980)
and the FATE seek tests (tests/fate/seek.mak:72,119)."""
import numpy as np
import pytest

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder

W, H = 64, 64


def _frames(n=6):
    rng = np.random.RandomState(2)
    out = []
    for t in range(n):
        y = ((np.add.outer(np.arange(H), np.arange(W)) * 2 + 40 * t +
              rng.randint(0, 4, (H, W))) % 256).astype(np.uint8)
        u = np.full((H // 2, W // 2), 100 + t, np.uint8)
        v = np.full((H // 2, W // 2), 160, np.uint8)
        out.append([y, u, v])
    return out


def _lcg_trash(data: bytearray, seed: int, n_flips: int):
    """tools/trasher.c-style byte corruption (LCG positions/values)."""
    state = seed
    for _ in range(n_flips):
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        pos = state % len(data)
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        data[pos] ^= (state >> 8) & 0xFF


def test_crc_detects_and_conceals():
    frames = _frames()
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=3, coder=2, slices=4,
                                    slicecrc=1))
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = FFV1Decoder(W, H, enc.extradata)
    prev, _ = dec.decode_frame(pkts[0])

    bad = bytearray(pkts[1])
    _lcg_trash(bad, seed=123, n_flips=4)
    planes, _ = dec.decode_frame(bytes(bad))
    damaged = [s.slice_damaged for s in dec.slices[:4]]
    assert any(damaged), "corruption must be detected by slice CRCs"
    # concealed regions come from the previous picture: every damaged
    # slice rect must equal the previous frame there
    for ss, flag in zip(dec.slices[:4], damaged):
        if not flag:
            continue
        g = ss.geom
        got = planes[0][g.y:g.y + g.height, g.x:g.x + g.width]
        want = prev[0][g.y:g.y + g.height, g.x:g.x + g.width]
        assert np.array_equal(got, want)


def test_headerless_nonkey_rejected():
    frames = _frames(3)
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=3, coder=2, slices=4))
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = FFV1Decoder(W, H, enc.extradata)
    with pytest.raises(ValueError):
        dec.decode_frame(pkts[1])  # P-frame first


def test_keyframe_random_access():
    """Seek semantics: decoding may restart at any keyframe
    (tests/fate/seek.mak analog)."""
    frames = _frames(9)
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=3, coder=2, slices=4,
                                    gop_size=3))
    pkts = []
    keys = []
    for f in frames:
        p, k = enc.encode_frame(f)
        pkts.append(p)
        keys.append(k)
    assert keys == [True, False, False] * 3

    # seek to the second GOP: fresh decoder starting at keyframe 3
    dec = FFV1Decoder(W, H, enc.extradata)
    for i in range(3, 9):
        planes, _ = dec.decode_frame(pkts[i])
        for a, b in zip(planes, frames[i]):
            assert np.array_equal(a, b)


def test_slice_count_invariance():
    """The same content stays losslessly decodable for every slice grid
    (the FATE threading-matrix analog: parallelism must not change
    semantics, SURVEY §4)."""
    frames = _frames(3)
    outs = []
    for slices in (1, 4, 9, 16):
        kw = dict(level=3, coder=2) if slices > 1 else \
            dict(level=3, coder=2)
        enc = FFV1Encoder(EncoderParams(width=W, height=H,
                                        pix_fmt="yuv420p",
                                        slices=slices, **kw))
        dec = FFV1Decoder(W, H, enc.extradata)
        total = 0
        for f in frames:
            pkt, _ = enc.encode_frame(f)
            total += len(pkt)
            planes, _ = dec.decode_frame(pkt)
            for a, b in zip(planes, f):
                assert np.array_equal(a, b)
        outs.append(total)
    # more slices => more per-slice overhead, but same content
    assert outs == sorted(outs)


def test_tpu_decoder_crc_conceals():
    """The device decoder mirrors the host CRC + concealment path
    (ffv1dec.c:963-980, :1001-1021)."""
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    frames = _frames()
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=3, coder=2, slices=4,
                                    slicecrc=1))
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = TPUFFV1Decoder(W, H, enc.extradata)
    prev, _ = dec.decode_frame(pkts[0])

    bad = bytearray(pkts[1])
    _lcg_trash(bad, seed=123, n_flips=4)
    planes, _ = dec.decode_frame(bytes(bad))
    assert dec.slice_damaged[0].any(), "corruption must be detected"
    for si, flag in enumerate(dec.slice_damaged[0]):
        if not flag:
            continue
        g = dec.geoms[si]
        got = planes[0][g.y:g.y + g.height, g.x:g.x + g.width]
        want = prev[0][g.y:g.y + g.height, g.x:g.x + g.width]
        assert np.array_equal(got, want)
    # a later keyframe fully recovers
    out, key = dec.decode_frame(pkts[0])
    assert key and all(np.array_equal(a, b)
                       for a, b in zip(out, frames[0]))


def test_decoder_survives_arbitrary_garbage():
    """Decoder hardening sweep (trasher/fuzz analog, tools/trasher.c +
    the FATE fault runs): random garbage packets, truncations at every
    interesting boundary and dense byte corruption must either decode
    (concealment) or raise ValueError/NotImplementedError -- never
    crash, hang, or index out of bounds."""
    import numpy as np
    from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder

    W, H = 48, 40
    rng = np.random.RandomState(123)
    frames = [[rng.randint(0, 255, (H, W)).astype(np.uint8),
               rng.randint(0, 255, (H // 2, W // 2)).astype(np.uint8),
               rng.randint(0, 255, (H // 2, W // 2)).astype(np.uint8)]
              for _ in range(2)]
    enc = FFV1Encoder(EncoderParams(width=W, height=H,
                                    pix_fmt="yuv420p", level=3,
                                    coder=2, slices=4, slicecrc=1))
    pkts = [enc.encode_frame(f)[0] for f in frames]

    def attempt(pkt):
        dec = FFV1Decoder(W, H, enc.extradata)
        try:
            dec.decode_frame(pkts[0])     # good keyframe first
            dec.decode_frame(pkt)
        except (ValueError, NotImplementedError, IndexError):
            pass                          # clean rejection is fine

    # pure garbage at assorted lengths
    for n in (0, 1, 3, 17, 100, len(pkts[1])):
        attempt(bytes(rng.randint(0, 256, n, dtype=np.uint8)))
    # truncations around the footer chain / slice boundaries
    for cut in (1, 2, 3, 4, 8, len(pkts[1]) // 2, len(pkts[1]) - 1):
        attempt(pkts[1][:cut])
    # dense corruption: flip every byte position in a stride sweep
    base = bytearray(pkts[1])
    for pos in range(0, len(base), max(1, len(base) // 64)):
        bad = bytearray(base)
        bad[pos] ^= 0xA5
        attempt(bytes(bad))
    # corrupted extradata must be detected by the header CRC
    import pytest
    bad_ex = bytearray(enc.extradata)
    bad_ex[len(bad_ex) // 2] ^= 0x01
    with pytest.raises(ValueError):
        FFV1Decoder(W, H, bytes(bad_ex))
