"""Unit tests for the entropy-coding primitives (framework analog of
libavcodec/tests/rangecoder.c and tests/golomb.c)."""
import numpy as np
import pytest

from tpu_ffv1.core.rac import (RangeDecoder, RangeEncoder, build_rac_states,
                               carry_resolve, default_state_tables)
from tpu_ffv1.core.golomb import (BitReader, BitWriter, get_sr_golomb,
                                  get_ur_golomb, set_sr_golomb, set_ur_golomb)
from tpu_ffv1.core.crc import crc32_ieee
from tpu_ffv1.core.intmath import fold, mid_pred, av_log2
from tpu_ffv1.bitstream.symbols import get_symbol, put_symbol


def test_rac_state_tables_shape():
    one, zero = build_rac_states()
    assert one[0] == 0 and zero[0] == 0
    # states stay within [1, 255] on the active probability range
    assert all(1 <= one[i] <= 255 for i in range(256 - 248, 249))
    # zero/one symmetry (rangecoder.c:99-100)
    for i in range(1, 255):
        assert int(zero[i]) == (256 - int(one[256 - i])) % 256


def test_rac_roundtrip_10240_bits():
    """Range-coder self-test shape (libavcodec/tests/rangecoder.c:29-63):
    seeded random bits through one adaptive state, re-decoded exactly."""
    rng = np.random.RandomState(1)
    bits = rng.randint(0, 2, 10240)
    enc = RangeEncoder()
    st = np.array([128], dtype=np.uint8)
    for b in bits:
        enc.put_rac(st, 0, int(b))
    data = enc.terminate()
    dec = RangeDecoder(data)
    st = np.array([128], dtype=np.uint8)
    out = [dec.get_rac(st, 0) for _ in range(10240)]
    assert list(bits) == out


def test_rac_multi_context_roundtrip():
    rng = np.random.RandomState(7)
    n = 5000
    ctxs = rng.randint(0, 32, n)
    bits = rng.randint(0, 2, n)
    enc = RangeEncoder()
    st = np.full(32, 128, dtype=np.uint8)
    for c, b in zip(ctxs, bits):
        enc.put_rac(st, int(c), int(b))
    data = enc.terminate()
    dec = RangeDecoder(data)
    st = np.full(32, 128, dtype=np.uint8)
    for c, b in zip(ctxs, bits):
        assert dec.get_rac(st, int(c)) == b


def test_symbol_roundtrip():
    rng = np.random.RandomState(3)
    vals = list(rng.randint(-100000, 100000, 500)) + \
        [0, 1, -1, 255, -255, 65535, -65535, 1 << 20]
    enc = RangeEncoder()
    st = np.full(32, 128, dtype=np.uint8)
    for v in vals:
        put_symbol(enc, st, int(v), True)
    data = enc.terminate()
    dec = RangeDecoder(data)
    st = np.full(32, 128, dtype=np.uint8)
    for v in vals:
        assert get_symbol(dec, st, True) == v


def test_symbol_unsigned_roundtrip():
    vals = [0, 1, 2, 127, 128, 1000, 123456]
    enc = RangeEncoder()
    st = np.full(32, 128, dtype=np.uint8)
    for v in vals:
        put_symbol(enc, st, v, False)
    data = enc.terminate()
    dec = RangeDecoder(data)
    st = np.full(32, 128, dtype=np.uint8)
    for v in vals:
        assert get_symbol(dec, st, False) == v


def test_provisional_encoder_matches_outstanding():
    """ProvisionalRangeEncoder + carry_resolve must emit the same bytes as
    the outstanding-byte encoder (basis of the device scan)."""
    from tpu_ffv1.core.rac import ProvisionalRangeEncoder

    rng = np.random.RandomState(11)
    bits = rng.randint(0, 2, 4096)
    enc = RangeEncoder()
    penc = ProvisionalRangeEncoder()
    st = np.array([200], dtype=np.uint8)
    st2 = np.array([200], dtype=np.uint8)
    for b in bits:
        enc.put_rac(st, 0, int(b))
        penc.put_rac(st2, 0, int(b))
    data = enc.terminate()
    penc.terminate_provisional()
    assert penc.to_bytes() == data


def test_carry_resolve_matches_c_renorm_machine():
    """Fuzz the provisional carry resolution against a direct emulation of
    the reference's outstanding-byte renorm (rangecoder.h:52-75), over
    arbitrary low sequences — this covers the pathological corners
    (pending-0xFF runs, carry truncation at an exact-0xFF00 emission)."""
    from tpu_ffv1.core.rac import prov_value

    rng = np.random.RandomState(23)
    for trial in range(500):
        n = rng.randint(2, 60)
        lows = rng.randint(0, 0x20000, n)
        lows[0] = rng.randint(0, 0x10000)  # no carry out of the front
        # bias toward the corner cases
        mask = rng.rand(n) < 0.4
        lows[mask] = rng.choice(
            [0xFF00, 0xFF01, 0xFFFF, 0x10000, 0x1FF00, 0x1FFFF],
            size=mask.sum())
        # front byte must neither generate nor propagate a carry (real
        # streams can't carry out of the first byte)
        lows[0] = min(int(lows[0]), 0xFE00)
        lows = np.append(lows, [0, 0])  # flush pendings at the end

        # reference outstanding-byte machine
        out = []
        ob, cnt = -1, 0
        for lw in lows:
            lw = int(lw)
            if ob < 0:
                ob = lw >> 8
            elif lw <= 0xFF00:
                out.append(ob)
                out.extend([0xFF] * cnt)
                cnt = 0
                ob = lw >> 8
            elif lw >= 0x10000:
                out.append((ob + 1) & 0xFF)
                out.extend([0x00] * cnt)
                cnt = 0
                ob = (lw >> 8) & 0xFF
            else:
                cnt += 1

        prov = np.array([prov_value(int(lw)) for lw in lows])
        resolved = carry_resolve(prov)
        assert list(resolved[:-1]) == out, f"trial {trial}"


@pytest.mark.parametrize("k", [0, 1, 2, 5, 8])
def test_golomb_roundtrip(k):
    rng = np.random.RandomState(5)
    vals = [int(v) for v in rng.randint(0, 4000, 200)] + [0, 1, 4094]
    pb = BitWriter()
    for v in vals:
        set_ur_golomb(pb, v, k, 12, 12)
    data = pb.flush()
    gb = BitReader(data)
    for v in vals:
        assert get_ur_golomb(gb, k, 12, 12) == v


def test_signed_golomb_roundtrip():
    vals = [0, 1, -1, 5, -5, 100, -100, 2000, -2000]
    for k in (0, 2, 4):
        pb = BitWriter()
        for v in vals:
            set_sr_golomb(pb, v, k, 12, 12)
        gb = BitReader(pb.flush())
        for v in vals:
            assert get_sr_golomb(gb, k, 12, 12) == v


def test_crc32_append_property():
    """Appending WL32(crc) makes the stream CRC zero (ffv1dec.c:609-618)."""
    data = bytes(range(256)) * 3 + b"hello ffv1"
    crc = crc32_ieee(data)
    assert crc32_ieee(data + int(crc).to_bytes(4, "little")) == 0
    # trailing zero bytes are CRC-neutral (AVI strf padding relies on it)
    assert crc32_ieee(data + int(crc).to_bytes(4, "little") + b"\x00") == 0


def test_intmath():
    assert av_log2(1) == 0 and av_log2(255) == 7 and av_log2(256) == 8
    assert mid_pred(1, 5, 3) == 3
    assert mid_pred(9, 2, 5) == 5
    assert fold(255, 8) == -1
    assert fold(-129, 8) == 127
    assert fold(1 << 15, 16) == -(1 << 15)
