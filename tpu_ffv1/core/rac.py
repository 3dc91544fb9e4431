"""Binary adaptive range coder, FFV1 flavor (host-side reference).

This is the Python *oracle* implementation of the coder every other path
(native C runtime, device scan path) must match byte-for-byte.

Behavioral parity references (reference tree, read-only — semantics
re-derived, not transcribed): libavcodec/rangecoder.h:35-145,
libavcodec/rangecoder.c:42-116.

Coder model: probability state is one byte per binary context.  Encoding a
bit splits ``range`` at ``range*state>>8``; the state adapts through the
``one_state``/``zero_state`` transition tables.  Renormalization emits one
byte whenever range drops below 2**8; carry propagation into already-emitted
bytes is handled with the classic outstanding-byte scheme (a run of 0xFF
provisional bytes is held back until the carry is resolved).

The encoder here *also* exposes the carry-free "provisional byte" stream
(`emit_provisional`): each renorm emits the 9-bit value low>>8 and a final
right-to-left carry pass resolves them.  This formulation is mathematically
identical to the outstanding-byte scheme and is what the device scan
uses, because it makes every renorm a fixed-cost O(1) step (the carry pass
is an associative scan).
"""
from __future__ import annotations

import numpy as np

# int(0.05 * 2**32) with C double->int truncation (rangecoder usage sites:
# ffv1enc.c:562,841,1288; ffv1dec.c:533,921)
DEFAULT_FACTOR = int(0.05 * (1 << 32))
DEFAULT_MAX_P = 256 - 8


def build_rac_states(factor: int = DEFAULT_FACTOR, max_p: int = DEFAULT_MAX_P):
    """Derive the default probability-state transition tables.

    Mirrors rangecoder.c:63-101 (ff_build_rac_states) exactly, in exact
    integer arithmetic.  Returns (one_state, zero_state) uint8[256].
    """
    one = 1 << 32
    one_state = [0] * 256

    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8

    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8

    zero_state = [0] * 256
    for i in range(1, 255):
        zero_state[i] = (256 - one_state[256 - i]) & 0xFF  # uint8 wrap

    return (np.array(one_state, dtype=np.uint8),
            np.array(zero_state, dtype=np.uint8))


_DEFAULT_ONE, _DEFAULT_ZERO = build_rac_states()


def default_state_tables():
    return _DEFAULT_ONE.copy(), _DEFAULT_ZERO.copy()


def custom_state_tables(state_transition: np.ndarray):
    """Tables from an explicit one_state transition (ffv1.c:95-101)."""
    one = np.zeros(256, dtype=np.uint8)
    zero = np.zeros(256, dtype=np.uint8)
    st = np.asarray(state_transition, dtype=np.int64)
    for j in range(1, 256):
        one[j] = st[j]
        zero[256 - j] = 256 - st[j]
    return one, zero


class RangeEncoder:
    """Byte-oriented adaptive range encoder (rangecoder.h:52-102)."""

    def __init__(self, one_state=None, zero_state=None):
        if one_state is None:
            one_state, zero_state = _DEFAULT_ONE, _DEFAULT_ZERO
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)
        self.low = 0
        self.range = 0xFF00
        self.outstanding_count = 0
        self.outstanding_byte = -1
        self.out = bytearray()

    def set_tables(self, one_state, zero_state):
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xFF" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put_rac(self, states, i, bit):
        """Code one bit under the context state ``states[i]`` (mutates it)."""
        s = int(states[i])
        range1 = (self.range * s) >> 8
        if not bit:
            self.range -= range1
            states[i] = self.zero_state[s]
        else:
            self.low += self.range - range1
            self.range = range1
            states[i] = self.one_state[s]
        self._renorm()

    def put_rac_value(self, state_value: int, bit) -> int:
        """put_rac on a bare state value; returns the updated state."""
        s = int(state_value)
        range1 = (self.range * s) >> 8
        if not bit:
            self.range -= range1
            ns = self.zero_state[s]
        else:
            self.low += self.range - range1
            self.range = range1
            ns = self.one_state[s]
        self._renorm()
        return int(ns)

    def terminate(self) -> bytes:
        """Flush (rangecoder.c:104-116) and return the coded bytes."""
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        assert self.low == 0
        assert self.range >= 0x100
        return bytes(self.out)


def prov_value(low: int) -> int:
    """Encode one renorm emission as a provisional value.

    Bits 0..8: low >> 8 (bit 8 = carry owed to the previous byte).
    Bit 16:    (low & 0xFF) != 0 — distinguishes the C coder's
    pending-0xFF case (low in (0xFF00, 0x10000): carry propagates through)
    from the exact low == 0xFF00 emission (a later carry into that byte is
    *truncated*, mirroring ``outstanding_byte + 1`` overflowing uint8 in
    rangecoder.h:63-67).
    """
    return (low >> 8) | ((1 << 16) if (low & 0xFF) else 0)


def carry_resolve(provisional: np.ndarray) -> np.ndarray:
    """Resolve provisional renorm values into final coded bytes.

    Exact-C carry semantics (rangecoder.h:52-75): per value, generate
    g = bit 8, propagate p = (value == 0xFF and low-byte flag set); the
    carry into byte k-1 is g | (p & carry_in) — an incoming carry never
    cascades past a non-pending byte (uint8 truncation in the reference).
    This is the host-side mirror of the device encoder's final pass.
    """
    v = np.asarray(provisional, dtype=np.int64)
    out = np.zeros(len(v), dtype=np.uint8)
    carry = 0
    for k in range(len(v) - 1, -1, -1):
        val9 = v[k] & 0x1FF
        flag = (v[k] >> 16) & 1
        out[k] = (val9 + carry) & 0xFF
        carry = ((v[k] >> 8) & 1) | (1 if (val9 == 0xFF and flag and carry)
                                     else 0)
    assert carry == 0, "carry out of the first coded byte"
    return out


class ProvisionalRangeEncoder:
    """Range encoder in the carry-free provisional-byte formulation.

    Emits the 9-bit provisional renorm values instead of resolved bytes;
    ``carry_resolve(prov)[:-1]`` after ``terminate()`` yields exactly the
    bytes the outstanding-byte encoder produces (validated in
    tests/test_core.py).  Used to hand partially-encoded slices (keyframe
    bit, slice headers) to the device scan, which continues from
    (low, range) and appends further provisional values.
    """

    def __init__(self, one_state=None, zero_state=None):
        if one_state is None:
            one_state, zero_state = _DEFAULT_ONE, _DEFAULT_ZERO
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)
        self.low = 0
        self.range = 0xFF00
        self.prov: list[int] = []

    def set_tables(self, one_state, zero_state):
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)

    def put_rac(self, states, i, bit):
        s = int(states[i])
        range1 = (self.range * s) >> 8
        if not bit:
            self.range -= range1
            states[i] = self.zero_state[s]
        else:
            self.low += self.range - range1
            self.range = range1
            states[i] = self.one_state[s]
        if self.range < 0x100:
            self.prov.append(prov_value(self.low))
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def terminate_provisional(self):
        """Append the two terminate renorm values (the last one is the
        never-flushed outstanding byte: drop it after carry_resolve)."""
        self.range = 0xFF
        self.low += 0xFF
        self.prov.append(prov_value(self.low))
        self.low = (self.low & 0xFF) << 8
        self.range = 0xFF00
        self.range = 0xFF
        self.prov.append(prov_value(self.low))
        self.low = (self.low & 0xFF) << 8
        self.range = 0xFF00
        return self.prov

    def to_bytes(self) -> bytes:
        return bytes(carry_resolve(np.array(self.prov, dtype=np.int64))[:-1])


class RangeDecoder:
    """Adaptive range decoder (rangecoder.h:104-145, rangecoder.c:53-61)."""

    def __init__(self, buf, one_state=None, zero_state=None):
        if one_state is None:
            one_state, zero_state = _DEFAULT_ONE, _DEFAULT_ZERO
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)
        self.buf = bytes(buf)
        self.pos = 2
        self.end = len(self.buf)
        if len(self.buf) >= 2:
            self.low = (self.buf[0] << 8) | self.buf[1]
        elif len(self.buf) == 1:
            self.low = self.buf[0] << 8
        else:
            self.low = 0
        self.range = 0xFF00

    def set_tables(self, one_state, zero_state):
        self.one_state = np.asarray(one_state, dtype=np.uint8)
        self.zero_state = np.asarray(zero_state, dtype=np.uint8)

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low <<= 8
            if self.pos < self.end:
                self.low += self.buf[self.pos]
            self.pos += 1

    def get_rac(self, states, i) -> int:
        s = int(states[i])
        range1 = (self.range * s) >> 8
        self.range -= range1
        if self.low < self.range:
            states[i] = self.zero_state[s]
            self._refill()
            return 0
        else:
            self.low -= self.range
            states[i] = self.one_state[s]
            self.range = range1
            self._refill()
            return 1

    def get_rac_value(self, state_value: int):
        """get_rac on a bare state value; returns (bit, new_state)."""
        s = int(state_value)
        range1 = (self.range * s) >> 8
        self.range -= range1
        if self.low < self.range:
            ns = self.zero_state[s]
            self._refill()
            return 0, int(ns)
        else:
            self.low -= self.range
            ns = self.one_state[s]
            self.range = range1
            self._refill()
            return 1, int(ns)

    def bytes_consumed(self) -> int:
        """Decoder read position (== c->bytestream - c->bytestream_start)."""
        return self.pos
