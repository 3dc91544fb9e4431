"""Per-slice scalar codec — the bit-exact oracle for slice payloads.

This is the framework's *specification* implementation: simple, sequential,
and exact.  The native C runtime (native/) and the device scan path
(tpu_ffv1/tpu/) are validated byte-for-byte against it.

Behavioral parity references:
  encode: libavcodec/ffv1enc.c:271-473 (encode_line/encode_plane/
          encode_rgb_frame), :240-269 (put_vlc_symbol)
  decode: libavcodec/ffv1dec.c:100-280 (decode_line/decode_plane/
          decode_rgb_frame), :70-98 (get_vlc_symbol)
"""
from __future__ import annotations

import numpy as np

from ..bitstream.symbols import get_symbol, put_symbol
from ..core import tables as T
from ..core.golomb import (BitReader, BitWriter, get_sr_golomb, set_sr_golomb,
                           update_vlc_state, vlc_k)
from ..core.intmath import fold, int16_wrap, mid_pred

_OFF = 3  # sample rows carry a 3-sample left margin (ffv1.c:145: w+6 buffer)


def _get_context(qt: np.ndarray, cur, last, last2, x: int) -> int:
    """Quantized-gradient context (ffv1.h:170-190); rows are margin-offset."""
    lt = int(last[_OFF + x - 1])
    t = int(last[_OFF + x])
    rt = int(last[_OFF + x + 1])
    l = int(cur[_OFF + x - 1])  # noqa: E741
    c = (int(qt[0][(l - lt) & 0xFF]) + int(qt[1][(lt - t) & 0xFF]) +
         int(qt[2][(t - rt) & 0xFF]))
    if qt[3][127]:
        tt = int(last2[_OFF + x])
        ll = int(cur[_OFF + x - 2])
        c += int(qt[3][(ll - l) & 0xFF]) + int(qt[4][(tt - t) & 0xFF])
    return c


def _predict(cur, last, x: int) -> int:
    lt = int(last[_OFF + x - 1])
    t = int(last[_OFF + x])
    l = int(cur[_OFF + x - 1])  # noqa: E741
    return mid_pred(l, l + t - lt, t)


def _put_vlc_symbol(pb: BitWriter, vlc_states, ctx: int, v: int, bits: int):
    """ffv1enc.c:240-269."""
    v = fold(v - int(vlc_states["bias"][ctx]), bits)
    k = vlc_k(vlc_states, ctx)
    mask = -1 if (2 * int(vlc_states["drift"][ctx]) +
                  int(vlc_states["count"][ctx])) < 0 else 0
    code = v ^ mask
    set_sr_golomb(pb, code, k, 12, bits)
    update_vlc_state(vlc_states, ctx, v)


def _get_vlc_symbol(gb: BitReader, vlc_states, ctx: int, bits: int) -> int:
    """ffv1dec.c:70-98."""
    k = vlc_k(vlc_states, ctx)
    v = get_sr_golomb(gb, k, 12, bits)
    mask = -1 if (2 * int(vlc_states["drift"][ctx]) +
                  int(vlc_states["count"][ctx])) < 0 else 0
    v ^= mask
    ret = fold(v + int(vlc_states["bias"][ctx]), bits)
    update_vlc_state(vlc_states, ctx, v)
    return ret


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode_line(rp, ss, coder, plane_index: int, sample, w: int, bits: int,
                stat_hook=None):
    """Code one row of residuals (ffv1enc.c:271-371).

    ``coder`` is (rc, pb): the range coder and bit writer; golomb mode uses
    pb, range mode uses rc.  ``sample`` is [cur, last(, last2)] rows.
    Returns nothing; adapts slice state in place.
    """
    rc, pb = coder
    ps = ss.planes[plane_index]
    run_index = ss.run_index
    run_count = 0
    run_mode = 0

    if ss.slice_coding_mode == 1:
        for x in range(w):
            v = int(sample[0][_OFF + x])
            states = np.full(1, 128, dtype=np.uint8)
            for i in range(bits - 1, -1, -1):
                states[0] = 128
                rc.put_rac(states, 0, (v >> i) & 1)
        return

    qt = ps.quant_table
    for x in range(w):
        context = _get_context(qt, sample[0], sample[1],
                               sample[2] if len(sample) > 2 else None, x)
        diff = int(sample[0][_OFF + x]) - _predict(sample[0], sample[1], x)
        if context < 0:
            context = -context
            diff = -diff
        diff = fold(diff, bits)

        if rp.ac != T.AC_GOLOMB_RICE:
            hook = None
            if stat_hook is not None:
                hook = stat_hook(ps.quant_table_index, context)
            put_symbol(rc, ps.states[context], diff, True, hook)
        else:
            if context == 0:
                run_mode = 1
            if run_mode:
                if diff:
                    while run_count >= (1 << int(T.LOG2_RUN[run_index])):
                        run_count -= 1 << int(T.LOG2_RUN[run_index])
                        run_index += 1
                        pb.put_bits(1, 1)
                    pb.put_bits(1 + int(T.LOG2_RUN[run_index]), run_count)
                    if run_index:
                        run_index -= 1
                    run_count = 0
                    run_mode = 0
                    if diff > 0:
                        diff -= 1
                else:
                    run_count += 1
            if run_mode == 0:
                _put_vlc_symbol(pb, ps.vlc_states, context, diff, bits)

    if run_mode:
        while run_count >= (1 << int(T.LOG2_RUN[run_index])):
            run_count -= 1 << int(T.LOG2_RUN[run_index])
            run_index += 1
            pb.put_bits(1, 1)
        if run_count:
            pb.put_bits(1, 1)
    ss.run_index = run_index


def encode_plane(rp, ss, coder, src: np.ndarray, w: int, h: int,
                 plane_index: int, bits: int, stat_hook=None):
    """ffv1enc.c:373-411.  ``src`` is an (h, w) integer array."""
    ring = 3 if rp.context_model else 2
    buf = [np.zeros(w + 6, dtype=np.int64) for _ in range(ring)]
    ss.run_index = 0
    for y in range(h):
        sample = [buf[(h + i - y) % ring] for i in range(ring)]
        sample[0][_OFF - 1] = sample[1][_OFF + 0]
        sample[1][_OFF + w] = sample[1][_OFF + w - 1]
        if bits <= 8:
            sample[0][_OFF:_OFF + w] = src[y, :w]
        else:
            if rp.packed_at_lsb:
                vals = src[y, :w].astype(np.int64)
            else:
                vals = (src[y, :w].astype(np.int64)) >> (16 - bits)
            # int16_t sample buffer wrap (matters only at bits == 16)
            vals = ((vals + 0x8000) & 0xFFFF) - 0x8000
            sample[0][_OFF:_OFF + w] = vals
        encode_line(rp, ss, coder, plane_index, sample, w, bits, stat_hook)


def encode_rgb_frame(rp, ss, coder, planes, w: int, h: int, stat_hook=None):
    """ffv1enc.c:413-473.

    ``planes``: for <=8-bit packed input, a single (h, w, 4) uint8 array in
    B,G,R,A memory order; for >8-bit, FFmpeg GBR plane order
    [data0, data1, data2] (h, w) uint16.  Note the reference reads plane 0
    into its "b" variable and plane 1 into "g" (ffv1enc.c:441-444) — the
    coded plane order is reproduced operationally, not by color name.
    """
    lbd = rp.bits_per_raw_sample <= 8
    bits = rp.bits_per_raw_sample if rp.bits_per_raw_sample > 0 else 8
    offset = 1 << bits
    ring = 3 if rp.context_model else 2
    nplanes = 3 + (1 if rp.transparency else 0)

    buf = [[np.zeros(w + 6, dtype=np.int64) for _ in range(ring)]
           for _ in range(T.MAX_PLANES)]
    ss.run_index = 0

    for y in range(h):
        sample = [[buf[p][(h + i - y) % ring] for i in range(ring)]
                  for p in range(T.MAX_PLANES)]
        for x in range(w):
            if lbd:
                b = int(planes[y, x, 0])
                g = int(planes[y, x, 1])
                r = int(planes[y, x, 2])
                a = int(planes[y, x, 3])
            else:
                b = int(planes[0][y, x])
                g = int(planes[1][y, x])
                r = int(planes[2][y, x])
                a = 0
            if ss.slice_coding_mode != 1:
                b -= g
                r -= g
                g += (b * ss.slice_rct_by_coef + r * ss.slice_rct_ry_coef) >> 2
                b += offset
                r += offset
            sample[0][0][_OFF + x] = int16_wrap(g)
            sample[1][0][_OFF + x] = int16_wrap(b)
            sample[2][0][_OFF + x] = int16_wrap(r)
            sample[3][0][_OFF + x] = int16_wrap(a)
        for p in range(nplanes):
            sample[p][0][_OFF - 1] = sample[p][1][_OFF + 0]
            sample[p][1][_OFF + w] = sample[p][1][_OFF + w - 1]
            if lbd and ss.slice_coding_mode == 0:
                encode_line(rp, ss, coder, (p + 1) // 2, sample[p], w, 9,
                            stat_hook)
            else:
                encode_line(rp, ss, coder, (p + 1) // 2, sample[p], w,
                            bits + (1 if ss.slice_coding_mode != 1 else 0),
                            stat_hook)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_line(rp, ss, coder, plane_index: int, sample, w: int, bits: int):
    """ffv1dec.c:100-181.  sample = [last, cur] (note decoder order)."""
    rc, gb = coder
    ps = ss.planes[plane_index]
    run_count = 0
    run_mode = 0
    run_index = ss.run_index

    if ss.slice_coding_mode == 1:
        states = np.full(1, 128, dtype=np.uint8)
        for x in range(w):
            v = 0
            for _ in range(bits):
                states[0] = 128
                v += v + rc.get_rac(states, 0)
            sample[1][_OFF + x] = int16_wrap(v)
        return

    qt = ps.quant_table
    for x in range(w):
        context = _get_context(qt, sample[1], sample[0], sample[1], x)
        sign = context < 0
        if sign:
            context = -context

        if rp.ac != T.AC_GOLOMB_RICE:
            diff = get_symbol(rc, ps.states[context], True)
        else:
            if context == 0 and run_mode == 0:
                run_mode = 1
            if run_mode:
                if run_count == 0 and run_mode == 1:
                    if gb.get_bits1():
                        run_count = 1 << int(T.LOG2_RUN[run_index])
                        if x + run_count <= w:
                            run_index += 1
                    else:
                        if T.LOG2_RUN[run_index]:
                            run_count = gb.get_bits(int(T.LOG2_RUN[run_index]))
                        else:
                            run_count = 0
                        if run_index:
                            run_index -= 1
                        run_mode = 2
                run_count -= 1
                if run_count < 0:
                    run_mode = 0
                    run_count = 0
                    diff = _get_vlc_symbol(gb, ps.vlc_states, context, bits)
                    if diff >= 0:
                        diff += 1
                else:
                    diff = 0
            else:
                diff = _get_vlc_symbol(gb, ps.vlc_states, context, bits)

        if sign:
            diff = -diff

        pred = _predict(sample[1], sample[0], x)
        # av_mod_uintp2 then int16_t storage wrap (the row is an int16_t
        # buffer in the reference; the wrap feeds later predictions)
        sample[1][_OFF + x] = int16_wrap((pred + diff) & ((1 << bits) - 1))
    ss.run_index = run_index


def decode_plane(rp, ss, coder, dst: np.ndarray, w: int, h: int,
                 plane_index: int, bits: int):
    """ffv1dec.c:183-224."""
    rows = [np.zeros(w + 6, dtype=np.int64), np.zeros(w + 6, dtype=np.int64)]
    ss.run_index = 0
    for y in range(h):
        rows[0], rows[1] = rows[1], rows[0]
        sample = rows
        sample[1][_OFF - 1] = sample[0][_OFF + 0]
        sample[0][_OFF + w] = sample[0][_OFF + w - 1]
        decode_line(rp, ss, coder, plane_index, sample, w, bits)
        if bits <= 8:
            dst[y, :w] = sample[1][_OFF:_OFF + w] & 0xFF
        else:
            vals = sample[1][_OFF:_OFF + w] & 0xFFFF
            if rp.packed_at_lsb:
                dst[y, :w] = vals
            else:
                dst[y, :w] = (vals << (16 - bits)) & 0xFFFF


def decode_rgb_frame(rp, ss, coder, planes, w: int, h: int):
    """ffv1dec.c:226-280.  ``planes`` matches encode_rgb_frame convention."""
    lbd = rp.bits_per_raw_sample <= 8
    bits = rp.bits_per_raw_sample if rp.bits_per_raw_sample > 0 else 8
    offset = 1 << bits
    nplanes = 3 + (1 if rp.transparency else 0)

    rows = [[np.zeros(w + 6, dtype=np.int64) for _ in range(2)]
            for _ in range(4)]
    ss.run_index = 0

    for y in range(h):
        for p in range(nplanes):
            rows[p][0], rows[p][1] = rows[p][1], rows[p][0]
            sample = rows[p]
            sample[1][_OFF - 1] = sample[0][_OFF + 0]
            sample[0][_OFF + w] = sample[0][_OFF + w - 1]
            if lbd and ss.slice_coding_mode == 0:
                decode_line(rp, ss, coder, (p + 1) // 2, sample, w, 9)
            else:
                decode_line(rp, ss, coder, (p + 1) // 2, sample, w,
                            bits + (1 if ss.slice_coding_mode != 1 else 0))
        for x in range(w):
            g = int(rows[0][1][_OFF + x])
            b = int(rows[1][1][_OFF + x])
            r = int(rows[2][1][_OFF + x])
            a = int(rows[3][1][_OFF + x])
            if ss.slice_coding_mode != 1:
                b -= offset
                r -= offset
                g -= (b * ss.slice_rct_by_coef + r * ss.slice_rct_ry_coef) >> 2
                b += g
                r += g
            if lbd:
                # uint32 LE store b | g<<8 | r<<16 | a<<24 (ffv1dec.c:272)
                word = ((b & 0xFF) + ((g & 0xFF) << 8) + ((r & 0xFF) << 16) +
                        ((a & 0xFF) << 24))
                planes[y, x, 0] = word & 0xFF
                planes[y, x, 1] = (word >> 8) & 0xFF
                planes[y, x, 2] = (word >> 16) & 0xFF
                planes[y, x, 3] = (word >> 24) & 0xFF
            else:
                planes[0][y, x] = b & 0xFFFF
                planes[1][y, x] = g & 0xFFFF
                planes[2][y, x] = r & 0xFFFF
