"""Lane-major device decode: many slices/streams per scan step.

Decode is inherently pixel-serial per slice — each reconstructed sample
feeds the next pixel's context (ffv1dec.c:100-181) — but slices are
independent bitstreams, so L slice lanes (slices x stream batch) advance
in lockstep through ONE two-level lax.scan per plane type, mirroring the
encode design (rc_scan_lanes.py).  This replaces the round-1 driver's
serial per-(slice, plane) dispatch: per frame batch there are now
n_plane_types chained device scans instead of slices x planes dispatches,
and every carried quantity is (L, ...)-vectorized.

Gather-free design (the CPU path, and the CUDA kernel's reference):
  * table lookups (quant tables, state-transition tables) run as
    arithmetic binary-select trees over table halves — ~10 fused vector
    ops each, no gather.  Transitions use the single-table identity
    zero[s] = (256 - one[(256-s) & 0xFF]) & 0xFF (rangecoder.c).
  * the range-decoder byte refills consume from a per-pixel (L, 32)
    byte WINDOW fetched with ONE take_along_axis per pixel (a pixel
    consumes at most S < 32 bytes); in-window reads are arithmetic
    one-hots.
  * per pixel there is ONE state-row gather (L, 32) and ONE scatter;
    all of the pixel's get_rac decisions update the row locally
    (static indices for the zero/exponent slots, masked one-hot
    updates for the lane-dynamic mantissa/sign slots).

Behavioral parity: ffv1dec.c:42-63 (get_symbol), :100-181 (decode_line),
rangecoder.h:104-145 (get_rac/refill).  Covers every coded width the
format produces (<= 16 planar, 17 for deep RGB): get_symbol's FFMIN row
caps (1+min(j,9), 22+min(i,9)) make rows 10 and 31 carry several
decisions per pixel above 10 bits, which is naturally correct here —
the state row threads through the decision chain functionally, so
repeated slots just transition sequentially.  The per-pixel byte
window widens from 32 to 40 bytes above 10 bits (worst case one renorm
byte per decision: 1 + (e_max+1) + e_max + 1 <= 35 for 17-bit).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _tree_lookup(tab, idx):
    """tab[idx] for a (256,) int32 table and (L,) int32 idx in [0, 255],
    as an arithmetic binary-select tree (no gather)."""
    lo, hi = tab[:128], tab[128:]
    c = lo[None, :] + (hi - lo)[None, :] * (((idx >> 7) & 1))[:, None]
    c = c[:, :64] + (c[:, 64:] - c[:, :64]) * (((idx >> 6) & 1))[:, None]
    c = c[:, :32] + (c[:, 32:] - c[:, :32]) * (((idx >> 5) & 1))[:, None]
    c = c[:, :16] + (c[:, 16:] - c[:, :16]) * (((idx >> 4) & 1))[:, None]
    c = c[:, :8] + (c[:, 8:] - c[:, :8]) * (((idx >> 3) & 1))[:, None]
    d = jnp.arange(8, dtype=jnp.int32)[None, :] - (idx & 7)[:, None]
    return jnp.sum(c * jnp.maximum(0, 1 - d * d), axis=1)


def _machinery(bufs, states, one_tab, qt, bits: int, five_input: bool):
    """Shared scan machinery (rac decisions, per-pixel get_symbol,
    per-plane row loop) over the lane-major buffers; used by the planar
    YUV/gray path (rc_decode_planes_lanes) and the line-interleaved RGB
    path (rc_decode_rgb_lanes)."""
    L, CC = states.shape[0], states.shape[1]
    cap = bufs.shape[1]
    lane_base = jnp.arange(L, dtype=jnp.int32) * CC
    S0 = states.reshape(L * CC, 32).astype(jnp.int32)
    bufs_i32 = bufs.astype(jnp.int32)
    one32 = one_tab.astype(jnp.int32)
    e_max = bits - 1          # folded residual: |v| <= 1 << (bits-1)
    mask_v = (1 << bits) - 1
    pos32v = jnp.arange(32, dtype=jnp.int32)[None, :]
    qtabs = [qt[k] for k in range(5)]
    # window must cover one renorm byte per decision of the widest
    # pixel: 1 + (e_max+1) + e_max + 1 decisions
    WIN = 32 if bits <= 10 else 40
    iotaWv = jnp.arange(WIN, dtype=jnp.int32)

    def transition(s, bit):
        """bit ? one[s] : zero[s] via the single-table identity."""
        idx = jnp.where(bit, s, (256 - s) & 0xFF)
        t = _tree_lookup(one32, idx)
        return jnp.where(bit, t, (256 - t) & 0xFF)

    def win_byte(win, k):
        """win[:, k] for (L,) k — arithmetic one-hot read."""
        d = iotaWv[None, :] - k[:, None]
        return jnp.sum(win * jnp.maximum(0, 1 - d * d), axis=1)

    def rac(row, idx_static, idx_dyn, win, woff, low, rng, pos, active):
        """One adaptive binary decision at row position idx (static int
        or (L,) dynamic).  woff = pos - window base."""
        if idx_dyn is None:
            s = row[:, idx_static]
        else:
            d = pos32v - idx_dyn[:, None]
            s = jnp.sum(row * jnp.maximum(0, 1 - d * d), axis=1)
        r1 = (rng * s) >> 8
        r0 = rng - r1
        bit = low >= r0
        nlow = jnp.where(bit, low - r0, low)
        nrng = jnp.where(bit, r1, r0)
        ns = transition(s, bit)
        if idx_dyn is None:
            row = row.at[:, idx_static].set(
                jnp.where(active, ns, row[:, idx_static]))
        else:
            upd = active[:, None] & (pos32v == idx_dyn[:, None])
            row = jnp.where(upd, ns[:, None], row)
        low = jnp.where(active, nlow, low)
        rng = jnp.where(active, nrng, rng)
        # refill from the window
        need = active & (rng < 0x100)
        nxt = win_byte(win, woff)
        low = jnp.where(need, (low << 8) + nxt, low)
        rng = jnp.where(need, rng << 8, rng)
        pos = pos + need.astype(jnp.int32)
        woff = woff + need.astype(jnp.int32)
        return bit & active, row, low, rng, pos, woff

    def make_pixel(w, plane_base):
        def pixel(carry, x):
            cur, prev, cl, plft, S, low, rng, pos = carry
            xm1 = jnp.maximum(x - 1, 0)
            xm2 = jnp.maximum(x - 2, 0)
            T = prev[:, x]
            RT = prev[:, jnp.minimum(x + 1, w - 1)]
            Lv = jnp.where(x > 0, cur[:, xm1], cl)
            LT = jnp.where(x > 0, prev[:, xm1], plft)

            ctx = (_tree_lookup(qtabs[0], (Lv - LT) & 0xFF) +
                   _tree_lookup(qtabs[1], (LT - T) & 0xFF) +
                   _tree_lookup(qtabs[2], (T - RT) & 0xFF))
            if five_input:
                TT = cur[:, x]      # stale two-rows-ago (2-row ring)
                LL = jnp.where(x > 1, cur[:, xm2],
                               jnp.where(x == 1, cl, 0))
                ctx = ctx + _tree_lookup(qtabs[3], (LL - Lv) & 0xFF) + \
                    _tree_lookup(qtabs[4], (TT - T) & 0xFF)
            sign = ctx < 0
            ctx = jnp.where(sign, -ctx, ctx)
            fi = lane_base + plane_base + ctx
            row = S[fi]                                # (L, 32) gather

            # per-pixel byte window: ONE gather, <= WIN in-window refills
            win = jnp.take_along_axis(
                bufs_i32,
                jnp.minimum(pos[:, None] + iotaWv[None, :], cap - 1),
                axis=1)
            win = jnp.where(pos[:, None] + iotaWv[None, :] < cap,
                            win, 0)
            woff = jnp.zeros((L,), jnp.int32)

            # --- get_symbol (signed), masked fixed slots ---
            ones = jnp.ones((L,), bool)
            b0, row, low, rng, pos, woff = rac(
                row, 0, None, win, woff, low, rng, pos, ones)
            nz = ~b0
            e = jnp.zeros((L,), jnp.int32)
            done = b0
            for j in range(e_max + 1):   # exponent unary chain + stop
                # row 1+min(j,9): the FFMIN cap (ffv1dec.c:53) — above
                # 10 bits row 10 repeats; the carried row makes the
                # repeated transitions sequentially exact
                bit, row, low, rng, pos, woff = rac(
                    row, 1 + min(j, 9), None, win, woff, low, rng, pos,
                    ~done)
                e = e + (bit & ~done).astype(jnp.int32)
                done = done | ~bit
            a = jnp.ones((L,), jnp.int32)
            for j in range(e_max):       # mantissa MSB -> LSB
                act = nz & (j < e)
                i = jnp.clip(e - 1 - j, 0, 9)
                bit, row, low, rng, pos, woff = rac(
                    row, None, 22 + i, win, woff, low, rng, pos, act)
                a = jnp.where(act, a + a + bit.astype(jnp.int32), a)
            sbit, row, low, rng, pos, woff = rac(
                row, None, 11 + jnp.minimum(e, 10), win, woff, low, rng,
                pos, nz)

            S = S.at[fi].set(row)
            diff = jnp.where(nz, jnp.where(sbit, -a, a), 0)
            diff = jnp.where(sign, -diff, diff)

            m = Lv + T - LT
            pred = (Lv + m + T) - jnp.minimum(jnp.minimum(Lv, m), T) \
                - jnp.maximum(jnp.maximum(Lv, m), T)
            val = (pred + diff) & mask_v
            if bits == 16:
                # int16_t sample-row storage wrap (ffv1dec.c: the ring
                # rows are int16_t, so 16-bit samples go NEGATIVE and
                # the median predictor compares them signed)
                val = ((val + 0x8000) & 0xFFFF) - 0x8000
            cur = cur.at[:, x].set(val)
            return (cur, prev, cl, plft, S, low, rng, pos), val
        return pixel

    def decode_plane(S, low, rng, pos, w, h, plane_base):
        pixel = make_pixel(w, plane_base)

        def row_step(carry, y):
            rowA, rowB, S, low, rng, pos = carry
            parity = (y % 2) == 0
            cur = jnp.where(parity, rowA, rowB)
            prev = jnp.where(parity, rowB, rowA)
            # FFV1 border (ffv1dec.c:202-203): cur[-1] = prev row's
            # first sample; prev[-1] = two-rows-ago first sample, which
            # is the STALE cur[0] of the 2-row ring (zero for y < 2)
            cl = prev[:, 0]
            plft = cur[:, 0]
            (cur, prev, cl, plft, S, low, rng, pos), _ = jax.lax.scan(
                pixel, (cur, prev, cl, plft, S, low, rng, pos),
                jnp.arange(w))
            rowA = jnp.where(parity, cur, rowA)
            rowB = jnp.where(parity, rowB, cur)
            return (rowA, rowB, S, low, rng, pos), cur

        init = (jnp.zeros((L, w), jnp.int32), jnp.zeros((L, w), jnp.int32),
                S, low, rng, pos)
        (_, _, S, low, rng, pos), rows = jax.lax.scan(
            row_step, init, jnp.arange(h))
        plane = jnp.moveaxis(rows, 0, 1)          # (L, h, w)
        return plane, S, low, rng, pos

    return S0, make_pixel, decode_plane


@functools.partial(jax.jit,
                   static_argnames=("plane_specs", "bits", "five_input"))
def rc_decode_planes_lanes(bufs, states, one_tab, zero_tab, qt,
                           low0, range0, pos0,
                           plane_specs: tuple, bits: int,
                           five_input: bool):
    """Decode all planes of L parallel slice streams.

    Args:
      bufs: uint8[L, cap] per-lane slice byte buffers (padded)
      states: uint8[L, CC_total, 32] adaptive states
      qt: int32[5, 256] quant table (all lanes share one table)
      low0, range0, pos0: int32[L] coder state after the host-parsed
        slice headers
      plane_specs: static tuple of (w, h, plane_base) in coding order
        with plane_base = state_plane_index * cc, e.g.
        ((sw, sh, 0), (cw, ch, cc), (cw, ch, cc)) for yuv
      bits: static bit depth (<= 10)
    Returns:
      (planes: tuple of int32[L, h, w] in spec order, states_out,
       low[L], range[L], pos[L])
    """
    L, CC = states.shape[0], states.shape[1]
    S0, _make_pixel, decode_plane = _machinery(
        bufs, states, one_tab, qt, bits, five_input)
    planes = []
    S, low, rng, pos = S0, low0, range0, pos0
    for (w, h, pbase) in plane_specs:
        pl_out, S, low, rng, pos = decode_plane(
            S, low, rng, pos, w, h, jnp.int32(pbase))
        planes.append(pl_out)
    states_out = S.astype(jnp.uint8).reshape(L, CC, 32)
    return tuple(planes), states_out, low, rng, pos


@functools.partial(jax.jit,
                   static_argnames=("w", "h", "nplanes", "cc", "bits",
                                    "five_input"))
def rc_decode_rgb_lanes(bufs, states, one_tab, zero_tab, qt,
                        low0, range0, pos0, w: int, h: int,
                        nplanes: int, cc: int, bits: int,
                        five_input: bool):
    """Line-interleaved RGB decode (ffv1dec.c:226-255): for each row y
    the planes g, b, r[, a] decode one line each from the SAME rac
    stream, with state plane_index (p + 1)/2 (g:0, b/r:1, a:2) and a
    2-row ring per plane — the TT read of the 5-input context model is
    the STALE cur[x] exactly as in decode_line's
    ``get_context(p, cur + x, last + x, cur + x)`` (ffv1dec.c:126).

    ``bits`` is the CODED width: 9 for <=8-bit RGB, source_bits + 1
    otherwise (ffv1dec.c:252-255).  Returns samples still in the RCT
    domain (offset applied, no inverse transform) as int32[P, L, h, w],
    plus (states_out, low, rng, pos).
    """
    L, CC = states.shape[0], states.shape[1]
    S0, make_pixel, _decode_plane = _machinery(
        bufs, states, one_tab, qt, bits, five_input)
    pixels = [make_pixel(w, jnp.int32(((p + 1) // 2) * cc))
              for p in range(nplanes)]

    def row_step(carry, y):
        ringsA, ringsB, S, low, rng, pos = carry   # (P, L, w) rings
        parity = (y % 2) == 0
        outs = []
        for p in range(nplanes):
            cur = jnp.where(parity, ringsA[p], ringsB[p])
            prev = jnp.where(parity, ringsB[p], ringsA[p])
            cl = prev[:, 0]
            plft = cur[:, 0]
            (cur, prev, cl, plft, S, low, rng, pos), _ = jax.lax.scan(
                pixels[p], (cur, prev, cl, plft, S, low, rng, pos),
                jnp.arange(w))
            ringsA = ringsA.at[p].set(jnp.where(parity, cur, ringsA[p]))
            ringsB = ringsB.at[p].set(jnp.where(parity, ringsB[p], cur))
            outs.append(cur)
        return (ringsA, ringsB, S, low, rng, pos), jnp.stack(outs)

    init = (jnp.zeros((nplanes, L, w), jnp.int32),
            jnp.zeros((nplanes, L, w), jnp.int32),
            S0, low0, range0, pos0)
    (_, _, S, low, rng, pos), rows = jax.lax.scan(
        row_step, init, jnp.arange(h))
    planes = jnp.moveaxis(rows, 0, 2)             # (P, L, h, w)
    states_out = S.astype(jnp.uint8).reshape(L, CC, 32)
    return planes, states_out, low, rng, pos
