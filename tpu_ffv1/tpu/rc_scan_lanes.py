"""Lane-major device range coding: many slices/streams per scan step.

The XLA encode scan (the CPU path, and the CUDA kernel's reference).
One lax.scan over pixel index; every carried quantity is vectorized over
L lanes (slice x stream batch), so the low/range chain is pure
(L,)-vector arithmetic with static indexing.

Structure per step (see rc_scan_fast.py for the derivation):
  1. flat gather of each lane's 32-byte context row
  2. closed-form per-position activity/bit masks (L, 32)
  3. vectorized state adaptation + flat scatter back
  4. static-order low/range/renorm chain (25 slots for 8-bit), emitting
     provisional bytes (carry flag in bit 16, see core.rac.prov_value)

Lanes may have different stream lengths: padding lanes carry
active=False and are exact no-ops.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .rc_scan_fast import chain_order


@functools.partial(jax.jit, static_argnames=("bits",))
def rc_encode_scan_lanes(ctx, diff, active, states0, one_tab, zero_tab,
                         low0, range0, bits: int):
    """Encode L parallel streams.

    Args:
      ctx, diff: int32[L, N] per-lane context/residual streams
      active: bool[L, N] validity (False lanes are no-ops)
      states0: uint8[L, CC, 32] adaptive states (carried across frames)
      low0, range0: int32[L] coder state after the host-coded prefix
    Returns:
      (prov int32[N, L, S], valid bool[N, L, S], low[L], range[L],
       states_out uint8[L, CC, 32])
    """
    order = chain_order(bits)
    L, CC = states0.shape[0], states0.shape[1]
    # state transitions via a one-hot (L,32,256)x(256,2) int8
    # contraction instead of vector gathers T[row]
    t_both = jnp.stack([zero_tab.astype(jnp.int8),
                        one_tab.astype(jnp.int8)], axis=1)  # (256, 2)
    iota256 = jnp.arange(256, dtype=jnp.int32)
    pos32 = jnp.arange(32, dtype=jnp.int32)[None, :]
    lane_base = jnp.arange(L, dtype=jnp.int32) * CC

    S0 = states0.reshape(L * CC, 32).astype(jnp.int32)

    def step(carry, xs):
        states, low, rng = carry
        c, v, act = xs                       # (L,)
        fi = lane_base + c
        row = states[fi]                     # (L, 32) gather
        a = jnp.abs(v)
        e = 31 - jax.lax.clz(jnp.maximum(a, 1).astype(jnp.uint32)) \
            .astype(jnp.int32)
        nz = v != 0

        eL = e[:, None]
        is_exp = (pos32 >= 1) & (pos32 <= 10)
        is_man = pos32 >= 22
        nzL = nz[:, None]
        act32 = ((pos32 == 0) |
                 (is_exp & nzL & (pos32 - 1 <= eL)) |
                 ((pos32 >= 11) & (pos32 <= 21) & nzL &
                  (pos32 == 11 + eL)) |
                 (is_man & nzL & (pos32 - 22 < eL))) & act[:, None]
        bit32 = jnp.where(
            pos32 == 0, (~nzL).astype(jnp.int32),
            jnp.where(is_exp, (pos32 - 1 < eL).astype(jnp.int32),
                      jnp.where(is_man,
                                (a[:, None] >> jnp.clip(pos32 - 22, 0, 30))
                                & 1,
                                (v[:, None] < 0).astype(jnp.int32))))

        onehot = (row[..., None] == iota256).astype(jnp.int8)
        t01 = jax.lax.dot_general(
            onehot, t_both, (((2,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)        # (L, 32, 2)
        # uint8 semantics: table value 0 stays 0 (t01 exact, values<256)
        new_row = jnp.where(act32,
                            jnp.where(bit32 == 1, t01[..., 1],
                                      t01[..., 0]) & 0xFF,
                            row)
        states = states.at[fi].set(new_row)

        out_b = []
        out_v = []
        for p in order:
            aj = act32[:, p]
            s = row[:, p]
            b = bit32[:, p]
            r1 = (rng * s) >> 8
            nr = jnp.where(b == 1, r1, rng - r1)
            nl = low + jnp.where(b == 1, rng - r1, 0)
            emit = aj & (nr < 0x100)
            out_b.append((nl >> 8) |
                         jnp.where((nl & 0xFF) != 0, 1 << 16, 0))
            out_v.append(emit)
            nl = jnp.where(emit, (nl & 0xFF) << 8, nl)
            nr = jnp.where(emit, nr << 8, nr)
            low = jnp.where(aj, nl, low)
            rng = jnp.where(aj, nr, rng)
        return (states, low, rng), (jnp.stack(out_b, 1),
                                    jnp.stack(out_v, 1))

    (states, low, rng), (prov, valid) = jax.lax.scan(
        step, (S0, low0, range0), (ctx.T, diff.T, active.T))
    states_out = states.astype(jnp.uint8).reshape(L, CC, 32)
    return prov, valid, low, rng, states_out


@functools.partial(jax.jit, static_argnames=("bits", "unroll"))
def rc_encode_scan_lanes_unrolled(ctx, diff, active, states0, one_tab,
                                  zero_tab, low0, range0, bits: int,
                                  unroll: int = 8):
    """Unrolled lane-major scan: U pixels per step, one batched state
    gather and one last-wins scatter per step.

    Intra-step same-context dependencies are resolved with a
    where-cascade (pixel k's row inherits the latest update among earlier
    pixels with the same ctx), and duplicate rows in the final scatter
    are dropped except the last occurrence, preserving exact sequential
    semantics.

    The CPU path's encode scan (with U = 2); on the GPU the CUDA
    kernel replaces it.

    Requires N % unroll == 0 (pad with active=False lanes).
    Returns prov/valid shaped (N, L, S) in pixel order, same as
    rc_encode_scan_lanes.
    """
    order = chain_order(bits)
    L, CC = states0.shape[0], states0.shape[1]
    U = unroll
    N = ctx.shape[1]
    assert N % U == 0
    t_both = jnp.stack([zero_tab.astype(jnp.int8),
                        one_tab.astype(jnp.int8)], axis=1)  # (256, 2)
    iota256 = jnp.arange(256, dtype=jnp.int32)
    pos32 = jnp.arange(32, dtype=jnp.int32)[None, :]
    lane_base = jnp.arange(L, dtype=jnp.int32) * CC

    S0 = states0.reshape(L * CC, 32).astype(jnp.int32)
    steps = N // U
    ctxS = ctx.T.reshape(steps, U, L)
    diffS = diff.T.reshape(steps, U, L)
    actS = active.T.reshape(steps, U, L)

    def pixel_masks(v, a_px):
        a = jnp.abs(v)
        e = 31 - jax.lax.clz(jnp.maximum(a, 1).astype(jnp.uint32)) \
            .astype(jnp.int32)
        nz = v != 0
        eL = e[:, None]
        nzL = nz[:, None]
        is_exp = (pos32 >= 1) & (pos32 <= 10)
        is_man = pos32 >= 22
        act32 = ((pos32 == 0) |
                 (is_exp & nzL & (pos32 - 1 <= eL)) |
                 ((pos32 >= 11) & (pos32 <= 21) & nzL &
                  (pos32 == 11 + eL)) |
                 (is_man & nzL & (pos32 - 22 < eL))) & a_px[:, None]
        bit32 = jnp.where(
            pos32 == 0, (~nzL).astype(jnp.int32),
            jnp.where(is_exp, (pos32 - 1 < eL).astype(jnp.int32),
                      jnp.where(is_man,
                                (a[:, None] >> jnp.clip(pos32 - 22, 0, 30))
                                & 1,
                                (v[:, None] < 0).astype(jnp.int32))))
        return act32, bit32

    def step(carry, xs):
        states, low, rng = carry
        cU, vU, aU = xs                       # (U, L)
        fiU = lane_base[None, :] + cU         # (U, L)
        rowsG = states[fiU.reshape(-1)].reshape(U, L, 32)  # one gather

        new_rows = []
        out_b = []
        out_v = []
        for k in range(U):
            row = rowsG[k]
            for j in range(k):  # latest same-ctx update wins
                m = (cU[j] == cU[k])[:, None]
                row = jnp.where(m, new_rows[j], row)
            act32, bit32 = pixel_masks(vU[k], aU[k])
            onehot = (row[..., None] == iota256).astype(jnp.int8)
            t01 = jax.lax.dot_general(
                onehot, t_both, (((2,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            new_rows.append(jnp.where(
                act32,
                jnp.where(bit32 == 1, t01[..., 1], t01[..., 0]) & 0xFF,
                row))
            for p in order:
                aj = act32[:, p]
                s = row[:, p]
                b = bit32[:, p]
                r1 = (rng * s) >> 8
                nr = jnp.where(b == 1, r1, rng - r1)
                nl = low + jnp.where(b == 1, rng - r1, 0)
                emit = aj & (nr < 0x100)
                out_b.append((nl >> 8) |
                             jnp.where((nl & 0xFF) != 0, 1 << 16, 0))
                out_v.append(emit)
                nl = jnp.where(emit, (nl & 0xFF) << 8, nl)
                nr = jnp.where(emit, nr << 8, nr)
                low = jnp.where(aj, nl, low)
                rng = jnp.where(aj, nr, rng)

        # last-wins combined scatter
        fi_w = []
        for k in range(U):
            dup = jnp.zeros((L,), bool)
            for j in range(k + 1, U):
                dup = dup | (cU[j] == cU[k])
            fi_w.append(jnp.where(dup, L * CC, fiU[k]))
        states = states.at[jnp.stack(fi_w).reshape(-1)].set(
            jnp.stack(new_rows).reshape(U * L, 32), mode="drop")

        ys = (jnp.stack(out_b, 0).reshape(U, len(order), L),
              jnp.stack(out_v, 0).reshape(U, len(order), L))
        return (states, low, rng), ys

    (states, low, rng), (prov, valid) = jax.lax.scan(
        step, (S0, low0, range0), (ctxS, diffS, actS))
    # (steps, U, S, L) -> (N, L, S)
    prov = jnp.moveaxis(prov.reshape(N, len(order), L), 2, 1)
    valid = jnp.moveaxis(valid.reshape(N, len(order), L), 2, 1)
    states_out = states.astype(jnp.uint8).reshape(L, CC, 32)
    return prov, valid, low, rng, states_out


@jax.jit
def finalize_lanes(prov, valid, low, rng, prefix, prefix_len):
    """Vectorized sentinel/terminate/compact/carry-resolve over lanes.

    prov: int32[N, L, S]; valid: bool[N, L, S]; prefix: int32[L, PCAP];
    prefix_len: int32[L].  Returns (bytes uint8[L, CAP], count int32[L]).

    Compaction is sort-based (a stable key sort; scatter with giant 2D
    index arrays stalls the compiler) and the carry
    suffix recurrence c_k = g_k | (p_k & c_{k+1}) is evaluated with a
    native cummax over propagate-run segments instead of a custom
    associative_scan (see core.rac.carry_resolve for semantics).
    """
    N, L, S = prov.shape
    pcap = prefix.shape[1]

    def _pv(lw):
        return (lw >> 8) | jnp.where((lw & 0xFF) != 0, 1 << 16, 0)

    r1 = (rng * 129) >> 8
    rng2 = rng - r1
    s_emit = rng2 < 0x100
    pv0 = _pv(low)
    low2 = jnp.where(s_emit, (low & 0xFF) << 8, low)
    t1 = _pv(low2 + 0xFF)
    t2 = (low2 + 0xFF) & 0xFF

    flat_b = jnp.moveaxis(prov, 1, 0).reshape(L, N * S)
    flat_v = jnp.moveaxis(valid, 1, 0).reshape(L, N * S)
    M = N * S
    big = M + pcap + 8

    # keys: prefix values sort to [0, plen); data to [plen, plen+count)
    pkey = jnp.where(jnp.arange(pcap)[None, :] < prefix_len[:, None],
                     jnp.arange(pcap)[None, :].astype(jnp.int32), big)
    dkey = jnp.where(flat_v,
                     prefix_len[:, None] + jnp.cumsum(flat_v, axis=1) - 1,
                     big)
    keys = jnp.concatenate([pkey, dkey], axis=1)
    vals_in = jnp.concatenate([prefix, flat_b], axis=1)
    _, stream = jax.lax.sort((keys, vals_in), dimension=1, num_keys=1)

    cap = M + pcap + 3
    stream = jnp.pad(stream, ((0, 0), (0, 3)))  # room for sentinel+term
    count = prefix_len + jnp.sum(flat_v, axis=1)
    li = jnp.arange(L)
    stream = stream.at[li, count].set(jnp.where(s_emit, pv0, t1))
    stream = stream.at[li, count + 1].set(jnp.where(s_emit, t1, t2))
    stream = stream.at[li, count + 2].set(jnp.where(s_emit, t2, 0))
    total = count + 2 + s_emit.astype(jnp.int32)

    in_range = jnp.arange(cap)[None, :] < total[:, None]
    vals = jnp.where(in_range, stream, 0)
    g = ((vals >> 8) & 1).astype(jnp.int32)
    p = (((vals & 0x1FF) == 0xFF) & ((vals >> 16) == 1) & in_range) \
        .astype(jnp.int32)

    # suffix recurrence via cummax on the reversed stream: within a run of
    # propagators, carry_out = any generator in the run's suffix prefix
    gr = g[:, ::-1]
    pr = p[:, ::-1]
    brk = jnp.cumsum(1 - pr, axis=1)  # run id, breaks at non-propagators
    # allow g at the break element itself to start a carry into the run
    m = jax.lax.cummax(gr + 2 * brk, axis=1)
    carry_out_rev = (m - 2 * brk) >= 1
    carry_out = carry_out_rev[:, ::-1].astype(jnp.int32)
    carry_in = jnp.concatenate(
        [carry_out[:, 1:], jnp.zeros((L, 1), jnp.int32)], axis=1)
    resolved = ((vals & 0x1FF) + carry_in) & 0xFF
    out = jnp.where(in_range, resolved, 0).astype(jnp.uint8)
    return out, total - 1


def _resolve_compact(flat_b, flat_v, low, rng, prefix, prefix_len):
    """Resolve-then-compact finalize: carry resolution runs over the
    UNCOMPACTED slot stream (invalid slots are neutral carry
    propagators: g=0, p=1, so a carry passes through them unchanged),
    after which compaction only has to move resolved uint8 bytes.  The
    key and byte share one int32 word, so the sort is a single-operand
    lax.sort instead of the 3-operand variadic sort finalize_lanes
    needs — ~3x less data through the sort network, and no separate
    pre-compaction pass.

    flat_b: int32[L, M] provisional values (prov_value format, bits
    0..16); flat_v: bool[L, M] slot validity, in stream order per lane.
    """
    L, M = flat_b.shape
    pcap = prefix.shape[1]

    def _pv(lw):
        return (lw >> 8) | jnp.where((lw & 0xFF) != 0, 1 << 16, 0)

    # sentinel + terminate bytes (ffv1enc.c encode_slice tail: one
    # range-coded 0 then ff_rac_terminate), appended after the data
    r1 = (rng * 129) >> 8
    rng2 = rng - r1
    s_emit = rng2 < 0x100
    pv0 = _pv(low)
    low2 = jnp.where(s_emit, (low & 0xFF) << 8, low)
    t1 = _pv(low2 + 0xFF)
    t2 = (low2 + 0xFF) & 0xFF
    ones = jnp.ones((L,), bool)
    tail_b = jnp.stack([jnp.where(s_emit, pv0, t1),
                        jnp.where(s_emit, t1, t2),
                        jnp.where(s_emit, t2, 0)], axis=1)   # (L, 3)
    tail_v = jnp.stack([ones, ones, s_emit], axis=1)

    pvld = jnp.arange(pcap, dtype=jnp.int32)[None, :] < prefix_len[:, None]
    vals = jnp.concatenate([prefix, flat_b, tail_b], axis=1)  # (L, T)
    vld = jnp.concatenate([pvld, flat_v, tail_v], axis=1)
    T = vals.shape[1]

    g = ((vals >> 8) & 1) * vld.astype(jnp.int32)
    p = jnp.where(vld,
                  ((vals & 0x1FF) == 0xFF) & ((vals >> 16) == 1),
                  True).astype(jnp.int32)
    gr = g[:, ::-1]
    pr = p[:, ::-1]
    brk = jnp.cumsum(1 - pr, axis=1)
    m = jax.lax.cummax(gr + 2 * brk, axis=1)
    carry_out = ((m - 2 * brk) >= 1)[:, ::-1].astype(jnp.int32)
    carry_in = jnp.concatenate(
        [carry_out[:, 1:], jnp.zeros((L, 1), jnp.int32)], axis=1)
    resolved = ((vals & 0x1FF) + carry_in) & 0xFF

    rank = jnp.cumsum(vld.astype(jnp.int32), axis=1) - 1
    key = jnp.where(vld, rank, T) * 256 + resolved
    skey = jax.lax.sort(key, dimension=1)
    out = (skey & 0xFF).astype(jnp.uint8)
    total = prefix_len + jnp.sum(flat_v, axis=1) + 2 + s_emit
    return out, total - 1


@jax.jit
def finalize_lanes_resolve(prov, valid, low, rng, prefix, prefix_len):
    """finalize_lanes-compatible entry ((N, L, S) unpacked inputs)
    routed through the resolve-then-compact path."""
    N, L, S = prov.shape
    flat_b = jnp.moveaxis(prov, 1, 0).reshape(L, N * S)
    flat_v = jnp.moveaxis(valid, 1, 0).reshape(L, N * S)
    return _resolve_compact(flat_b, flat_v, low, rng, prefix, prefix_len)


@functools.partial(jax.jit, static_argnames=("s2",))
def finalize_packed(packed, low, rng, prefix, prefix_len, s2: int = 4):
    """Finalize from the packed lane-scan output.

    packed: int32[N, S, L] with bit 20 = emit flag and bits 0..16 the
    provisional value.  Per-pixel slot compaction to S2 slots is done
    with masked reductions (fused by XLA into one pass over the array)
    instead of a sort; returns (bytes uint8[L, T], count int32[L],
    overflow bool[L]) — on a lane's overflow (a pixel emitted > S2
    bytes, <1e-4 of pixels) the caller must take the full-width path.
    Overflow is per-lane so the whole finalize shards over a device
    mesh with no collective (tpu/sharding.py).  ``s2`` is 4 for coded
    widths <= 10 bits; deeper content uses 6 (more bytes per pixel).
    """
    S2 = s2
    N, S, L = packed.shape
    valid = (packed >> 20) & 1
    pv = packed & 0x1FFFF
    cnt_inc = jnp.cumsum(valid, axis=1)
    cnt_exc = cnt_inc - valid
    total_pix = cnt_inc[:, -1, :]                         # (N, L)
    overflow = jnp.max(total_pix, axis=0) > S2            # (L,)
    slots = jnp.stack(
        [jnp.sum(pv * valid * (cnt_exc == k), axis=1) for k in range(S2)],
        axis=1)                                           # (N, S2, L)
    vld = (jnp.arange(S2, dtype=jnp.int32)[None, :, None]
           < total_pix[:, None, :])

    # second compaction level: 16-pixel groups -> 24 slots (1.5/px vs
    # the per-pixel level's 4/px).  The dominant finalize cost is the
    # sort network over the slot stream (O(T log^2 T) byte moves), so
    # shrinking T 2.7x pays for the extra masked reductions several
    # times over (measured: finalize 152 ms at 4/px slots, batch 4
    # 1080p).  Typical content emits ~1.05 B/px, so a 24-byte cap per
    # 16 px overflows only on near-noise content — the existing
    # full-width fallback path handles those frames.
    G, C = 16, 24
    if s2 == 4 and N % G == 0:
        gs = slots.reshape(N // G, G * S2, L)
        gv = vld.reshape(N // G, G * S2, L).astype(jnp.int32)
        ginc = jnp.cumsum(gv, axis=1)
        gexc = ginc - gv
        gcount = ginc[:, -1, :]                           # (N/G, L)
        overflow = overflow | (jnp.max(gcount, axis=0) > C)
        slots = jnp.stack(
            [jnp.sum(gs * gv * (gexc == k), axis=1) for k in range(C)],
            axis=1)                                       # (N/G, C, L)
        vld = (jnp.arange(C, dtype=jnp.int32)[None, :, None]
               < gcount[:, None, :])
        M = (N // G) * C
    else:
        M = N * S2
    flat_b = jnp.transpose(slots, (2, 0, 1)).reshape(L, M)
    flat_v = jnp.transpose(vld, (2, 0, 1)).reshape(L, M)
    out, count = _resolve_compact(flat_b, flat_v, low, rng,
                                  prefix, prefix_len)
    return out, count, overflow


@jax.jit
def finalize_packed_full(packed, low, rng, prefix, prefix_len):
    """Full-width (no per-pixel compaction) fallback for finalize_packed
    overflow: feeds all S slots straight into the resolve+compact."""
    N, S, L = packed.shape
    flat_b = jnp.transpose(packed & 0x1FFFF, (2, 0, 1)).reshape(L, N * S)
    flat_v = jnp.transpose((packed >> 20) & 1,
                           (2, 0, 1)).reshape(L, N * S).astype(bool)
    return _resolve_compact(flat_b, flat_v, low, rng, prefix, prefix_len)


@functools.partial(jax.jit, static_argnames=("bits",))
def rc_encode_scan_lanes_ext(ctx, diff, active, states0, one_tab,
                             zero_tab, low0, range0, bits: int):
    """Lane-major scan for coded widths 11..17 bits.

    put_symbol's FFMIN row caps give rows 10 and 31 SEVERAL decisions
    per pixel at these widths (ffv1enc.c:185-231), so those rows carry
    running states with sequential transitions; all other rows keep the
    one-shot vectorized adaptation.  Same contract/outputs as
    rc_encode_scan_lanes (S = 2*bits + 1 slots).
    """
    from .rc_scan_fast import ext_slots
    slots = ext_slots(bits)
    L, CC = states0.shape[0], states0.shape[1]
    one_i = one_tab.astype(jnp.int32)
    zero_i = zero_tab.astype(jnp.int32)
    lane_base = jnp.arange(L, dtype=jnp.int32) * CC
    lanes = jnp.arange(L)

    S0 = states0.reshape(L * CC, 32).astype(jnp.int32)

    def step(carry, xs):
        states, low, rng = carry
        c, v, act_px = xs                    # (L,)
        fi = lane_base + c
        row = states[fi]                     # (L, 32)
        a = jnp.abs(v)
        e = 31 - jax.lax.clz(jnp.maximum(a, 1).astype(jnp.uint32)) \
            .astype(jnp.int32)
        nz = v != 0
        sign_col = 11 + jnp.minimum(e, 10)

        s10 = row[:, 10]
        s31 = row[:, 31]
        new_row = row

        out_b = []
        out_v = []
        low_c, rng_c = low, rng

        def trans(s, b):
            return jnp.where(b == 1, one_i[s], zero_i[s])

        for sl in slots:
            kind = sl[0]
            if kind == "zero":
                act = act_px
                bit = (~nz).astype(jnp.int32)
                s = row[:, 0]
            elif kind == "exp":
                j = sl[1]
                act = act_px & nz & (j <= e)
                bit = (j < e).astype(jnp.int32)
                s = row[:, 1 + j] if j <= 8 else s10
            elif kind == "man31":
                r = sl[1]
                act = act_px & nz & (e >= 10 + r)
                bit = (a >> jnp.clip(e - 1 - r, 0, 31)) & 1
                s = s31
            elif kind == "man":
                i = sl[1]
                act = act_px & nz & (i < e)
                bit = (a >> i) & 1
                s = row[:, 22 + i]
            else:  # sign
                act = act_px & nz
                bit = (v < 0).astype(jnp.int32)
                s = jnp.take_along_axis(new_row, sign_col[:, None],
                                        axis=1)[:, 0]

            r1 = (rng_c * s) >> 8
            nr = jnp.where(bit == 1, r1, rng_c - r1)
            nl = low_c + jnp.where(bit == 1, rng_c - r1, 0)
            emit = act & (nr < 0x100)
            out_b.append((nl >> 8) |
                         jnp.where((nl & 0xFF) != 0, 1 << 16, 0))
            out_v.append(emit)
            nl = jnp.where(emit, (nl & 0xFF) << 8, nl)
            nr = jnp.where(emit, nr << 8, nr)
            low_c = jnp.where(act, nl, low_c)
            rng_c = jnp.where(act, nr, rng_c)

            ns = trans(s, bit)
            if kind == "exp" and sl[1] >= 9:
                s10 = jnp.where(act, ns, s10)
            elif kind == "man31":
                s31 = jnp.where(act, ns, s31)
            elif kind == "exp":
                new_row = new_row.at[:, 1 + sl[1]].set(
                    jnp.where(act, ns, new_row[:, 1 + sl[1]]))
            elif kind == "man":
                new_row = new_row.at[:, 22 + sl[1]].set(
                    jnp.where(act, ns, new_row[:, 22 + sl[1]]))
            elif kind == "zero":
                new_row = new_row.at[:, 0].set(
                    jnp.where(act, ns, new_row[:, 0]))
            else:  # sign: dynamic column scatter
                cur = jnp.take_along_axis(new_row, sign_col[:, None],
                                          axis=1)[:, 0]
                new_row = new_row.at[lanes, sign_col].set(
                    jnp.where(act, ns, cur))
        new_row = new_row.at[:, 10].set(s10)
        new_row = new_row.at[:, 31].set(s31)
        states = states.at[fi].set(new_row)
        return (states, low_c, rng_c), (jnp.stack(out_b, 1),
                                        jnp.stack(out_v, 1))

    (states, low, rng), (prov, valid) = jax.lax.scan(
        step, (S0, low0, range0), (ctx.T, diff.T, active.T))
    states_out = states.astype(jnp.uint8).reshape(L, CC, 32)
    return prov, valid, low, rng, states_out


@functools.partial(jax.jit, static_argnames=("s2",))
def finalize_packed_hostcompact(packed, low, rng, prefix, prefix_len,
                                s2: int = 4):
    """Finalize WITHOUT the device sort: per-pixel + 16-px-group
    compaction and carry resolution run on device, but the final
    variable-length concatenation happens on the HOST (a ~10 ms C
    segment-copy, tpu_ffv1.native.compact_groups, fully overlapped
    with the next frame's device compute) instead of an O(T log^2 T)
    sort network (~60 ms of the batch-4 1080p dispatch).

    Returns (slab uint8[L, 5 + NG + pcap + NG*C + 3], counts, overflow)
    where the slab rows are [count:4 LE | overflow:1 | group counts:NG |
    resolved prefix bytes:pcap | resolved group slots:NG*C | resolved
    tail:3].  Valid bytes per segment: prefix_len, per-group counts,
    and 2 + s_emit for the tail (s_emit rides the overflow byte's bit
    1).
    """
    G, C = 16, 24
    S2 = s2
    N, S, L = packed.shape
    assert N % G == 0
    valid = (packed >> 20) & 1
    pv = packed & 0x1FFFF
    cnt_inc = jnp.cumsum(valid, axis=1)
    cnt_exc = cnt_inc - valid
    total_pix = cnt_inc[:, -1, :]
    overflow = jnp.max(total_pix, axis=0) > S2
    slots = jnp.stack(
        [jnp.sum(pv * valid * (cnt_exc == k), axis=1) for k in range(S2)],
        axis=1)
    vld = (jnp.arange(S2, dtype=jnp.int32)[None, :, None]
           < total_pix[:, None, :])
    gcount, overflow, flat_b, flat_v = _group_compact(
        slots, vld, overflow, G, C)
    return _hostcompact_slab(flat_b, flat_v, gcount, overflow, low,
                             rng, prefix, prefix_len)


def _group_compact(slots, vld, overflow, G: int, C: int):
    """Second compaction level: (N, S2, L) per-pixel slots -> (NG, C, L)
    16-pixel-group slots + per-group counts."""
    N, S2, L = slots.shape
    gs = slots.reshape(N // G, G * S2, L)
    gv = vld.reshape(N // G, G * S2, L).astype(jnp.int32)
    ginc = jnp.cumsum(gv, axis=1)
    gexc = ginc - gv
    gcount = ginc[:, -1, :]                               # (NG, L)
    overflow = overflow | (jnp.max(gcount, axis=0) > C)
    gslots = jnp.stack(
        [jnp.sum(gs * gv * (gexc == k), axis=1) for k in range(C)],
        axis=1)                                           # (NG, C, L)
    gvld = (jnp.arange(C, dtype=jnp.int32)[None, :, None]
            < gcount[:, None, :])
    NG = N // G
    flat_b = jnp.transpose(gslots, (2, 0, 1)).reshape(L, NG * C)
    flat_v = jnp.transpose(gvld, (2, 0, 1)).reshape(L, NG * C)
    return gcount, overflow, flat_b, flat_v


def _hostcompact_slab(flat_b, flat_v, gcount, overflow, low, rng,
                      prefix, prefix_len):
    """Carry-resolve [prefix | group slots | tail] and pack the
    hostcompact slab (see finalize_packed_hostcompact docstring)."""
    L = flat_b.shape[0]
    pcap = prefix.shape[1]

    def _pv(lw):
        return (lw >> 8) | jnp.where((lw & 0xFF) != 0, 1 << 16, 0)

    r1 = (rng * 129) >> 8
    rng2 = rng - r1
    s_emit = rng2 < 0x100
    pv0 = _pv(low)
    low2 = jnp.where(s_emit, (low & 0xFF) << 8, low)
    t1 = _pv(low2 + 0xFF)
    t2 = (low2 + 0xFF) & 0xFF
    ones = jnp.ones((L,), bool)
    tail_b = jnp.stack([jnp.where(s_emit, pv0, t1),
                        jnp.where(s_emit, t1, t2),
                        jnp.where(s_emit, t2, 0)], axis=1)
    tail_v = jnp.stack([ones, ones, s_emit], axis=1)

    pvld = jnp.arange(pcap, dtype=jnp.int32)[None, :] < prefix_len[:, None]
    vals = jnp.concatenate([prefix, flat_b, tail_b], axis=1)
    vld2 = jnp.concatenate([pvld, flat_v, tail_v], axis=1)
    g = ((vals >> 8) & 1) * vld2.astype(jnp.int32)
    pr_ = jnp.where(vld2,
                    ((vals & 0x1FF) == 0xFF) & ((vals >> 16) == 1),
                    True).astype(jnp.int32)
    gr = g[:, ::-1]
    pr = pr_[:, ::-1]
    brk = jnp.cumsum(1 - pr, axis=1)
    m = jax.lax.cummax(gr + 2 * brk, axis=1)
    carry_out = ((m - 2 * brk) >= 1)[:, ::-1].astype(jnp.int32)
    carry_in = jnp.concatenate(
        [carry_out[:, 1:], jnp.zeros((L, 1), jnp.int32)], axis=1)
    resolved = (((vals & 0x1FF) + carry_in) & 0xFF).astype(jnp.uint8)

    counts = prefix_len + jnp.sum(flat_v, axis=1) + 2 + s_emit
    counts = counts - 1        # the last provisional value never flushes
    head = jnp.stack(
        [(counts >> sh) & 0xFF for sh in (0, 8, 16, 24)] +
        [overflow.astype(jnp.int32) | (s_emit.astype(jnp.int32) << 1)],
        axis=1).astype(jnp.uint8)
    slab = jnp.concatenate(
        [head, gcount.T.astype(jnp.uint8), resolved], axis=1)
    return slab, counts, overflow
