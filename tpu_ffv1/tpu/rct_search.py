"""Device v4 per-slice RCT parameter search.

Behavioral parity: ffv1enc.c:1064-1144 (choose_rct_params) via the host
re-expression in codec/rct.py — identical candidate set, integer
arithmetic (including the int16 scratch-row wrap), and first-index
tie-break.

All-int32 on device: the per-candidate |cost| sums are accumulated
exactly with a chunked split scheme — per-pixel costs are < 2^19 (hbd)
so CHUNK-sized partial sums stay < 2^31, and the chunk sums are then
split into 16-bit hi/lo parts whose cross-chunk sums also stay in
int32.  The host recombines hi*2^16 + lo in int64 and argmins, so no
int64 lanes are needed (jax defaults to x64-off).  The 15 candidates are evaluated as unrolled reductions so
the (h, w) cost tensor is the only live intermediate per candidate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.rct import RCT_Y_COEFF

_CHUNK = 1024


def _hdiff(p):
    """Horizontal first differences; lastX starts at 0 each row, so the
    first column passes through raw (ffv1enc.c:1090-1100)."""
    return jnp.concatenate([p[:, :1], p[:, 1:] - p[:, :-1]], axis=1)


def _w16(v):
    """int16_t storage wrap of the previous row's first differences
    (the reference's int16_t *sample[3] scratch, ffv1enc.c:1087)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _exact_sum_pair(v):
    """Exact sum of a non-negative int32 tensor with per-element values
    < 2^20, returned as (hi, lo) int32 with total = hi * 2^16 + lo."""
    flat = v.reshape(-1)
    pad = (-flat.shape[0]) % _CHUNK
    flat = jnp.pad(flat, (0, pad))
    cs = flat.reshape(-1, _CHUNK).sum(axis=1)          # < 2^31 each
    return (cs >> 16).sum(), (cs & 0xFFFF).sum()


def rct_cost_pairs(b, g, r):
    """(h, w) int32 slice crops -> (15, 2) int32 [hi, lo] exact cost
    sums over the candidate table, in RCT_Y_COEFF order."""
    ab, ag, ar = _hdiff(b), _hdiff(g), _hdiff(r)
    bg = ag[1:, 1:] - _w16(ag[:-1, 1:])
    bb = ab[1:, 1:] - _w16(ab[:-1, 1:])
    br = ar[1:, 1:] - _w16(ar[:-1, 1:])
    br = br - bg
    bb = bb - bg
    pairs = []
    for ry, by in RCT_Y_COEFF:
        v = jnp.abs(bg + ((br * ry + bb * by) >> 2))
        hi, lo = _exact_sum_pair(v)
        pairs.append(jnp.stack([hi, lo]))
    return jnp.stack(pairs)


rct_cost_pairs_lanes = jax.vmap(rct_cost_pairs)


def pick_rct_coefs(pairs_np: np.ndarray):
    """(L, 15, 2) hi/lo sums -> list of (by, ry) per lane.  np.argmin
    returns the first minimal index — the reference's strict-< scan
    keeps the earliest candidate too (ffv1enc.c:1137-1140)."""
    tot = (pairs_np[..., 0].astype(np.int64) << 16) + pairs_np[..., 1]
    idx = np.argmin(tot, axis=1)
    return [(RCT_Y_COEFF[i][1], RCT_Y_COEFF[i][0]) for i in idx]
