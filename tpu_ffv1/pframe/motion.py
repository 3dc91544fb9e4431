"""Experimental block-motion P-frame extension (the fork's direction).

The reference tree carries the motion machinery FFV1's P-frame work
builds on — SAD block compare (me_cmp.c:996, me_cmp.h:56 sad[6]),
candidate-vector search (motion_est.c:904 ff_estimate_p_frame_motion,
:977 ff_epzs_motion_search) and OBMC prediction (snow.c:327
ff_snow_pred_block) — but does not wire it into the FFV1 bitstream
(SURVEY §0.3, §2.4).  This module is the device equivalent,
implemented as a *framework extension* gated behind experimental=True,
exactly as the reference gates its unfinished versions
(ffv1enc.c:703-706).

Device mapping (BASELINE.json north star): the SAD field over all
candidate vectors is evaluated as a dense batched reduction — candidate
shifts of the reference plane are materialized as a (C, H, W) stack, the
absolute difference against the current plane is block-pooled with a
reshape-sum, and argmin over C picks each block's vector.  All of it is
one fused XLA program; the residual then rides the standard FFV1 slice
pipeline at bits+1 width (same trick as the RGB planes,
ffv1enc.c:464-467).
"""
from __future__ import annotations

import numpy as np

try:
    import jax
    import jax.numpy as jnp
    _HAVE_JAX = True
except Exception:  # pragma: no cover
    _HAVE_JAX = False


def candidate_grid(radius: int):
    """All (dy, dx) candidate vectors within a square search window."""
    return [(dy, dx)
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]


def _shift2d(ref, dy, dx):
    """Shift with edge replication (motion across borders clamps)."""
    H, W = ref.shape
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return ref[ys][:, xs]


import functools


@functools.partial(jax.jit, static_argnames=("block", "radius")) \
    if _HAVE_JAX else (lambda f: f)
def block_motion_search(cur, ref, block: int = 16, radius: int = 7):
    """Full-search SAD block matching, one fused device program.

    Returns (mvs int32[bh, bw, 2], sad int32[bh, bw]) for the best
    candidate of each block.  cur/ref: (H, W) int arrays; H, W must be
    multiples of ``block`` (pad beforehand).
    """
    H, W = cur.shape
    bh, bw = H // block, W // block
    cands = candidate_grid(radius)
    cur = jnp.asarray(cur, jnp.int32)
    ref = jnp.asarray(ref, jnp.int32)

    def sad_for(dy, dx):
        diff = jnp.abs(cur - _shift2d(ref, dy, dx))
        return diff.reshape(bh, block, bw, block).sum(axis=(1, 3))

    sads = jnp.stack([sad_for(dy, dx) for dy, dx in cands])  # (C, bh, bw)
    best = jnp.argmin(sads, axis=0)                          # (bh, bw)
    cand_arr = jnp.asarray(np.array(cands, np.int32))
    mvs = cand_arr[best]                                     # (bh, bw, 2)
    return mvs, jnp.min(sads, axis=0)


@functools.partial(jax.jit, static_argnames=("block", "radius", "lam")) \
    if _HAVE_JAX else (lambda f: f)
def block_motion_search_cost(cur, ref, prev_mvs, block: int = 16,
                             radius: int = 7, lam: int = 16):
    """Rate-aware full-search SAD block matching.

    cost = SAD + lam * (|dy - pdy| + |dx - pdx|) where (pdy, pdx) is the
    previous frame's vector for the same block — the same predictor the
    MV deltas are entropy-coded against, so the penalty tracks actual
    rate (the ff_estimate_p_frame_motion mv_penalty idea,
    motion_est.c:904, without the serial EPZS candidate chain).
    Returns (mvs int32[bh, bw, 2], sad, cost).
    """
    H, W = cur.shape
    bh, bw = H // block, W // block
    cands = candidate_grid(radius)
    cur = jnp.asarray(cur, jnp.int32)
    ref = jnp.asarray(ref, jnp.int32)
    prev_mvs = jnp.asarray(prev_mvs, jnp.int32)

    def cost_for(dy, dx):
        diff = jnp.abs(cur - _shift2d(ref, dy, dx))
        sad = diff.reshape(bh, block, bw, block).sum(axis=(1, 3))
        pen = (jnp.abs(dy - prev_mvs[..., 0]) +
               jnp.abs(dx - prev_mvs[..., 1])) * lam
        return sad, sad + pen

    sads, costs = zip(*[cost_for(dy, dx) for dy, dx in cands])
    sads = jnp.stack(sads)                                   # (C, bh, bw)
    costs = jnp.stack(costs)
    best = jnp.argmin(costs, axis=0)
    cand_arr = jnp.asarray(np.array(cands, np.int32))
    mvs = cand_arr[best]
    take = lambda a: jnp.take_along_axis(a, best[None], 0)[0]  # noqa: E731
    return mvs, take(sads), take(costs)


@functools.partial(jax.jit, static_argnames=("block", "radius", "lam")) \
    if _HAVE_JAX else (lambda f: f)
def block_motion_search_epzs(cur, ref, prev_mvs, block: int = 16,
                             radius: int = 7, lam: int = 16):
    """Predictor-seeded two-stage search — EPZS's core idea
    (motion_est.c:977 ff_epzs_motion_search: try predictors first,
    refine locally) recast batched and vectorized with NO serial chain:

      stage 1: a coarse uniform grid over the window (spacing <= 4)
               PLUS per-block temporal predictors (the same block's and
               its 4 field neighbors' previous-frame vectors — the
               data-parallel stand-in for EPZS's coded left/top
               predictors, which would serialize blocks)
      stage 2: dense +-2 refinement around each block's stage-1 winner

    ~55 SAD evaluations per block vs 225 for the full search at
    radius 7; identical (mvs, sad, cost) contract and tie-breaking to
    block_motion_search_cost (argmin picks the first/lowest candidate
    index), so host and device encoders stay byte-identical in this
    mode too.  Per-block candidate vectors make each SAD a gather
    (motion_compensate's addressing) instead of a uniform shift.

    Like every pruned search (EPZS included), this descends the SAD
    surface and assumes the spatial autocorrelation of natural video;
    periodic content whose SAD aliases away from the true vector (e.g.
    a diagonal gradient, where every dy+dx=const candidate matches)
    can trap stage 1 in a local minimum the +-2 refinement cannot
    leave, costing compression, never correctness.  bench.py
    (pframe_720p full-vs-epzs, mv_search_4k) publishes the measured
    throughput/size trade.
    """
    H, W = cur.shape
    bh, bw = H // block, W // block
    cur = jnp.asarray(cur, jnp.int32)
    ref = jnp.asarray(ref, jnp.int32)
    prev_mvs = jnp.asarray(prev_mvs, jnp.int32)
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]

    def sad_cost_at(mvb):
        dy = jnp.repeat(jnp.repeat(mvb[..., 0], block, 0), block, 1)
        dx = jnp.repeat(jnp.repeat(mvb[..., 1], block, 0), block, 1)
        ys = jnp.clip(yy + dy, 0, H - 1)
        xs = jnp.clip(xx + dx, 0, W - 1)
        diff = jnp.abs(cur - ref[ys, xs])
        sad = diff.reshape(bh, block, bw, block).sum(axis=(1, 3))
        pen = (jnp.abs(mvb[..., 0] - prev_mvs[..., 0]) +
               jnp.abs(mvb[..., 1] - prev_mvs[..., 1])) * lam
        return sad, sad + pen

    half = (radius + 1) // 2
    pts = sorted({-radius, -half, 0, half, radius})
    cands = [jnp.broadcast_to(jnp.asarray([dy, dx], jnp.int32),
                              (bh, bw, 2))
             for dy in pts for dx in pts]

    def shift_field(f, dy, dx):
        ys = jnp.clip(jnp.arange(bh) + dy, 0, bh - 1)
        xs = jnp.clip(jnp.arange(bw) + dx, 0, bw - 1)
        return f[ys][:, xs]

    for dy, dx in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)):
        cands.append(jnp.clip(shift_field(prev_mvs, dy, dx),
                              -radius, radius))
    costs1 = jnp.stack([sad_cost_at(c)[1] for c in cands])
    b1 = jnp.argmin(costs1, axis=0)
    ctr = jnp.take_along_axis(
        jnp.stack(cands),
        jnp.broadcast_to(b1[None, :, :, None], (1, bh, bw, 2)),
        axis=0)[0]

    r2 = min(2, radius)
    cands2 = [jnp.clip(ctr + jnp.asarray([dy, dx], jnp.int32),
                       -radius, radius)
              for dy in range(-r2, r2 + 1) for dx in range(-r2, r2 + 1)]
    sads2, costs2 = zip(*[sad_cost_at(c) for c in cands2])
    sads2 = jnp.stack(sads2)
    costs2 = jnp.stack(costs2)
    b2 = jnp.argmin(costs2, axis=0)
    mvs = jnp.take_along_axis(
        jnp.stack(cands2),
        jnp.broadcast_to(b2[None, :, :, None], (1, bh, bw, 2)),
        axis=0)[0]
    take = lambda a: jnp.take_along_axis(a, b2[None], 0)[0]  # noqa: E731
    return mvs, take(sads2), take(costs2)


SEARCH_FNS = {"full": block_motion_search_cost,
              "epzs": block_motion_search_epzs}


@functools.partial(jax.jit, static_argnames=("block",)) \
    if _HAVE_JAX else (lambda f: f)
def motion_compensate(ref, mvs, block: int = 16):
    """Build the motion-compensated prediction from per-block vectors."""
    ref = jnp.asarray(ref, jnp.int32)
    H, W = ref.shape
    yy = jnp.arange(H)
    xx = jnp.arange(W)
    dy = jnp.repeat(mvs[:, :, 0], block, axis=0)
    dy = jnp.repeat(dy, block, axis=1)
    dx = jnp.repeat(mvs[:, :, 1], block, axis=0)
    dx = jnp.repeat(dx, block, axis=1)
    ys = jnp.clip(yy[:, None] + dy, 0, H - 1)
    xs = jnp.clip(xx[None, :] + dx, 0, W - 1)
    return ref[ys, xs]


def pad_to_block(plane, block=16):
    """Edge-pad to block multiples; ``block`` may be (by, bx)."""
    by, bx = block if isinstance(block, tuple) else (block, block)
    H, W = plane.shape
    ph = (-H) % by
    pw = (-W) % bx
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane
