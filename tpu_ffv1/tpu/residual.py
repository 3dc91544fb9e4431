"""Device-side residual + context precompute (encode).

FFV1's encoder-side median predictor and quantized-gradient context depend
only on *source* samples (lossless coding: decoded == original), so unlike
the decoder there is no wavefront recurrence at encode time: the whole
plane is a pure stencil, computed in one fused XLA pass over the image.
This is where the encoder's parallel work lives; the remaining sequential
work (adaptive entropy coding) is a per-slice scan in rc_scan.py.

Neighbor/border semantics mirror ffv1enc.c:373-411 (ring buffer with
zero-initialized rows, cur[-1] = last[0], last[w] = last[w-1]) and
ffv1.h:161-190 (predict/get_context).  Derivation of the border values in
array form:

    T [y,x] = s[y-1,x]          (0 for y=0)
    RT[y,x] = s[y-1,x+1]        (x=w-1 -> s[y-1,w-1]; 0 for y=0)
    L [y,x] = s[y,x-1]          (x=0   -> s[y-1,0] = T[y,0])
    LT[y,x] = s[y-1,x-1]        (x=0   -> s[y-2,0]; 0 for y<2)
    LL[y,x] = s[y,x-2]          (x=1   -> s[y-1,0]; x=0 -> 0)
    TT[y,x] = s[y-2,x]          (0 for y<2)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def neighbors(s: jnp.ndarray):
    """All predictor/context neighbors with FFV1 border extension.

    ``s`` is an int32 (H, W) plane (int16-wrapped sample values).
    Returns dict of int32 (H, W) arrays.
    """
    H, W = s.shape
    zrow = jnp.zeros((1, W), dtype=s.dtype)
    T = jnp.concatenate([zrow, s[:-1, :]], axis=0)
    TT = jnp.concatenate([zrow, zrow, s[:-2, :]], axis=0) if H >= 2 else \
        jnp.zeros_like(s)
    RT = jnp.concatenate([T[:, 1:], T[:, -1:]], axis=1)
    L = jnp.concatenate([T[:, :1], s[:, :-1]], axis=1)
    LT = jnp.concatenate([TT[:, :1], T[:, :-1]], axis=1)
    if W >= 2:
        LL = jnp.concatenate([jnp.zeros_like(s[:, :1]), T[:, :1],
                              s[:, :-2]], axis=1)
    else:
        LL = jnp.zeros_like(s)
    return {"L": L, "T": T, "LT": LT, "RT": RT, "LL": LL, "TT": TT}


def _fold(diff, bits):
    if bits == 8:
        return ((diff + 128) & 0xFF) - 128
    half = 1 << (bits - 1)
    return ((diff + half) & ((1 << bits) - 1)) - half


def quant_spec(qt_np):
    """Decompose the (5, 256) quant table into threshold/step form.

    Each normative subtable, viewed as a function of the SIGNED byte
    gradient d in [-128, 127] (index (d & 0xFF), ffv1.h:181-189), is a
    monotone step function with <= 10 change points (11 levels), so the
    stencil replaces a 256-entry gather over an image-sized index array
    with 10 fused compare+multiply-adds:
        q(d) = base + sum_j inc_j * (d >= t_j)
    Returns (thresholds int32 (5, NT), increments int32 (5, NT),
    bases int32 (5,)) padded with never-true thresholds (128).
    """
    qt_np = np.asarray(qt_np)
    ths, incs, bases = [], [], []
    for k in range(5):
        signed = np.array([qt_np[k][d & 0xFF] for d in range(-128, 128)],
                          np.int64)
        t = [int(d) for d in range(-127, 128)
             if signed[d + 128] != signed[d + 127]]
        inc = [int(signed[d + 128] - signed[d + 127]) for d in t]
        ths.append(t)
        incs.append(inc)
        bases.append(int(signed[0]))
    nt = max(1, max(len(t) for t in ths))
    if nt > 24:   # non-normative table: caller should use the gather path
        return None
    ths = [t + [128] * (nt - len(t)) for t in ths]
    incs = [i + [0] * (nt - len(i)) for i in incs]
    return (np.array(ths, np.int32), np.array(incs, np.int32),
            np.array(bases, np.int32))


def _quant_steps(d, ths_k, incs_k, base_k):
    """q(d) for signed gradient array d via the threshold/step form."""
    q = jnp.full_like(d, base_k)
    for j in range(ths_k.shape[0]):
        q = q + incs_k[j] * (d >= ths_k[j]).astype(jnp.int32)
    return q


def _sgrad(a, b):
    """Signed byte gradient ((a - b) wrapped to [-128, 127])."""
    return ((a - b + 128) & 0xFF) - 128


def residuals_and_contexts(s: jnp.ndarray, quant_table: jnp.ndarray,
                           bits: int, five_input: bool, qspec=None):
    """Fused stencil: per-pixel (context_id, folded_residual).

    ``quant_table``: (5, 256) int32.  ``five_input``: static flag for the
    5-gradient model (quant_table[3][127] != 0, ffv1.h:178).  ``qspec``:
    optional precomputed quant_spec() arrays — replaces the three/five
    256-entry gathers with fused compare+MAC chains (the production
    path).
    Returns (ctx >= 0 int32 (H,W), diff int32 (H,W)) after the sign fold
    (ffv1enc.c:312-317).
    """
    n = neighbors(s.astype(jnp.int32))
    L, T, LT, RT = n["L"], n["T"], n["LT"], n["RT"]

    if qspec is not None:
        ths, incs, bases = qspec
        ctx = (_quant_steps(_sgrad(L, LT), ths[0], incs[0], bases[0]) +
               _quant_steps(_sgrad(LT, T), ths[1], incs[1], bases[1]) +
               _quant_steps(_sgrad(T, RT), ths[2], incs[2], bases[2]))
        if five_input:
            ctx = ctx + \
                _quant_steps(_sgrad(n["LL"], L), ths[3], incs[3],
                             bases[3]) + \
                _quant_steps(_sgrad(n["TT"], T), ths[4], incs[4],
                             bases[4])
    else:
        ctx = (quant_table[0][(L - LT) & 0xFF] +
               quant_table[1][(LT - T) & 0xFF] +
               quant_table[2][(T - RT) & 0xFF])
        if five_input:
            ctx = ctx + (quant_table[3][(n["LL"] - L) & 0xFF] +
                         quant_table[4][(n["TT"] - T) & 0xFF])

    # integer median of (L, L+T-LT, T): sum - min - max
    b = L + T - LT
    pred = (L + b + T) - jnp.minimum(jnp.minimum(L, b), T) \
        - jnp.maximum(jnp.maximum(L, b), T)
    diff = s.astype(jnp.int32) - pred

    neg = ctx < 0
    ctx = jnp.where(neg, -ctx, ctx)
    diff = jnp.where(neg, -diff, diff)
    diff = _fold(diff, bits)
    return ctx, diff


def rct_transform(g, b, r, bits: int, by: int = 1, ry: int = 1):
    """Forward reversible color transform as a device op
    (ffv1enc.c:447-453): b -= g; r -= g; g += (b*by + r*ry) >> 2;
    b += offset; r += offset with offset = 1 << bits.

    ``by``/``ry`` are the slice RCT coefficients (fixed 1,1 for
    version <= 3; the v4 per-slice search stays on the host).  Inputs
    int32 arrays of equal shape; returns transformed (g, b, r).
    """
    g = g.astype(jnp.int32)
    b = b.astype(jnp.int32) - g
    r = r.astype(jnp.int32) - g
    g = g + ((b * by + r * ry) >> 2)
    offset = jnp.int32(1) << bits
    return g, b + offset, r + offset


def wrap_int16(v):
    """int16_t storage wrap (sample buffers are int16 in the reference)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def load_plane(src: jnp.ndarray, bits: int, packed_at_lsb: bool):
    """Sample load semantics (ffv1enc.c:390-404) as a device op."""
    v = src.astype(jnp.int32)
    if bits > 8 and not packed_at_lsb:
        v = v >> (16 - bits)
    if bits > 8:
        v = wrap_int16(v)
    return v
