"""Device-resident FFV1-P: the motion-compensated inter codec as one
fused lane-major device pipeline.

Round-2's ``pframe/codec.py`` proved the format at host speed (per-block
Python rac loops, numpy OBMC).  This module runs the whole P-frame
encode on device:

  motion search  -> fused candidate-grid SAD/cost (pframe/motion.py,
                    vmapped over slice lanes; motion_est.c:904 analog)
  OBMC predict   -> exact-integer tent-weighted 2x2 blend as a device
                    stencil (snow.c:327 / snow.h:279 add_yblock analog)
  residual       -> cur - pred + offset at bits+1 width
                    (the RGB offset trick, ffv1enc.c:464-467)
  MV section     -> per-block [flag, d_dy, d_dx] put_symbols coded by
                    the SAME lane-major range-coder scan as the
                    residuals (format v3: the flag is a put_symbol, so
                    the whole post-header payload is one symbol stream)
  entropy scan   -> the production lane scan + finalize
                    (tpu/encoder.py _scan_finalize: the CUDA kernel on
                    the GPU, the XLA scan on the CPU)

Reference planes, MV predictor fields and all adaptive states stay
device-resident across the GOP; keyframes ride the parent intra
pipeline byte-identically and reset everything (ffv1enc.c:1171-1172).

Bitstream parity: byte-exact vs the host FFV1PEncoder
(tests/test_pframe_tpu.py).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..codec.params import EncoderParams
from ..core import tables as T
from ..tpu.cuda_scan import (N_MULTIPLE, device_scan,
                             rc_decode_planes)
from ..tpu.encoder import TPUFFV1Encoder
from ..tpu.residual import load_plane, residuals_and_contexts
from .codec import BLOCK, LAMBDA
from .motion import SEARCH_FNS  # noqa: F401  (search mode registry)


def _tent_indices(H, W, by, bx):
    """Static OBMC geometry: per-pixel 2x2 neighbor block rows/cols and
    tent weights (pframe/codec.py obmc_predict, exact integers)."""
    y = np.arange(H)
    x = np.arange(W)
    ty = (2 * y + 1 - by) // (2 * by)
    wy1 = (2 * y + 1 - by) - ty * 2 * by
    tx = (2 * x + 1 - bx) // (2 * bx)
    wx1 = (2 * x + 1 - bx) - tx * 2 * bx
    return ty, wy1, tx, wx1


def obmc_predict_dev(ref_pad, mvs, intra, mid: int, by: int, bx: int,
                     bounds=None):
    """Device OBMC: blend the 2x2 nearest block-center MC predictions
    with exact-integer bilinear tent weights (partition of unity,
    sum = 4*by*bx).  ``ref_pad``: (L, H, W) int32; ``mvs``: (L, bh, bw,
    2); ``intra``: (L, bh, bw) bool.  Byte-exact vs the numpy
    obmc_predict (pframe/codec.py:79-117).

    ``bounds`` = ((ylo, yhi), (xlo, xhi)) inclusive MV component ranges
    when the caller can bound them (the encoder: its own search radius).
    With bounds, the per-pixel 2D gathers are replaced by a dense
    one-hot masked sum
    over the (ny*nx) static edge-clamped shifts of ref, with the block
    fields expanded by repeat + static slice instead of gathers.  All
    int32 adds, so the result is bit-identical to the gather form.
    Callers that cannot bound the MVs (the decoder: the stream's
    encoder may have used any radius) pass bounds=None and keep the
    gather form."""
    L, H, W = ref_pad.shape
    bh, bw = H // by, W // bx
    ty, wy1, tx, wx1 = _tent_indices(H, W, by, bx)
    # weights sum to 4*by*bx <= 1024 and samples < 2^17, so the
    # accumulator fits int32 comfortably (host obmc_predict uses int64
    # out of caution; values are identical)
    shift = 2 + (by - 1).bit_length() + (bx - 1).bit_length()

    if bounds is not None:
        (ylo, yhi), (xlo, xhi) = bounds
        ny, nx = yhi - ylo + 1, xhi - xlo + 1
        # block fields at pixel resolution WITHOUT gathers: edge-pad the
        # block grid by one, upsample by repeat, then each 2x2 tap is a
        # pure static slice — clip(ty + dy, 0, bh-1) of the unpadded
        # grid equals index ty + dy + 1 of the padded one, and
        # (ty(y) + 1 + dy) * by + const = y + by//2 + dy*by row-exactly
        # (ty = floor((2y + 1 - by) / 2by))
        def expand(field):
            f = jnp.pad(field, ((0, 0), (1, 1), (1, 1)) +
                        ((0, 0),) * (field.ndim - 3), mode="edge")
            return jnp.repeat(jnp.repeat(f, by, axis=1), bx, axis=2)

        mvs_e = expand(mvs)
        intra_e = expand(intra.astype(jnp.int32))
        idx_taps, w_taps = [], []
        for dy in (0, 1):
            wy = np.where(dy == 0, 2 * by - wy1, wy1)[None, :, None]
            oy = by // 2 + dy * by
            for dx in (0, 1):
                wx = np.where(dx == 0, 2 * bx - wx1, wx1)[None, None, :]
                ox = bx // 2 + dx * bx
                mvb = mvs_e[:, oy:oy + H, ox:ox + W]
                inb = intra_e[:, oy:oy + H, ox:ox + W]
                # candidate index in [0, ny*nx); intra taps get -1 so
                # no candidate matches (their weight lands on mid)
                idx = ((mvb[..., 0] - ylo) * nx +
                       (mvb[..., 1] - xlo))
                idx = jnp.where(inb > 0, -1, idx)
                idx_taps.append(idx)
                w_taps.append(np.asarray(wy * wx, np.int32))
        idx_s = jnp.stack(idx_taps)                       # (4, L, H, W)
        # w_taps entries are (1, H, W) numpy consts -> (4, 1, H, W)
        w_s = jnp.asarray(np.stack(w_taps))
        intra_w = (jnp.stack([(i < 0).astype(jnp.int32)
                              for i in idx_taps]) * w_s).sum(0)
        acc = intra_w * jnp.int32(mid)
        # edge-clamped static shifts: one pad, then pure slices
        rp_ = jnp.pad(ref_pad, ((0, 0), (-ylo, yhi), (-xlo, xhi)),
                      mode="edge")
        for u in range(ylo, yhi + 1):
            for v in range(xlo, xhi + 1):
                c = (u - ylo) * nx + (v - xlo)
                w_c = ((idx_s == c).astype(jnp.int32) * w_s).sum(0)
                sh = rp_[:, u - ylo:u - ylo + H, v - xlo:v - xlo + W]
                acc = acc + w_c * sh
        return ((acc + (1 << (shift - 1))) >> shift).astype(jnp.int32)

    yy = jnp.arange(H)[None, :, None]
    xx = jnp.arange(W)[None, None, :]
    acc = jnp.zeros((L, H, W), jnp.int32)
    for dy in (0, 1):
        iy = np.clip(ty + dy, 0, bh - 1)
        wy = np.where(dy == 0, 2 * by - wy1, wy1)[None, :, None]
        for dx in (0, 1):
            ix = np.clip(tx + dx, 0, bw - 1)
            wx = np.where(dx == 0, 2 * bx - wx1, wx1)[None, None, :]
            # block fields expanded to pixel resolution (static gather)
            mvb = mvs[:, iy][:, :, ix]                    # (L, H, W, 2)
            inb = intra[:, iy][:, :, ix]                  # (L, H, W)
            ys = jnp.clip(yy + mvb[..., 0], 0, H - 1)
            xs = jnp.clip(xx + mvb[..., 1], 0, W - 1)
            p = jax.vmap(lambda r, a, b: r[a, b])(ref_pad, ys, xs)
            p = jnp.where(inb, mid, p)
            acc = acc + jnp.asarray(wy * wx, jnp.int32) * p
    return ((acc + (1 << (shift - 1))) >> shift).astype(jnp.int32)


def _pad_edge(x, ph, pw):
    """Edge-pad the trailing two dims (pad_to_block device analog)."""
    if ph:
        x = jnp.concatenate([x] + [x[:, -1:, :]] * ph, axis=1)
    if pw:
        x = jnp.concatenate([x] + [x[:, :, -1:]] * pw, axis=2)
    return x


class TPUFFV1PEncoder(TPUFFV1Encoder):
    """Device FFV1-P encoder (experimental, like the host FFV1PEncoder).

    ``batch`` streams advance in lockstep with a shared GOP cadence;
    lanes = batch x slices.  Keyframes are byte-identical to the intra
    device path (and to the host/reference encoder); P frames are
    byte-identical to the host FFV1PEncoder."""

    def __init__(self, params: EncoderParams, batch: int = 1,
                 radius: int = 7, experimental: bool = False, mesh=None,
                 me: str = "full"):
        if not experimental:
            raise ValueError(
                "FFV1-P motion coding is experimental; pass "
                "experimental=True (mirrors the reference's strict -2 "
                "gate, ffv1enc.c:703-706)")
        if params.gop_size < 2:
            raise ValueError("FFV1-P needs gop_size >= 2")
        from .motion import SEARCH_FNS
        if me not in SEARCH_FNS:
            raise ValueError(f"me must be one of {sorted(SEARCH_FNS)}")
        self.me = me
        super().__init__(params, batch=batch, mesh=mesh)
        rp = self.rp
        if rp.bits_per_raw_sample > 15 or rp.colorspace != 0 or \
                rp.fmt.interleaved:
            raise NotImplementedError(
                "device FFV1-P supports planar YUV/gray input up to 15 "
                "bits (residuals code at bits+1)")
        if rp.ac == T.AC_GOLOMB_RICE:
            raise NotImplementedError("FFV1-P requires the range coder")
        if rp.version < 3 or rp.version > 3:
            raise NotImplementedError("FFV1-P rides version 3")
        if not self.uniform:
            raise NotImplementedError(
                "device FFV1-P requires a uniform slice grid")
        self.radius = radius
        g0 = self.geoms[0]
        if g0.width % BLOCK or g0.height % BLOCK:
            # blocks may not straddle slice bounds (slices stay
            # independent); host FFV1P pads per-slice, we require
            # block-aligned slices for the block-reshape crop
            self.pad_h = (-g0.height) % BLOCK
            self.pad_w = (-g0.width) % BLOCK
        else:
            self.pad_h = self.pad_w = 0
        self.SH = g0.height + self.pad_h
        self.SW = g0.width + self.pad_w
        self.bh, self.bw = self.SH // BLOCK, self.SW // BLOCK

        # P streams carry their own format-version marker in the
        # extradata tail (pframe/codec.py P_MAGIC)
        from .codec import p_extradata
        self.extradata = p_extradata(self.extradata)

        # MV context rows appended after the plane state groups
        self.mv_base = self.total_cc
        self.total_cc = self.total_cc + 3
        self.states = jnp.full((self.L, self.total_cc, 32), 128,
                               dtype=jnp.uint8)

        # P stream geometry: MV section (3 slots per block) + residual
        # planes at bits + 1
        self.p_bits = self.bits + 1
        self.mv_cap = 3 * self.bh * self.bw
        n_res = self.stream_lens[0]
        self.p_n_max = -(-(self.mv_cap + n_res) // N_MULTIPLE) * N_MULTIPLE
        self.p_out_cap = self.p_n_max * 3 + 4096

        # device-resident inter state
        self.ref_dev = None                        # tuple of (B, H, W)
        self.prev_mvs = jnp.zeros((self.L, self.bh, self.bw, 2),
                                  jnp.int32)
        self._p_fn = jax.jit(self._frame_pipeline_p)

    # -----------------------------------------------------------------

    def _crops(self, stack):
        return self._crops_uniform(stack, self.rp.num_h_slices,
                                   self.rp.num_v_slices)

    def _search(self, cur_pad, ref_pad, prev_mvs):
        """Vectorized rate-aware search + intra decision over lanes
        (pframe/codec.py _search_slice, device form).  ``me`` selects
        the full-grid or the EPZS-style predictor-seeded search — the
        SAME jax function the host encoder calls, so byte parity holds
        in either mode."""
        from .motion import SEARCH_FNS
        search = SEARCH_FNS[self.me]
        mvs, sad, cost = jax.vmap(
            lambda c, r, p: search(
                c, r, p, BLOCK, self.radius, LAMBDA))(
            cur_pad, ref_pad, prev_mvs)
        B2 = BLOCK * BLOCK
        blocks = cur_pad.reshape(self.L, self.bh, BLOCK, self.bw, BLOCK) \
            .transpose(0, 1, 3, 2, 4)
        mean = (blocks.reshape(self.L, self.bh, self.bw, B2)
                .sum(-1) + B2 // 2) // B2
        intra_sad = jnp.abs(blocks - mean[..., None, None]) \
            .reshape(self.L, self.bh, self.bw, B2).sum(-1)
        intra = cost > intra_sad + B2
        mvs = jnp.where(intra[..., None], 0, mvs)
        return mvs, intra

    def _mv_stream(self, mvs, intra, prev_mvs):
        """Per-lane (ctx, diff, act) for the MV section: row-major
        blocks, slots [flag, d_dy, d_dx] on rows mv_base + {0, 1, 2}."""
        L = self.L
        nb = self.bh * self.bw
        flag_v = jnp.where(intra, 0, 1).reshape(L, nb)
        d = (mvs - prev_mvs).reshape(L, nb, 2)
        inter = (~intra).reshape(L, nb)
        diffs = jnp.stack([flag_v, d[..., 0], d[..., 1]], axis=2) \
            .reshape(L, 3 * nb)
        ctx_row = jnp.asarray(
            np.tile(np.array([0, 1, 2], np.int32), nb) + 0)
        ctxs = jnp.broadcast_to(ctx_row[None, :] + self.mv_base,
                                (L, 3 * nb))
        acts = jnp.stack([jnp.ones_like(inter), inter, inter], axis=2) \
            .reshape(L, 3 * nb)
        return ctxs, diffs, acts

    def _residual_streams(self, streams, refs, mvs, intra):
        """Fused OBMC + residual + stencil for all planes; returns
        (ctx, diff) lane streams in coding order (luma, then chroma
        pair, then alpha — pframe/codec.py _residual_jobs)."""
        rp = self.rp
        bits = self.raw_bits
        mid = 1 << (bits - 1)
        offset = 1 << bits
        parts_ctx, parts_diff = [], []

        import os as _os
        onehot = _os.environ.get("FFV1_OBMC_ONEHOT", "1") \
            not in ("0", "false")

        def add(cur_stack, ref_stack, blk, pmvs, state_plane,
                bounds=None):
            by, bx = blk
            cur = self._crops(cur_stack.astype(jnp.int32))
            ref = self._crops(ref_stack.astype(jnp.int32))
            h, w = cur.shape[1], cur.shape[2]
            ph, pw = (-h) % by, (-w) % bx
            cur_p = _pad_edge(cur, ph, pw)
            ref_p = _pad_edge(ref, ph, pw)
            pred = obmc_predict_dev(ref_p, pmvs, intra, mid, by, bx,
                                    bounds if onehot else None)
            res = cur_p[:, :h, :w] - pred[:, :h, :w] + offset
            s = load_plane(res, self.p_bits, True)

            def stencil(img):
                c, d = residuals_and_contexts(img, self.qt, self.p_bits,
                                              self.five_input,
                                              qspec=self.qspec)
                return c.reshape(-1), d.reshape(-1)

            c, d = jax.vmap(stencil)(s)
            parts_ctx.append(c + state_plane * self.cc)
            parts_diff.append(d)

        r = self.radius
        lb = ((-r, r), (-r, r))       # search clips MVs to the radius
        add(streams[0], refs[0], (BLOCK, BLOCK), mvs, 0, bounds=lb)
        if rp.chroma_planes:
            hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
            cblk = (max(BLOCK >> vs, 2), max(BLOCK >> hs, 2))
            cmvs = jnp.stack([mvs[..., 0] >> vs, mvs[..., 1] >> hs], -1)
            cb = (((-r) >> vs, r >> vs), ((-r) >> hs, r >> hs))
            add(streams[1], refs[1], cblk, cmvs, 1, bounds=cb)
            add(streams[2], refs[2], cblk, cmvs, 1, bounds=cb)
        if rp.transparency:
            add(streams[-1], refs[-1], (BLOCK, BLOCK), mvs,
                2 if rp.chroma_planes else 1, bounds=lb)
        return jnp.concatenate(parts_ctx, 1), jnp.concatenate(parts_diff, 1)

    def _frame_pipeline_p(self, streams, refs, prev_mvs, states0, lows,
                          ranges, prefixes, plens):
        """Fused P-frame device pipeline: search -> OBMC -> residual ->
        MV + residual symbol streams -> lane scan -> finalize."""
        cur_l = self._crops(streams[0].astype(jnp.int32))
        ref_l = self._crops(refs[0].astype(jnp.int32))
        cur_pad = _pad_edge(cur_l, self.pad_h, self.pad_w)
        ref_pad = _pad_edge(ref_l, self.pad_h, self.pad_w)
        mvs, intra = self._search(cur_pad, ref_pad, prev_mvs)

        mv_ctx, mv_diff, mv_act = self._mv_stream(mvs, intra, prev_mvs)
        res_ctx, res_diff = self._residual_streams(streams, refs, mvs,
                                                   intra)
        n = self.mv_cap + res_ctx.shape[1]
        ctxs = jnp.pad(jnp.concatenate([mv_ctx, res_ctx], 1),
                       ((0, 0), (0, self.p_n_max - n)))
        diffs = jnp.pad(jnp.concatenate([mv_diff, res_diff], 1),
                        ((0, 0), (0, self.p_n_max - n)))
        acts = jnp.pad(jnp.concatenate(
            [mv_act.astype(bool),
             jnp.ones(res_ctx.shape, bool)], 1),
            ((0, 0), (0, self.p_n_max - n)))

        out, counts, states_out, overflow, packed, low, rng = \
            self._scan_finalize(ctxs, diffs, acts, states0, lows,
                                ranges, prefixes, plens,
                                bits=self.p_bits, hostcompact=False)
        # inter blocks update the MV predictor field (codec.py:262)
        new_prev = jnp.where(intra[..., None], prev_mvs, mvs)
        # slab head (count + overflow), matching the parent collect's
        # single-RPC fetch protocol (tpu/encoder.py)
        head = jnp.stack(
            [(counts >> sh) & 0xFF for sh in (0, 8, 16, 24)] +
            [overflow.astype(jnp.int32)], axis=1).astype(jnp.uint8)
        out2 = jnp.concatenate([head, out[:, :self.p_out_cap]], axis=1)
        return (out2, counts, states_out, overflow,
                packed, low, rng, new_prev)

    # -----------------------------------------------------------------

    def submit_frames(self, streams):
        rp = self.rp
        assert len(streams) == self.batch
        streams_np = tuple(
            tuple(np.asarray(p)
                  for p in (s if isinstance(s, (list, tuple)) else [s]))
            for s in streams)
        keyframe = (rp.gop_size == 0 or
                    self.picture_number % rp.gop_size == 0)

        lows, ranges, prefixes, plens = self._prefix_arrays(keyframe)

        def upload():
            nplanes = len(streams_np[0])
            return tuple(
                jnp.asarray(np.stack([s[k] for s in streams_np]))
                for k in range(nplanes))

        up_fut = self._upload_pool.submit(upload)

        def work():
            from ..log import phase_timer
            with phase_timer("tpu-penc", "wait-upload"):
                cur = up_fut.result()
            if keyframe:
                states0 = jnp.full_like(self.states, 128)
                with phase_timer("tpu-penc", "dispatch-key"):
                    (out, counts, states_out, overflow, packed, low,
                     rng, _rowbytes) = self._frame_fn(
                        cur, states0, jnp.asarray(lows),
                        jnp.asarray(ranges), jnp.asarray(prefixes),
                        jnp.asarray(plens))
                # the keyframe's evolved intra contexts are NOT the
                # P chain's: the host codec clears a fresh SliceState
                # at each GOP start (codec.py _PSliceState / ps.ss,
                # cleared via clear_slice_state), so P residual/MV
                # contexts start from 128 after every keyframe
                states_out = jnp.full_like(self.states, 128)
                self.prev_mvs = jnp.zeros_like(self.prev_mvs)
            else:
                states0 = self.states
                with phase_timer("tpu-penc", "dispatch-p"):
                    (out, counts, states_out, overflow, packed,
                     low, rng, new_prev) = self._p_fn(
                        cur, self.ref_dev, self.prev_mvs, states0,
                        jnp.asarray(lows), jnp.asarray(ranges),
                        jnp.asarray(prefixes), jnp.asarray(plens))
                self.prev_mvs = new_prev
            self.states = states_out
            self.ref_dev = cur
            cap = self.out_cap if keyframe else self.p_out_cap
            if keyframe and self.host_compact:
                spec = -1
                slab_fut = self._xfer_pool.submit(
                    lambda: np.asarray(out))
            else:
                spec = min(self._last_cap, cap)
                slab_fut = self._xfer_pool.submit(
                    lambda: np.asarray(out[:, :5 + spec]))
            return dict(
                out=out, counts=counts, overflow=overflow,
                packed=packed, low=low, rng=rng, keyframe=keyframe,
                streams=None, states0=states0, lows=lows,
                ranges=ranges, prefixes=prefixes, plens=plens,
                streams_np=streams_np, slab_fut=slab_fut,
                spec=spec, out_cap=cap)

        self._pending.append(self._executor.submit(work))
        self.picture_number += 1

    def reset(self):
        """Flush analog: also drops the device reference plane and the
        MV predictor chain (next frame is a fresh keyframe)."""
        super().reset()
        self.ref_dev = None
        self.prev_mvs = jnp.zeros_like(self.prev_mvs)

    def collect_frames(self):
        """Parent collect with the P-frame output cap."""
        assert self._pending
        p = self._pending[0]
        if not isinstance(p, dict):
            res = p.result()
            self._pending[0] = res
            p = res
        save = self.out_cap
        self.out_cap = p.get("out_cap", save)
        try:
            return super().collect_frames()
        finally:
            self.out_cap = save


class TPUFFV1PDecoder:
    """Device FFV1-P decoder: host parses headers + MV sections (a few
    hundred symbols per frame), the residual planes decode as one fused
    lane-major device scan at bits + 1, and OBMC reconstruction runs as
    a device stencil.  Keyframes ride the intra device decoder; reference
    planes stay device-resident across the GOP.

    Mirrors FFV1PDecoder (pframe/codec.py) bit-exactly; ``batch``
    decodes independent streams in lockstep (shared GOP cadence).
    """

    def __init__(self, width: int, height: int, extradata: bytes,
                 batch: int = 1):
        from ..tpu.decoder import TPUFFV1Decoder
        from .codec import split_p_extradata
        self.base = TPUFFV1Decoder(width, height,
                                   split_p_extradata(extradata),
                                   batch=batch)
        b = self.base
        if not b.uniform:
            raise NotImplementedError(
                "device FFV1-P decode requires a uniform slice grid")
        if b.bits > 8:
            raise NotImplementedError(
                "device FFV1-P decode currently supports 8-bit content")
        self.batch = batch
        self.width, self.height = width, height
        self.L = b.L
        g0 = b.geoms[0]
        self.pad_h = (-g0.height) % BLOCK
        self.pad_w = (-g0.width) % BLOCK
        self.SH = g0.height + self.pad_h
        self.SW = g0.width + self.pad_w
        self.bh, self.bw = self.SH // BLOCK, self.SW // BLOCK
        self.p_bits = b.bits + 1

        # host-side per-lane MV decode state (cleared at keyframes)
        self.flag_states = np.full((self.L, 32), 128, np.uint8)
        self.mv_states = np.full((self.L, 2, 32), 128, np.uint8)
        self.prev_mvs = np.zeros((self.L, self.bh, self.bw, 2), np.int32)
        # device-side residual contexts + reference planes
        self.p_states = None
        self.ref_dev = None          # tuple of (B, Hk, Wk) int32 planes
        self.slice_damaged = b.slice_damaged
        # residuals decode at bits + 1 (CUDA kernel on the GPU, XLA
        # scan on the CPU)
        self.scan = device_scan(self.p_bits)
        self._p_dec = jax.jit(self._decode_p_device,
                              static_argnames=("qidx", "five"))

    # -------------------------------------------------------------

    def reset(self):
        """Flush analog: drop GOP contexts, MV chain and the device
        reference planes; the next packet must be a keyframe."""
        self._reset_gop()
        self.ref_dev = None
        self.base.reset()
        self.slice_damaged = self.base.slice_damaged

    def _reset_gop(self):
        self.flag_states[:] = 128
        self.mv_states[:] = 128
        self.prev_mvs[:] = 0
        self.p_states = None

    def _parse_mv_sections(self, parsed):
        """Host-serial MV decode per lane; returns (mvs, intra, lows,
        ranges, poss) with the rac state positioned at the residual
        planes."""
        from ..core.rac import RangeDecoder
        b = self.base
        L = self.L
        mvs = np.zeros((L, self.bh, self.bw, 2), np.int32)
        intra = np.zeros((L, self.bh, self.bw), bool)
        lows = np.zeros(L, np.int32)
        ranges = np.zeros(L, np.int32)
        poss = np.zeros(L, np.int32)
        for bi, (kf, sl, _ex) in enumerate(parsed):
            for si, (buf, qidx, lo, ra, po) in enumerate(sl):
                lane = bi * b.n_slices + si
                src = RangeDecoder(buf)
                src.set_tables(*b.tables)
                src.low, src.range, src.pos = lo, ra, po
                try:
                    from ..bitstream.symbols import get_symbol
                    for by in range(self.bh):
                        for bx in range(self.bw):
                            fl = get_symbol(src, self.flag_states[lane],
                                            True)
                            if fl:
                                mvs[lane, by, bx, 0] = \
                                    self.prev_mvs[lane, by, bx, 0] + \
                                    get_symbol(src, self.mv_states[lane, 0],
                                               True)
                                mvs[lane, by, bx, 1] = \
                                    self.prev_mvs[lane, by, bx, 1] + \
                                    get_symbol(src, self.mv_states[lane, 1],
                                               True)
                            else:
                                intra[lane, by, bx] = True
                except (ValueError, IndexError):
                    self.slice_damaged[bi, si] = True
                    intra[lane] = True
                    mvs[lane] = 0
                lows[lane], ranges[lane], poss[lane] = (src.low, src.range,
                                                        src.pos)
        self.prev_mvs = np.where(intra[..., None], self.prev_mvs, mvs)
        return mvs, intra, lows, ranges, poss

    def _decode_p_device(self, bufs, states0, refs, mvs, intra, lows,
                         ranges, poss, qidx=0, five=False):
        """Residual plane decode + OBMC reconstruction, one fused
        program.  ``qidx``/``five`` select the quant table / context
        model the slice headers carry (the host decoder reads them per
        slice; the fused path requires them uniform).  Returns (full
        planes tuple, states_out, low, rng, pos)."""
        b = self.base
        g = b.g
        cc = g.context_counts[qidx]
        specs = tuple((w, h, sp * cc)
                      for (w, h, sp) in b._plane_specs())
        qt = b.qts[qidx]
        planes_dev, states_out, low, rng, pos = rc_decode_planes(
            self.scan, bufs, states0, b.one_tab, b.zero_tab, qt, lows,
            ranges, poss, specs, self.p_bits, five)

        bits = b.bits
        mid = 1 << (bits - 1)
        offset = 1 << bits
        nh, nv = g.num_h_slices, g.num_v_slices
        mvs = jnp.asarray(mvs)
        intra = jnp.asarray(intra)

        def crops(stack):
            B, H, W = stack.shape
            h, w = H // nv, W // nh
            c = stack.reshape(B, nv, h, nh, w)
            return jnp.transpose(c, (0, 1, 3, 2, 4)) \
                .reshape(B * nv * nh, h, w)

        def uncrop(lanes_arr, h, w):
            x = lanes_arr.reshape(self.batch, nv, nh, h, w)
            return jnp.transpose(x, (0, 1, 3, 2, 4)) \
                .reshape(self.batch, nv * h, nh * w)

        full = []
        for k, (w, h, _sp) in enumerate(specs):
            if k in (1, 2) and g.chroma_planes:
                hs, vs = g.chroma_h_shift, g.chroma_v_shift
                blk = (max(BLOCK >> vs, 2), max(BLOCK >> hs, 2))
                pmvs = jnp.stack([mvs[..., 0] >> vs,
                                  mvs[..., 1] >> hs], -1)
            else:
                blk = (BLOCK, BLOCK)
                pmvs = mvs
            by, bx = blk
            ref = crops(refs[k].astype(jnp.int32))
            ph, pw = (-h) % by, (-w) % bx
            ref_p = _pad_edge(ref, ph, pw)
            pred = obmc_predict_dev(ref_p, pmvs, intra, mid, by, bx)
            rec = pred[:, :h, :w] + planes_dev[k] - offset
            rec = jnp.clip(rec, 0, (1 << bits) - 1)
            full.append(uncrop(rec, h, w))
        return tuple(full), states_out, low, rng, pos

    # -------------------------------------------------------------

    def decode_frame(self, pkt: bytes):
        assert self.batch == 1
        return self.decode_frames([pkt])[0]

    def decode_frames(self, pkts):
        b = self.base
        assert len(pkts) == self.batch
        parsed = [b._parse_packet(bi, pkt) for bi, pkt in enumerate(pkts)]
        keyframes = [p[0] for p in parsed]
        if any(keyframes):
            assert all(keyframes), \
                "batched GOP streams must share the keyframe cadence"
            results = b.decode_frames(pkts)
            self._reset_gop()
            # decoded keyframes become the device reference planes
            self.ref_dev = tuple(
                jnp.asarray(np.stack([np.asarray(results[bi][0][k])
                                      for bi in range(self.batch)]))
                for k in range(len(results[0][0])))
            return results

        mvs, intra, lows, ranges, poss = self._parse_mv_sections(parsed)

        qidx0 = parsed[0][1][0][1]
        if any(sl[1] != qidx0 for pr in parsed for sl in pr[1]):
            raise NotImplementedError(
                "device FFV1-P decode requires a shared quant table "
                "across slices; use the host decoder")
        five = bool(b.g.quant_tables[qidx0][3][127])
        if self.p_states is None:
            self.p_states = jnp.asarray(np.tile(
                b._fresh_states(qidx0)[None], (self.L, 1, 1)))
        maxlen = max(len(s[0]) for _, sl, _e in parsed for s in sl)
        cap = max(4096, 1 << (maxlen - 1).bit_length())
        bufs = np.zeros((self.L, cap), np.uint8)
        for bi, (kf, sl, _ex) in enumerate(parsed):
            for si, (buf, *_r) in enumerate(sl):
                lane = bi * b.n_slices + si
                bufs[lane, :len(buf)] = np.frombuffer(buf, np.uint8)

        full, states_out, low, rng, pos = self._p_dec(
            jnp.asarray(bufs), self.p_states, self.ref_dev,
            jnp.asarray(mvs), jnp.asarray(intra), jnp.asarray(lows),
            jnp.asarray(ranges), jnp.asarray(poss), qidx=qidx0,
            five=five)
        self.p_states = states_out

        # sentinel + byte-count validation (ffv1dec.c:459-467)
        from ..core.rac import RangeDecoder
        low_np, rng_np, pos_np = (np.asarray(low), np.asarray(rng),
                                  np.asarray(pos))
        for bi, (kf, sl, _ex) in enumerate(parsed):
            for si, (buf, *_r) in enumerate(sl):
                lane = bi * b.n_slices + si
                src = RangeDecoder(buf)
                src.set_tables(*b.tables)
                src.low, src.range, src.pos = (int(low_np[lane]),
                                               int(rng_np[lane]),
                                               int(pos_np[lane]))
                sentinel = np.array([129], dtype=np.uint8)
                try:
                    src.get_rac(sentinel, 0)
                    v = (len(buf) - src.pos) - 2 - \
                        5 * (1 if b.ec else 0)
                    if v:
                        raise ValueError("bytestream end mismatch")
                except (ValueError, IndexError):
                    self.slice_damaged[bi, si] = True

        full_np = [np.asarray(p) for p in full]
        results = []
        damaged_any = self.slice_damaged.any()
        out_dt = np.uint8
        for bi in range(self.batch):
            planes = [fp[bi].astype(out_dt) for fp in full_np]
            planes = b._conceal(bi, planes)
            results.append((planes, False))
        if damaged_any:
            # concealment patched host copies; re-upload so device refs
            # match the decoder output (rare path)
            self.ref_dev = tuple(
                jnp.asarray(np.stack([np.asarray(results[bi][0][k])
                                      for bi in range(self.batch)]))
                for k in range(len(results[0][0])))
        else:
            self.ref_dev = full
        return results
