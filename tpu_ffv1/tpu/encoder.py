"""Device FFV1 encoder: parallel stencil + lane-major device scans.

Pipeline per frame (range-coder versions):
  host:   keyframe bit + (v3) slice headers  ->  provisional prefixes
  device: residual/context stencil (parallel, residual.py)
          lane-major adaptive range-coder scan — all slices of the frame
          (and optionally a batch of independent streams) advance together
          as lanes (the CUDA kernel on the GPU, the XLA scan of
          rc_scan_lanes.py on the CPU; cuda_scan.scan_impl chooses)
          sentinel/terminate/carry-resolve/compaction (finalize_packed:
          resolve over the uncompacted stream, then one key|byte sort)
  host:   footer chain + per-slice CRC + packet concat

Adaptive states live on device across frames (GOP context carry-over,
ffv1enc.c:1171-1172): non-key frames continue from states_out, keyframes
reset.  Coded widths <= 10 bits take the distinct-slot fast schedule;
11..17 bits (yuv444p16, RGB48) take the extended schedule that chains
put_symbol's repeated rows 10/31 sequentially (rc_scan_fast.ext_slots).

Byte output is validated against the spec encoder (tests/test_tpu.py) and
hence against the reference binary.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream.headers import write_extradata, write_slice_header
from ..core import tables as T
from ..core.crc import crc32_ieee
from ..core.rac import (ProvisionalRangeEncoder, custom_state_tables,
                        default_state_tables)
from ..core.intmath import ceil_rshift
from ..codec.context import slice_grid
from ..log import phase_timer
from ..codec.params import EncoderParams, resolve
from .residual import (load_plane, quant_spec, rct_transform,
                       residuals_and_contexts)
from .cuda_scan import N_MULTIPLE, device_scan, rc_encode_packed
from .rc_scan import finalize_slice, rc_encode_scan
from .rc_scan_lanes import (finalize_packed, finalize_packed_full,
                            finalize_packed_hostcompact)

PREFIX_CAP = 96


class TPUFFV1Encoder:
    """Device-resident FFV1 encoder (version 3, range coder).

    ``batch`` > 1 encodes that many *independent streams* in lockstep:
    their slice lanes all advance through one lane-major scan (lanes =
    batch x slices).  Slices are independent bitstreams and so are
    streams, so this is pure data parallelism — and the main throughput
    lever, since every lane of the scan runs concurrently
    (archival/transcode workloads batch GOP chunks).
    Use encode_frames([stream0_frame, stream1_frame, ...]).
    """

    def __init__(self, params: EncoderParams, batch: int = 1, mesh=None):
        self.rp = resolve(params)
        rp = self.rp
        self.golomb = rp.ac == T.AC_GOLOMB_RICE
        if rp.version < 2:
            raise NotImplementedError("device path requires version >= 3")
        self.rgb = rp.colorspace == 1
        if self.rgb and rp.ac == T.AC_GOLOMB_RICE:
            raise NotImplementedError(
                "device RGB path requires the range coder")
        # v4 runs the per-slice RCT parameter search wherever the host
        # engine does (ffv1enc.c:1163-1168 via codec/encoder.py): RGB,
        # and full-resolution >8-bit-chroma YUV (where the reference's
        # unguarded call is a pure function of the pixels; see
        # codec/rct.py).  On the fused pipeline the search runs on
        # device (tpu/rct_search.py, 15 candidates as unrolled
        # reductions) with only the (L,) winning indices crossing the
        # link; the slow/Golomb paths search on the host pixels.
        self.rct_search = rp.version > 3 and (
            self.rgb or
            (rp.colorspace == 0 and rp.chroma_planes and
             rp.bits_per_raw_sample > 8 and
             rp.chroma_h_shift == 0 and rp.chroma_v_shift == 0))
        # ya8 (interleaved luma/alpha, ffv1enc.c:1437): de-interleaved
        # at submit into a luma + alpha plane pair riding the standard
        # planar pipeline (alpha codes on state plane 1, matching the
        # reference's encode_plane(..., 1) call, ffv1enc.c:1196)
        self.ya = rp.colorspace == 0 and rp.fmt.interleaved
        self.batch = batch
        self.extradata = write_extradata(rp)
        self.geoms = slice_grid(rp.width, rp.height,
                                rp.num_h_slices, rp.num_v_slices)
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            one, zero = custom_state_tables(rp.state_transition)
        else:
            one, zero = default_state_tables()
        self.one_tab = jnp.asarray(one)
        self.zero_tab = jnp.asarray(zero)

        cc = rp.context_counts[rp.context_model]
        if self.rgb:
            # RGB plane -> state plane is (p + 1) / 2: G->0, B,R->1,
            # A->2 (ffv1enc.c:461-467)
            n_state_planes = 2 + (1 if rp.transparency else 0)
        else:
            n_state_planes = 1 + (1 if rp.chroma_planes else 0) + \
                (1 if rp.transparency else 0)
        self.total_cc = n_state_planes * cc
        self.cc = cc
        self.qt = jnp.asarray(rp.quant_tables[rp.context_model],
                              dtype=jnp.int32)
        # threshold/step form of the quant tables (numpy: captured as
        # jit constants) — kills the stencil's 256-entry gathers
        self.qspec = quant_spec(rp.quant_tables[rp.context_model])
        self.five_input = bool(rp.quant_tables[rp.context_model][3][127])
        self.raw_bits = 8 if rp.bits_per_raw_sample <= 8 else \
            rp.bits_per_raw_sample
        # RGB residuals are coded one bit wider than the samples: 9-bit
        # for <= 8-bit inputs, bits + 1 above (ffv1enc.c:464-467)
        self.bits = self.raw_bits + 1 if self.rgb else self.raw_bits
        self.fast = self.bits <= 10
        # 11..17-bit coded widths (yuv444p16, RGB48's bits+1 = 17,
        # 10-bit P residuals) ride the extended schedule, which chains
        # the repeated put_symbol rows 10/31 sequentially
        # (rc_scan_fast.ext_slots); beyond 17 nothing exists (16-bit
        # samples max, +1 for RGB/P residuals)
        self.ext = 10 < self.bits <= 17
        self.n_slices = len(self.geoms)
        self.L = self.n_slices * batch
        # multi-chip: shard slice lanes over a device mesh (the
        # device analog of the reference's slice thread pool,
        # pthread_slice.c — see tpu/sharding.py).  Slices are
        # independent bitstreams, so the scan+finalize runs under
        # shard_map with zero collectives.
        self.mesh = mesh
        if mesh is not None and self.L % mesh.devices.size:
            raise ValueError(
                f"lane count {self.L} (batch x slices) must divide the "
                f"mesh size {mesh.devices.size}")

        # lane-major device state tables, persisted across frames
        self.states = jnp.full((self.L, self.total_cc, 32), 128,
                               dtype=jnp.uint8)
        self.picture_number = 0
        self._pending = []      # FIFO of in-flight submit_frames records
        # single worker => submits execute in order (the device context
        # chain requires it); the thread lets the host assemble frame k
        # while frame k+1 is uploaded and dispatched.  Uploads run on
        # their own worker so frame k+1's plane transfer proceeds while
        # the dispatch worker waits on frame k's inputs; uploads and
        # result fetches get separate pools so neither queues behind
        # the other
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._upload_pool = ThreadPoolExecutor(max_workers=1)
        self._xfer_pool = ThreadPoolExecutor(max_workers=4)
        self._upchunk_pool = ThreadPoolExecutor(max_workers=4)
        self._last_cap = 0       # speculative output-fetch width
        # range-coder scan for this device and coded width (the CUDA
        # kernel on the GPU, the XLA scan on the CPU)
        self.scan = None if self.golomb else device_scan(
            self.bits, mesh.devices.flat[0] if mesh is not None else None)
        # stream length per slice (static per geometry), padded to what
        # the scan and finalize need (padding pixels are exact no-ops)
        self.stream_lens = [self._stream_len(g) for g in self.geoms]
        self.n_max = -(-max(self.stream_lens) // N_MULTIPLE) * N_MULTIPLE
        # uniform slice grids (all slices identical size, chroma tiles
        # exactly) take the vectorized stencil path: slicing is a pure
        # block reshape and the stencil one vmap per plane type, so the
        # traced program no longer scales with batch x slices (the
        # round-1 per-lane .at[].set loop dominated compile time)
        g0 = self.geoms[0]
        nh, nv = self.rp.num_h_slices, self.rp.num_v_slices
        self.uniform = (
            all(g.width == g0.width and g.height == g0.height
                for g in self.geoms) and
            rp.width % nh == 0 and rp.height % nv == 0 and
            (not rp.chroma_planes or
             (g0.width % (1 << rp.chroma_h_shift) == 0 and
              g0.height % (1 << rp.chroma_v_shift) == 0)))
        if self.rgb and not self.uniform:
            raise NotImplementedError(
                "device RGB path requires a uniform slice grid; use the "
                "host engine otherwise")
        # transfer-size cap for the output byte planes (host re-checks
        # counts; codeable worst case is ~2.2 bytes/pixel at 8 bit for
        # the range coder, (12 + bits)/8 for the Golomb escape path)
        self.out_cap = self.n_max * (4 if self.golomb or self.bits > 10
                                     else 3) + 4096
        # host-compact finalize: carry-resolve on device, segment-copy
        # concatenation in C on the host (native.compact_groups) instead
        # of the device sort network.  OPT-IN (FFV1_TPU_HOSTCOMPACT=1):
        # the uncompacted slab is ~1.6x the sorted payload, so it trades
        # device->host bytes for the sort.  Mesh paths keep the device
        # sort (outputs must stay sharded); bits > 10 uses the s2=6
        # sort finalize.
        from .. import native as _native
        self.host_compact = (mesh is None and not self.golomb and
                             self.fast and _native.available() and
                             os.environ.get("FFV1_TPU_HOSTCOMPACT") == "1")
        self.finalize_ng = self.n_max // 16
        # whole-frame fused pipeline (one dispatch per frame)
        self._frame_fn = (jax.jit(self._frame_pipeline)
                          if (self.fast or self.ext) and not self.golomb
                          else None)

        if self.golomb:
            # device Golomb-Rice path (the reference's default coder,
            # ffv1enc.c:326-367): lane-major VLC/run-mode scan with
            # in-scan bit packing (tpu/golomb_scan.py)
            if not self.uniform:
                raise NotImplementedError(
                    "device Golomb-Rice path requires a uniform slice "
                    "grid; use the host engine otherwise")
            from .golomb_scan import VLC_FRESH, make_flags
            g0 = self.geoms[0]
            dims = [(g0.width, g0.height, 0)]
            if rp.chroma_planes:
                cw = ceil_rshift(g0.width, rp.chroma_h_shift)
                ch = ceil_rshift(g0.height, rp.chroma_v_shift)
                dims += [(cw, ch, 1)] * 2
            if rp.transparency:
                dims.append((g0.width, g0.height,
                             2 if rp.chroma_planes else 1))
            fl = make_flags(dims)
            assert fl.shape[0] == self.stream_lens[0]
            self._gflags = jnp.asarray(np.pad(
                fl, (0, self.n_max - fl.shape[0])))
            fresh = np.array(VLC_FRESH, np.int32)
            self._vlc_fresh = np.tile(
                fresh, (self.L, self.total_cc, 1))
            self.vlc_states = jnp.asarray(self._vlc_fresh)
            self._frame_fn = jax.jit(self._frame_pipeline_golomb)

    # -----------------------------------------------------------------

    def _stream_len(self, geom):
        rp = self.rp
        if self.rgb:
            return geom.width * geom.height * (3 + rp.transparency)
        n = geom.width * geom.height
        if rp.chroma_planes:
            cw = ceil_rshift(geom.width, rp.chroma_h_shift)
            ch = ceil_rshift(geom.height, rp.chroma_v_shift)
            n += 2 * cw * ch
        if rp.transparency:
            n += geom.width * geom.height
        return n

    def _slice_stream(self, planes, geom):
        """Concatenated (ctx, diff) stream for one slice, coding order."""
        rp = self.rp
        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
        parts_ctx, parts_diff = [], []

        def add(plane_arr, state_plane):
            s = load_plane(jnp.asarray(plane_arr), self.bits,
                           rp.packed_at_lsb)
            ctx, diff = residuals_and_contexts(s, self.qt, self.bits,
                                               self.five_input,
                                               qspec=self.qspec)
            parts_ctx.append(ctx.reshape(-1) + state_plane * self.cc)
            parts_diff.append(diff.reshape(-1))

        add(planes[0][y:y + h, x:x + w], 0)
        if rp.chroma_planes:
            cx, cy = x >> hs, y >> vs
            cw, ch = ceil_rshift(w, hs), ceil_rshift(h, vs)
            add(planes[1][cy:cy + ch, cx:cx + cw], 1)
            add(planes[2][cy:cy + ch, cx:cx + cw], 1)
        if rp.transparency:
            add(planes[-1][y:y + h, x:x + w],
                2 if rp.chroma_planes else 1)
        return jnp.concatenate(parts_ctx), jnp.concatenate(parts_diff)

    def _host_prefix_golomb(self, si: int, keyframe: bool,
                            coefs=None) -> bytes:
        """Terminated range-coded slice header for the Golomb path
        (header always range coded; rc terminated after a v3 sentinel
        bit and the bit writer starts at ac_byte_count —
        ffv1enc.c:1176-1183)."""
        from ..core.rac import RangeEncoder
        rp = self.rp
        enc = RangeEncoder(*default_state_tables())
        if si == 0:
            keystate = np.array([128], dtype=np.uint8)
            enc.put_rac(keystate, 0, 1 if keyframe else 0)

        class _SS:
            pass

        ss = _SS()
        ss.geom = self.geoms[si]
        ss.slice_coding_mode = 0
        ss.slice_rct_by_coef, ss.slice_rct_ry_coef = coefs or (1, 1)
        write_slice_header(rp, ss, enc)
        if rp.version > 2:
            sentinel = np.array([129], dtype=np.uint8)
            enc.put_rac(sentinel, 0, 0)
        return enc.terminate()

    def _frame_pipeline_golomb(self, streams, vlc0, prefixes, plens):
        """Fused Golomb-Rice device pipeline: stencil -> VLC/run scan
        with in-scan bit packing -> byte compaction."""
        streams = tuple(
            (jnp.concatenate(p, axis=0) if len(p) > 1 else p[0])
            .reshape(self.batch, -1, p[0].shape[-1])
            if isinstance(p, tuple) else p
            for p in streams)
        ctxs, diffs, acts = self._streams_uniform(streams)
        from .golomb_scan import finalize_bytes, golomb_encode_scan_lanes
        ri0 = jnp.zeros((self.L,), jnp.int32)

        def scanfin(ctxs, diffs, acts, vlc0, ri0, prefixes, plens):
            packed, vlc_out, _ = golomb_encode_scan_lanes(
                ctxs, diffs, acts, self._gflags, vlc0, ri0, self.bits,
                self.cc)
            out, counts = finalize_bytes(packed, prefixes, plens)
            return out, counts, vlc_out

        if self.mesh is not None:
            # slice lanes are independent VLC bitstreams: shard_map with
            # zero collectives, exactly like the range-coder path
            from jax.sharding import PartitionSpec as P
            ax = self.mesh.axis_names[0]
            lane = P(ax)
            out, counts, vlc_out = jax.shard_map(
                scanfin, mesh=self.mesh,
                in_specs=(lane,) * 7, out_specs=(lane, lane, lane),
                check_vma=False)(
                ctxs, diffs, acts, vlc0, ri0, prefixes, plens)
        else:
            out, counts, vlc_out = scanfin(ctxs, diffs, acts, vlc0,
                                           ri0, prefixes, plens)
        return out[:, :self.out_cap], counts, vlc_out

    def _prefix_arrays(self, keyframe: bool):
        """Per-lane host-prefix arrays (keyframe bit + slice headers).
        Static per (geometry, keyframe) — cached, the per-step cost was
        ~10 ms of ProvisionalRangeEncoder work at 24 slices."""
        cache = getattr(self, "_prefix_cache", None)
        if cache is None:
            cache = self._prefix_cache = {}
        if keyframe not in cache:
            lows = np.zeros(self.L, np.int32)
            ranges = np.zeros(self.L, np.int32)
            prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
            plens = np.zeros(self.L, np.int32)
            for si in range(self.n_slices):
                lo, ra, prov = self._host_prefix(si, keyframe)
                for bi in range(self.batch):
                    lane = bi * self.n_slices + si
                    lows[lane], ranges[lane] = lo, ra
                    prefixes[lane, :len(prov)] = prov
                    plens[lane] = len(prov)
            cache[keyframe] = (lows, ranges, prefixes, plens)
        return cache[keyframe]

    def _host_prefix(self, si: int, keyframe: bool, coefs=None):
        rp = self.rp
        enc = ProvisionalRangeEncoder(*default_state_tables())
        if si == 0:
            keystate = np.array([128], dtype=np.uint8)
            enc.put_rac(keystate, 0, 1 if keyframe else 0)
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            enc.set_tables(*custom_state_tables(rp.state_transition))

        class _SS:
            pass

        ss = _SS()
        ss.geom = self.geoms[si]
        ss.slice_coding_mode = 0
        ss.slice_rct_by_coef, ss.slice_rct_ry_coef = coefs or (1, 1)
        write_slice_header(rp, ss, enc)
        return enc.low, enc.range, enc.prov

    def _prefix_arrays_rct(self, keyframe: bool, coefs):
        """Per-lane prefix arrays with per-slice searched RCT
        coefficients (v4) — headers differ per lane AND per frame, so
        nothing is cached.  ``coefs``: list of (by, ry) per lane."""
        lows = np.zeros(self.L, np.int32)
        ranges = np.zeros(self.L, np.int32)
        prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
        plens = np.zeros(self.L, np.int32)
        for lane in range(self.L):
            si = lane % self.n_slices
            lo, ra, prov = self._host_prefix(si, keyframe, coefs[lane])
            lows[lane], ranges[lane] = lo, ra
            prefixes[lane, :len(prov)] = prov
            plens[lane] = len(prov)
        return lows, ranges, prefixes, plens

    def _rct_coefs_host(self, streams_np):
        """Host-pixel fallback search for the non-fused paths (slow,
        Golomb): byte-identical to the host engine's choose_rct_params
        call (codec/encoder.py), per lane."""
        from ..codec.rct import choose_rct_params
        out = []
        for bi in range(self.batch):
            planes = streams_np[bi]
            for geom in self.geoms:
                crops = [p[geom.y:geom.y + geom.height,
                           geom.x:geom.x + geom.width]
                         for p in planes[:3]]
                out.append(choose_rct_params(crops, False))
        return out

    # -----------------------------------------------------------------

    def _crops_uniform(self, stack, nh, nv):
        """(B, H, W) -> (B*nv*nh, H/nv, W/nh) slice crops, lane order
        bi*n_slices + sy*nh + sx — a pure block reshape (zero copies
        beyond XLA's layout pass) valid only for uniform grids."""
        B, H, W = stack.shape
        h, w = H // nv, W // nh
        c = stack.reshape(B, nv, h, nh, w)
        return jnp.transpose(c, (0, 1, 3, 2, 4)).reshape(B * nv * nh,
                                                         h, w)

    def _streams_uniform(self, streams, rct=None):
        """Vectorized (ctx, diff) lane streams for uniform slice grids:
        one vmapped stencil per plane type instead of batch x slices
        traced instances.  ``rct``: optional per-lane (by, ry) int32
        arrays for the v4 searched RCT coefficients (RGB only)."""
        rp = self.rp
        nh, nv = rp.num_h_slices, rp.num_v_slices

        if self.rgb:
            return self._streams_uniform_rgb(streams, rct)

        def stencil(img):
            s = load_plane(img, self.bits, rp.packed_at_lsb)
            c, d = residuals_and_contexts(s, self.qt, self.bits,
                                          self.five_input,
                                          qspec=self.qspec)
            return c.reshape(-1), d.reshape(-1)

        parts_ctx, parts_diff = [], []

        def add(stack, state_plane):
            crops = self._crops_uniform(stack, nh, nv)
            c, d = jax.vmap(stencil)(crops)
            parts_ctx.append(c + state_plane * self.cc)
            parts_diff.append(d)

        add(streams[0], 0)
        if rp.chroma_planes:
            add(streams[1], 1)
            add(streams[2], 1)
        if rp.transparency:
            # ya8 codes alpha on state plane 1 (no chroma planes
            # between, ffv1enc.c:1196); yuva formats on plane 2
            add(streams[-1], 2 if rp.chroma_planes else 1)
        ctxs = jnp.concatenate(parts_ctx, axis=1)
        diffs = jnp.concatenate(parts_diff, axis=1)
        n = ctxs.shape[1]
        assert n == self.stream_lens[0]
        ctxs = jnp.pad(ctxs, ((0, 0), (0, self.n_max - n)))
        diffs = jnp.pad(diffs, ((0, 0), (0, self.n_max - n)))
        acts_np = np.zeros((self.L, self.n_max), bool)
        acts_np[:, :n] = True
        return ctxs, diffs, jnp.asarray(acts_np)

    def _split_rgb(self, streams):
        """streams -> (b, g, r, a|None) int32 full frames, matching the
        reference's plane binding (plane 0 -> "b", ffv1enc.c:441-444;
        packed bgra channel order ffv1enc.c:433-439)."""
        rp = self.rp
        if rp.fmt.interleaved:
            # packed bgra/bgr0: uploaded as (B, H, W*4) uint8 rows
            x = streams[0].reshape(self.batch, rp.height, rp.width, 4) \
                .astype(jnp.int32)
            b, g, r = x[..., 0], x[..., 1], x[..., 2]
            a = x[..., 3] if rp.transparency else None
        else:
            # planar gbrp: the reference reads plane 0 into its "b"
            # variable and plane 1 into "g" (ffv1enc.c:441-444) — the
            # coded order is reproduced operationally, matching the
            # host engine (codec/slice_codec.py encode_rgb_frame)
            b = streams[0].astype(jnp.int32)
            g = streams[1].astype(jnp.int32)
            r = streams[2].astype(jnp.int32)
            a = streams[3].astype(jnp.int32) if rp.transparency else None
        return b, g, r, a

    def _streams_uniform_rgb(self, streams, rct=None):
        """(ctx, diff) lane streams for RGB (colorspace=1).

        Coding order interleaves planes per ROW — for each y the G, B,
        R(, A) lines are coded in sequence (ffv1enc.c:428-470) — so the
        per-plane stencil outputs are stacked on a row-interior axis
        before flattening.  With the fixed v<=3 coefficients the RCT
        runs on the full frame before slice cropping (pixel-local, so
        slice-equivalent); with v4 searched coefficients (``rct`` =
        per-lane (by, ry) arrays) it runs per slice crop instead."""
        rp = self.rp
        nh, nv = rp.num_h_slices, rp.num_v_slices
        b, g, r, a = self._split_rgb(streams)
        offs = [0, self.cc, self.cc, 2 * self.cc]

        def stencil(img):
            return residuals_and_contexts(img, self.qt, self.bits,
                                          self.five_input,
                                          qspec=self.qspec)

        if rct is None:
            g, b, r = rct_transform(g, b, r, self.raw_bits)
            plane_crops = [self._crops_uniform(p, nh, nv)
                           for p in [g, b, r] + ([a] if a is not None
                                                 else [])]
        else:
            by_l, ry_l = rct
            gc, bc, rc_ = (self._crops_uniform(p, nh, nv)
                           for p in (g, b, r))
            gc, bc, rc_ = jax.vmap(
                lambda g_, b_, r_, by_, ry_: rct_transform(
                    g_, b_, r_, self.raw_bits, by_, ry_))(
                gc, bc, rc_, by_l, ry_l)
            plane_crops = [gc, bc, rc_] + \
                ([self._crops_uniform(a, nh, nv)] if a is not None
                 else [])

        ctx_p, diff_p = [], []
        for p_i, crops in enumerate(plane_crops):         # (L, h, w)
            c, d = jax.vmap(stencil)(crops)               # (L, h, w)
            ctx_p.append(c + offs[p_i])
            diff_p.append(d)
        ctxs = jnp.stack(ctx_p, axis=2).reshape(self.L, -1)
        diffs = jnp.stack(diff_p, axis=2).reshape(self.L, -1)
        n = ctxs.shape[1]
        assert n == self.stream_lens[0]
        ctxs = jnp.pad(ctxs, ((0, 0), (0, self.n_max - n)))
        diffs = jnp.pad(diffs, ((0, 0), (0, self.n_max - n)))
        acts_np = np.zeros((self.L, self.n_max), bool)
        acts_np[:, :n] = True
        return ctxs, diffs, jnp.asarray(acts_np)

    def _rct_pairs(self, streams):
        """Device half of the v4 RCT search: per-lane (15, 2) exact
        cost-sum pairs (tpu/rct_search.py) over the slice crops of the
        b/g/r planes — YUV reads planes 0/1/2 the same way the
        reference's unguarded call does (ffv1enc.c:1163-1164)."""
        rp = self.rp
        streams = tuple(
            (jnp.concatenate(p, axis=0) if len(p) > 1 else p[0])
            .reshape(self.batch, -1, p[0].shape[-1])
            if isinstance(p, tuple) else p
            for p in streams)
        if self.rgb:
            b, g, r, _a = self._split_rgb(streams)
        else:
            b = streams[0].astype(jnp.int32)
            g = streams[1].astype(jnp.int32)
            r = streams[2].astype(jnp.int32)
        from .rct_search import rct_cost_pairs_lanes
        nh, nv = rp.num_h_slices, rp.num_v_slices
        return rct_cost_pairs_lanes(
            self._crops_uniform(b, nh, nv),
            self._crops_uniform(g, nh, nv),
            self._crops_uniform(r, nh, nv))

    def _rct_search_device(self, streams):
        """Run the jitted device search and pick the winning (by, ry)
        per lane on the host (int64 recombine + first-wins argmin)."""
        fn = getattr(self, "_rct_fn", None)
        if fn is None:
            fn = self._rct_fn = jax.jit(self._rct_pairs)
        from .rct_search import pick_rct_coefs
        return pick_rct_coefs(np.asarray(fn(streams)))

    def _frame_pipeline(self, streams, states0, lows, ranges, prefixes,
                        plens, rct=None):
        """Fused device pipeline: stencil -> lane scan -> finalize.

        ``streams``: tuple of per-plane arrays stacked over the batch —
        each entry either (batch, Hk, Wk) or a tuple of row-band chunks
        of its (batch*Hk, Wk) flattening (chunked-concurrent upload).
        ``rct``: optional per-lane (by, ry) coefficient arrays (v4 RGB).
        Lane index = stream * n_slices + slice.
        """
        streams = tuple(
            (jnp.concatenate(p, axis=0) if len(p) > 1 else p[0])
            .reshape(self.batch, -1, p[0].shape[-1])
            if isinstance(p, tuple) else p
            for p in streams)
        if self.uniform:
            ctxs, diffs, acts = self._streams_uniform(streams, rct)
        else:
            ctxs = jnp.zeros((self.L, self.n_max), jnp.int32)
            diffs = jnp.zeros((self.L, self.n_max), jnp.int32)
            acts_np = np.zeros((self.L, self.n_max), bool)
            per_stream = tuple(
                tuple(p[bi] for p in streams) for bi in range(self.batch))
            for bi, planes in enumerate(per_stream):
                for si, geom in enumerate(self.geoms):
                    lane = bi * self.n_slices + si
                    c, d = self._slice_stream(planes, geom)
                    n = self.stream_lens[si]
                    ctxs = ctxs.at[lane, :n].set(c)
                    diffs = diffs.at[lane, :n].set(d)
                    acts_np[lane, :n] = True
            acts = jnp.asarray(acts_np)

        out, counts, states_out, overflow, packed, low, rng = \
            self._scan_finalize(ctxs, diffs, acts, states0, lows,
                                ranges, prefixes, plens)
        # version-4 budget semantics (ffv1enc.c:283-287 + :1207-1217):
        # provisional emission counts at each coded-line start, so the
        # host can run the reference's remaining-budget < w*35 check and
        # retry failing slices as PCM.  Tiny (rows x L) device->host
        # fetch; versions <= 3 skip it (they hard-error on overflow).
        if self.rp.version > 3 and self.uniform:
            offs = np.array([o for o, _w in
                             self._row_offsets(self.geoms[0])], np.int32)
            per_px = jnp.sum((packed >> 20) & 1, axis=1)     # (N, L)
            cum = jnp.cumsum(per_px, axis=0)
            gathered = cum[jnp.maximum(offs - 1, 0)]         # (R, L)
            rowbytes = jnp.where(offs[:, None] == 0, 0, gathered)
        else:
            rowbytes = jnp.zeros((0, self.L), jnp.int32)
        # pack per-lane count (4 LE bytes) + overflow flag ahead of the
        # payload bytes so ONE speculative slab fetch returns everything
        # the host needs
        if self.host_compact:
            out2 = out              # hostcompact slab carries its head
        else:
            head = jnp.stack(
                [(counts >> sh) & 0xFF for sh in (0, 8, 16, 24)] +
                [overflow.astype(jnp.int32)], axis=1).astype(jnp.uint8)
            out2 = jnp.concatenate([head, out[:, :self.out_cap]], axis=1)
        return out2, counts, states_out, overflow, \
            packed, low, rng, rowbytes

    def _scan_finalize(self, ctxs, diffs, acts, states0, lows, ranges,
                       prefixes, plens, bits=None, hostcompact=None):
        """Lane scan + finalize, optionally shard_mapped over the mesh.
        Shared by the intra pipeline and the P-frame pipeline
        (pframe/tpu.py, which codes at bits + 1 — the ``bits``
        override)."""
        bits = self.bits if bits is None else bits
        scan = device_scan(bits, self.mesh.devices.flat[0]
                           if self.mesh is not None else None)
        if hostcompact is None:
            hostcompact = self.host_compact and bits <= 10 and \
                self.mesh is None
        # carry resolution runs over the uncompacted slot stream
        # (invalid slots are neutral propagators), per-pixel slot
        # compaction via masked reductions, and the final compaction is
        # a single-operand key|byte sort — see finalize_packed.
        # Overflow (a pixel emitted > s2 bytes; unobserved even on
        # full-range noise) makes the host redo the frame full-width.
        s2 = 4 if bits <= 10 else 6

        def scanfin(ctxs, diffs, acts, states0, lows, ranges, prefixes,
                    plens):
            packed, low, rng, states_out = rc_encode_packed(
                scan, ctxs, diffs, acts, states0, self.one_tab,
                self.zero_tab, lows, ranges, bits)
            if hostcompact:
                out, counts, overflow = finalize_packed_hostcompact(
                    packed, low, rng, prefixes, plens)
            else:
                out, counts, overflow = finalize_packed(
                    packed, low, rng, prefixes, plens, s2=s2)
            return out, counts, states_out, overflow, packed, low, rng

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P
            ax = self.mesh.axis_names[0]
            lane = P(ax)
            out, counts, states_out, overflow, packed, low, rng = \
                jax.shard_map(
                    scanfin, mesh=self.mesh,
                    in_specs=(lane,) * 3 + (lane,) * 5,
                    out_specs=(lane, lane, lane, lane,
                               P(None, None, ax), lane, lane),
                    # FFI out_shapes carry no vma metadata; the
                    # outputs are plainly lane-sharded (zero
                    # collectives), so the vma lint is safely off
                    check_vma=False)(
                    ctxs, diffs, acts, states0, lows, ranges,
                    prefixes, plens)
        else:
            out, counts, states_out, overflow, packed, low, rng = \
                scanfin(ctxs, diffs, acts, states0, lows, ranges,
                        prefixes, plens)
        return out, counts, states_out, overflow, packed, low, rng

    def _assemble(self, payloads):
        rp = self.rp
        out = bytearray()
        for payload in payloads:
            chunk = bytearray(payload)
            chunk += len(payload).to_bytes(3, "big")
            if rp.ec:
                chunk.append(0)
                chunk += int(crc32_ieee(bytes(chunk))).to_bytes(4, "little")
            out += chunk
        return bytes(out)

    def reset(self):
        """Flush analog (avcodec_flush_buffers, libavcodec/utils.c):
        drop all stream state so the next frame starts a fresh GOP.
        Compiled pipelines are retained — a reset instance re-encodes
        without recompiling (cheap stream switching / seek support)."""
        assert not self._pending, \
            "collect in-flight frames before reset()"
        self.states = jnp.full((self.L, self.total_cc, 32), 128,
                               dtype=jnp.uint8)
        if self.golomb:
            self.vlc_states = jnp.asarray(self._vlc_fresh)
        self.picture_number = 0
        self._last_cap = 0

    def encode_frame(self, planes):
        """Encode one frame of a single stream (batch must be 1)."""
        assert self.batch == 1
        return self.encode_frames([planes])[0]

    def encode_frames(self, streams):
        """Encode one frame from each of ``batch`` independent streams;
        returns a list of (packet, keyframe) per stream."""
        self.submit_frames(streams)
        return self.collect_frames()

    def submit_frames(self, streams):
        """Async half of encode_frames: upload the planes and dispatch
        the fused device pipeline without waiting for it.  Pair each
        submit with a later collect_frames(); one frame may be in
        flight while the host assembles the previous one (the device
        context chain for P-frames stays on-device, so GOP semantics
        are unaffected by the overlap).  Mirrors the reference's frame
        pipeline (pthread_frame.c submit_packet/frame_worker_thread)
        in the XLA async-dispatch idiom.  The upload + device dispatch
        run on a dedicated worker thread, so the caller's thread is free
        to assemble the previous frame."""
        rp = self.rp
        assert len(streams) == self.batch
        streams_np = tuple(
            tuple(np.asarray(p)
                  for p in (s if isinstance(s, (list, tuple)) else [s]))
            for s in streams)
        if self.ya:
            # split the (H, W, 2) interleaved storage into the luma +
            # alpha plane pair the planar pipeline codes
            streams_np = tuple(
                (np.ascontiguousarray(s[0][..., 0]),
                 np.ascontiguousarray(s[0][..., 1]))
                for s in streams_np)
        keyframe = (rp.gop_size == 0 or
                    self.picture_number % rp.gop_size == 0)

        if self.golomb:
            self._submit_golomb(streams_np, keyframe)
            self.picture_number += 1
            return

        if self.rct_search and (self.fast or self.ext):
            # v4 searched headers depend on the pixels: built inside
            # the worker (after upload) from the device search
            lows = ranges = prefixes = plens = None
        elif self.rct_search:
            coefs = self._rct_coefs_host(streams_np)
            lows, ranges, prefixes, plens = \
                self._prefix_arrays_rct(keyframe, coefs)
        else:
            lows, ranges, prefixes, plens = self._prefix_arrays(keyframe)

        if self.fast or self.ext:
            def upload():
                # one host->device transfer per plane, issued
                # concurrently
                nplanes = len(streams_np[0])
                futs = [self._upchunk_pool.submit(
                    lambda k=k: jnp.asarray(
                        np.stack([s[k] for s in streams_np]))
                    .block_until_ready())
                    for k in range(nplanes)]
                return tuple(f.result() for f in futs)

            up_fut = self._upload_pool.submit(upload)
            self._submit_fast(up_fut, streams_np, keyframe, lows,
                              ranges, prefixes, plens)
            self.picture_number += 1
            return

        states0 = jnp.full_like(self.states, 128) if keyframe else \
            self.states
        payloads = self._encode_slow(streams_np, states0, lows, ranges,
                                     prefixes, plens)
        self._pending.append(dict(payloads=payloads, keyframe=keyframe))
        self.picture_number += 1

    def submit_device_frames(self, planes):
        """Async submit for a DEVICE-RESIDENT source: ``planes`` is a
        tuple of per-plane (batch, Hk, Wk) arrays already on the
        device — the output of a device filtergraph stage, a decode
        step, or any other on-device producer.  The host->device plane
        upload is skipped entirely; only the compressed payload crosses
        the link.  v4 runs fully device-side too: the RCT search reads
        the staged planes (uniform grids), and the rare PCM overflow
        retry fetches the failing stream's planes back from HBM."""
        if self.golomb or not (self.fast or self.ext):
            raise NotImplementedError(
                "device-source submit requires the fused device "
                "pipeline (range coder, uniform geometry)")
        if self.rct_search and not self.uniform:
            raise NotImplementedError(
                "device-source v4 search needs a uniform slice grid "
                "(the non-uniform search reads host pixels)")
        keyframe = (self.rp.gop_size == 0 or
                    self.picture_number % self.rp.gop_size == 0)
        if self.rct_search:
            # built inside the worker from the on-device search
            lows = ranges = prefixes = plens = None
        else:
            lows, ranges, prefixes, plens = \
                self._prefix_arrays(keyframe)
        from concurrent.futures import Future
        up_fut = Future()
        up_fut.set_result(tuple(planes))
        self._submit_fast(up_fut, None, keyframe, lows, ranges,
                          prefixes, plens)
        self.picture_number += 1

    def _submit_fast(self, up_fut, streams_np, keyframe, lows, ranges,
                     prefixes, plens):
        def work():
            # runs on the single-worker executor: submits are
            # processed strictly in order, so reading/advancing
            # self.states here keeps the GOP context chain intact
            nonlocal lows, ranges, prefixes, plens
            with phase_timer("tpu-enc", "wait-upload"):
                streams = up_fut.result()
            rct = None
            if self.rct_search:
                # v4: device candidate search -> (L,) winners on host
                # -> per-frame slice headers; the RGB pipeline also
                # consumes the coefficients in its per-slice RCT.
                # Non-uniform grids (YUV only; RGB requires uniform)
                # search on the host pixels instead — _crops_uniform
                # cannot express their geometry
                with phase_timer("tpu-enc", "rct-search"):
                    coefs = (self._rct_search_device(streams)
                             if self.uniform
                             else self._rct_coefs_host(streams_np))
                    lows, ranges, prefixes, plens = \
                        self._prefix_arrays_rct(keyframe, coefs)
                if self.rgb:
                    rct = (jnp.asarray([c[0] for c in coefs],
                                       jnp.int32),
                           jnp.asarray([c[1] for c in coefs],
                                       jnp.int32))
            states0 = jnp.full_like(self.states, 128) if keyframe \
                else self.states
            with phase_timer("tpu-enc", "dispatch"):
                (out, counts, states_out, overflow, packed, low,
                 rng, rowbytes) = self._frame_fn(
                    streams, states0, jnp.asarray(lows),
                    jnp.asarray(ranges), jnp.asarray(prefixes),
                    jnp.asarray(plens), rct=rct)
            self.states = states_out
            # issue the result transfer NOW, before the next
            # frame's scan is enqueued: device ops run in order, so
            # a fetch submitted at collect time would wait behind
            # every queued scan.  ONE slab fetch carries counts +
            # overflow (the 5-byte head packed by the pipeline) +
            # the speculative payload width.
            if self.host_compact:
                spec = -1          # full static hostcompact slab
                slab_fut = self._xfer_pool.submit(
                    lambda: np.asarray(out))
            else:
                spec = min(self._last_cap, self.out_cap)
                slab_fut = self._xfer_pool.submit(
                    lambda: np.asarray(out[:, :5 + spec]))
            rowbytes_fut = (self._xfer_pool.submit(
                lambda: np.asarray(rowbytes))
                if rowbytes.shape[0] else None)
            return dict(
                out=out, counts=counts, overflow=overflow,
                packed=packed, low=low, rng=rng, keyframe=keyframe,
                streams=streams, states0=states0, lows=lows,
                ranges=ranges, prefixes=prefixes, plens=plens,
                streams_np=streams_np, slab_fut=slab_fut,
                rowbytes_fut=rowbytes_fut, spec=spec)

        self._pending.append(self._executor.submit(work))

    def _submit_golomb(self, streams_np, keyframe: bool):
        if self.rct_search:
            # v4 searched headers are pixel- and lane-dependent: build
            # fresh each frame from the host search (non-headline path)
            coefs = self._rct_coefs_host(streams_np)
            prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
            plens = np.zeros(self.L, np.int32)
            for lane in range(self.L):
                pb = self._host_prefix_golomb(lane % self.n_slices,
                                              keyframe, coefs[lane])
                prefixes[lane, :len(pb)] = np.frombuffer(pb, np.uint8)
                plens[lane] = len(pb)
        else:
            cache = getattr(self, "_gprefix_cache", None)
            if cache is None:
                cache = self._gprefix_cache = {}
            if keyframe not in cache:
                prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
                plens = np.zeros(self.L, np.int32)
                for si in range(self.n_slices):
                    pb = self._host_prefix_golomb(si, keyframe)
                    for bi in range(self.batch):
                        lane = bi * self.n_slices + si
                        prefixes[lane, :len(pb)] = np.frombuffer(
                            pb, np.uint8)
                        plens[lane] = len(pb)
                cache[keyframe] = (prefixes, plens)
            prefixes, plens = cache[keyframe]

        def upload():
            nplanes = len(streams_np[0])
            return tuple(
                jnp.asarray(np.stack([s[k] for s in streams_np]))
                for k in range(nplanes))

        up_fut = self._upload_pool.submit(upload)

        def work():
            streams = up_fut.result()
            vlc0 = jnp.asarray(self._vlc_fresh) if keyframe \
                else self.vlc_states
            out, counts, vlc_out = self._frame_fn(
                streams, vlc0, jnp.asarray(prefixes),
                jnp.asarray(plens))
            self.vlc_states = vlc_out
            # pre-issue result transfers (see the range-coder work())
            counts_fut = self._xfer_pool.submit(
                lambda: np.asarray(counts))
            spec = min(self._last_cap, self.out_cap)
            spec_fut = (self._xfer_pool.submit(
                lambda: np.asarray(out[:, :spec])) if spec else None)
            return dict(out=out, counts=counts, keyframe=keyframe,
                        golomb=True, counts_fut=counts_fut,
                        spec_fut=spec_fut, spec=spec)

        self._pending.append(self._executor.submit(work))

    def collect_frames(self):
        """Sync half of encode_frames: wait for the in-flight device
        pipeline, fetch the byte planes, and assemble packets."""
        assert self._pending, "no submit_frames() in flight"
        p = self._pending.pop(0)
        if not isinstance(p, dict):
            with phase_timer("tpu-enc", "wait-worker"):
                p = p.result()      # worker-thread future (fast path)
        keyframe = p["keyframe"]
        if "payloads" in p:
            payloads = p["payloads"]
        elif p.get("golomb"):
            counts_np = np.asarray(p["counts_fut"].result())
            if counts_np.max() > self.out_cap:
                raise RuntimeError("encoded slice exceeded output cap")
            cap2 = min(self.out_cap,
                       (int(counts_np.max()) + 511) // 512 * 512)
            self._last_cap = min(self.out_cap, cap2 + 2048)
            if p["spec_fut"] is not None and p["spec"] >= cap2:
                out_np = p["spec_fut"].result()[:, :cap2]
            else:
                if p["spec_fut"] is not None:
                    p["spec_fut"].result()   # drain the partial fetch
                out_np = np.asarray(p["out"][:, :cap2])
            payloads = [bytes(out_np[li, :counts_np[li]])
                        for li in range(self.L)]
        else:
            out, counts = p["out"], p["counts"]
            spec = p["spec"]
            redone = None
            with phase_timer("tpu-enc", "slab-fetch"):
                slab = p["slab_fut"].result()       # (L, 5 + spec)
            counts_np = (slab[:, 0].astype(np.int64) |
                         (slab[:, 1].astype(np.int64) << 8) |
                         (slab[:, 2].astype(np.int64) << 16) |
                         (slab[:, 3].astype(np.int64) << 24))
            if bool((slab[:, 4] & 1).astype(bool).any()):
                # rare: some pixel emitted > 4 bytes (or a 16-px group
                # > 24): finalize the raw slots at full width
                redone, counts = finalize_packed_full(
                    p["packed"], p["low"], p["rng"],
                    jnp.asarray(p["prefixes"]), jnp.asarray(p["plens"]))
                redone = redone[:, :self.out_cap]
                counts_np = np.asarray(counts).astype(np.int64)
            pcm_lanes = []
            if p.get("rowbytes_fut") is not None:
                # reference budget check per coded line (the
                # _encode_slow path's loop, now device-assisted):
                # remaining slice budget < w*35 at any line start =>
                # the slice retries as PCM (ffv1enc.c:283-287,
                # :1207-1217)
                rb = p["rowbytes_fut"].result()          # (R, L)
                budget = self._slice_budget()
                rows = self._row_offsets(self.geoms[0])
                wrows = np.array([w for _o, w in rows], np.int32)
                plens_v = p["plens"]
                rem = budget - (plens_v[None, :] + rb)   # (R, L)
                bad = (rem < wrows[:, None] * 35).any(axis=0)
                if bad.any():
                    if self._pending:
                        raise RuntimeError(
                            "PCM fallback with frames in flight would "
                            "corrupt the GOP context chain; use "
                            "encode_frames() (depth-1) for v4 content "
                            "that may overflow")
                    pcm_lanes = [int(li) for li in np.nonzero(bad)[0]]
                    for li in pcm_lanes:
                        counts_np[li] = 0
            if counts_np.max() > self.out_cap:
                # reference semantics: version-4 range-coder slices retry
                # as PCM on buffer overflow (ffv1enc.c:1207-1217); other
                # versions hard-error ("Buffer too small", :1210-1212)
                if self.rp.version <= 3:
                    raise RuntimeError(
                        "encoded slice exceeded output cap (the "
                        "reference errors here too: ffv1enc.c:1210)")
                if self._pending:
                    raise RuntimeError(
                        "PCM fallback with frames in flight would "
                        "corrupt the GOP context chain; use "
                        "encode_frames() (depth-1) for v4 content "
                        "that may overflow")
                pcm_lanes = [int(li) for li in
                             np.nonzero(counts_np > self.out_cap)[0]]
                for li in pcm_lanes:
                    counts_np[li] = 0      # fetched below, then replaced
            cap2 = min(self.out_cap,
                       (int(counts_np.max()) + 511) // 512 * 512)
            self._last_cap = min(self.out_cap, cap2 + 4096)
            with phase_timer("tpu-enc", "payload-fetch"):
                if redone is not None:
                    out_np = np.asarray(redone[:, :cap2])
                elif spec < 0:
                    # hostcompact slab: [head 5 | gcounts NG | resolved
                    # pcap + NG*24 + 3]; the C segment copier packs the
                    # valid bytes (native.compact_groups)
                    from .. import native as _native
                    ng = self.finalize_ng
                    gcounts = slab[:, 5:5 + ng]
                    resolved = slab[:, 5 + ng:]
                    out_np = _native.compact_groups(
                        resolved, gcounts, p["plens"], counts_np,
                        PREFIX_CAP, 24)
                elif spec >= cap2:
                    out_np = slab[:, 5:5 + cap2]
                else:
                    tail = np.asarray(out[:, 5 + spec:5 + cap2])
                    out_np = np.concatenate([slab[:, 5:], tail], axis=1)
            payloads = [bytes(out_np[li, :counts_np[li]])
                        for li in range(self.L)]
            fetched_streams = {}
            for li in pcm_lanes:
                bi, si = divmod(li, self.n_slices)
                if p["streams_np"] is not None:
                    planes_np = p["streams_np"][bi]
                else:
                    # device-source submit: the planes live in HBM —
                    # fetch the failing STREAM's planes once (PCM retry
                    # is the rare overflow path, ffv1enc.c:1207-1217)
                    if bi not in fetched_streams:
                        fetched_streams[bi] = tuple(
                            np.asarray(pl[bi]) for pl in p["streams"])
                    planes_np = fetched_streams[bi]
                payloads[li] = self._encode_slice_pcm(
                    si, planes_np, keyframe)
                # a PCM slice header carries slice_reset_contexts=1 and
                # clears contexts on both sides (ffv1enc.c:1054-1056,
                # ffv1dec.c:419-420)
                self.states = self.states.at[li].set(128)

        results = []
        for bi in range(self.batch):
            sl = payloads[bi * self.n_slices:(bi + 1) * self.n_slices]
            results.append((self._assemble(sl), keyframe))
        return results

    def _slice_budget(self) -> int:
        """Per-slice output budget, reference-identical: the packet is
        allocated at 16384 + w*h*12 bytes for version 4 (ffv1enc.c:
        1281-1282 with AV_INPUT_BUFFER_MIN_SIZE) and carved evenly
        across slices (ffv1enc.c:1306-1311)."""
        rp = self.rp
        per_px = 12 if rp.version > 3 else 140
        return (16384 + rp.width * rp.height * per_px) // self.n_slices

    def _row_offsets(self, geom):
        """(stream_offset, row_width) of every coded line of a slice, in
        coding order — the points where the reference checks its
        remaining-buffer budget (encode_line, ffv1enc.c:283-287)."""
        rp = self.rp
        out = []
        pos = 0

        def plane(w, h):
            nonlocal pos
            for _ in range(h):
                out.append((pos, w))
                pos += w

        plane(geom.width, geom.height)
        if rp.chroma_planes:
            cw = ceil_rshift(geom.width, rp.chroma_h_shift)
            ch = ceil_rshift(geom.height, rp.chroma_v_shift)
            plane(cw, ch)
            plane(cw, ch)
        if rp.transparency:
            plane(geom.width, geom.height)
        return out

    def _encode_slice_pcm(self, si: int, planes_np, keyframe: bool) \
            -> bytes:
        """Re-encode one slice in PCM mode (slice_coding_mode=1) on the
        host — the reference's buffer-overflow retry (ffv1enc.c:
        1207-1217).  Raw samples ride fresh 128-states through the
        range coder (ffv1enc.c:294-303); adaptive contexts are neither
        read nor advanced, so the caller must keep the lane's device
        states at their pre-frame values."""
        from ..codec.context import alloc_slice_state
        from ..codec.slice_codec import encode_plane, encode_rgb_frame
        from ..core.rac import RangeEncoder
        rp = self.rp
        geom = self.geoms[si]
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            slice_tables = custom_state_tables(rp.state_transition)
        else:
            slice_tables = default_state_tables()
        if si == 0:
            rc = RangeEncoder(*default_state_tables())
            keystate = np.array([128], dtype=np.uint8)
            rc.put_rac(keystate, 0, 1 if keyframe else 0)
            if rp.ac == T.AC_RANGE_CUSTOM_TAB:
                rc.set_tables(*slice_tables)
        else:
            rc = RangeEncoder(*slice_tables)
        ss = alloc_slice_state(rp, geom)
        ss.slice_coding_mode = 1
        write_slice_header(rp, ss, rc)

        coder = (rc, None)
        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        bits = self.raw_bits
        if rp.colorspace == 1:
            if rp.fmt.interleaved:
                sp = planes_np[0][y:y + h, x:x + w]
            else:
                sp = [p[y:y + h, x:x + w] for p in planes_np]
            encode_rgb_frame(rp, ss, coder, sp, w, h)
        else:
            encode_plane(rp, ss, coder, planes_np[0][y:y + h, x:x + w],
                         w, h, 0, bits)
            if rp.chroma_planes:
                hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
                cx, cy = x >> hs, y >> vs
                cw, ch = ceil_rshift(w, hs), ceil_rshift(h, vs)
                encode_plane(rp, ss, coder,
                             planes_np[1][cy:cy + ch, cx:cx + cw],
                             cw, ch, 1, bits)
                encode_plane(rp, ss, coder,
                             planes_np[2][cy:cy + ch, cx:cx + cw],
                             cw, ch, 1, bits)
            if rp.transparency:
                encode_plane(rp, ss, coder,
                             planes_np[-1][y:y + h, x:x + w],
                             w, h, 2, bits)
        sentinel = np.array([129], dtype=np.uint8)
        rc.put_rac(sentinel, 0, 0)
        return rc.terminate()

    def _encode_slow(self, streams, states0, lows, ranges, prefixes,
                     plens):
        planes = list(streams[0])
        assert self.batch == 1
        # naive per-slice path (bit depths > 10)
        ctxs = jnp.zeros((self.L, self.n_max), jnp.int32)
        diffs = jnp.zeros((self.L, self.n_max), jnp.int32)
        acts = np.zeros((self.L, self.n_max), bool)
        for si, geom in enumerate(self.geoms):
            c, d = self._slice_stream(planes, geom)
            n = self.stream_lens[si]
            ctxs = ctxs.at[si, :n].set(c)
            diffs = diffs.at[si, :n].set(d)
            acts[si, :n] = True
        keyframe = (self.rp.gop_size == 0 or
                    self.picture_number % self.rp.gop_size == 0)
        budget = self._slice_budget()
        payloads = []
        new_states = []
        for si in range(self.L):
            n = self.stream_lens[si]
            prov, valid, low, rng, s_out = rc_encode_scan(
                ctxs[si, :n], diffs[si, :n], jnp.asarray(acts[si, :n]),
                states0[si], self.one_tab, self.zero_tab,
                jnp.int32(lows[si]), jnp.int32(ranges[si]), self.bits)
            # reference overflow semantics: at each line start, remaining
            # slice-buffer bytes must cover w*35 (ffv1enc.c:283-287) or
            # the slice retries as PCM (version 4, range coder;
            # ffv1enc.c:1207-1217).  Positions are tracked in provisional
            # emissions (equal to flushed bytes up to the outstanding-
            # byte lag, immaterial at these margins).
            overflow = False
            if self.rp.version > 3:
                per_px = np.asarray(valid).sum(axis=1)
                cum = np.concatenate([[0], np.cumsum(per_px)])
                pos0 = int(plens[si])
                for off, wrow in self._row_offsets(self.geoms[si]):
                    if budget - (pos0 + int(cum[off])) < wrow * 35:
                        overflow = True
                        break
            if overflow:
                payloads.append(self._encode_slice_pcm(
                    si, planes, keyframe))
                # a PCM slice header carries slice_reset_contexts=1 and
                # clears the encoder's contexts (ffv1enc.c:1054-1056;
                # decoder mirror ffv1dec.c:419-420)
                new_states.append(jnp.full_like(states0[si], 128))
                continue
            new_states.append(s_out)
            o, cnt = finalize_slice(prov, valid, low, rng,
                                    jnp.asarray(prefixes[si]),
                                    jnp.int32(plens[si]))
            payloads.append(bytes(np.asarray(o)[:int(cnt)]))
        self.states = jnp.stack(new_states)

        return payloads
