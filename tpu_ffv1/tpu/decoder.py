"""Device FFV1 decoder driver (version 3+, range coder, planar YUV).

Host parses the packet structure (keyframe bit, footer chain, CRCs,
slice headers — a few dozen symbols); the per-pixel work runs as device
scans.  Adaptive states stay device-resident across frames for
GOP/P-frame inheritance (ffv1dec.c:376-403 — in-process the state arrays
simply persist, which is the semantic the thread-copy code implements).

Round-2 design: all slices of a frame — and a ``batch`` of independent
streams — decode as lanes of ONE fused lane-major scan per frame
(dec_scan_lanes.py), mirroring the encode pipeline.  That replaces the
round-1 serial per-(slice, plane) dispatch (the decode analog of the
reference's slice-threaded decode_slice fan-out, ffv1dec.c:991), and a
submit/collect pair pipelines host assembly behind device compute like
the reference's frame threads (pthread_frame.c:310/128).  Non-uniform
slice grids or per-slice quant-table divergence fall back to the
per-slice scans (dec_scan.py).
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..bitstream.headers import read_extra_header, read_slice_header
from ..core import tables as T
from ..core.crc import crc32_ieee
from ..core.rac import RangeDecoder, custom_state_tables, default_state_tables
from ..core.intmath import ceil_rshift
from ..codec.context import SliceState, slice_grid
from .cuda_scan import device_scan, rc_decode_planes
from .dec_scan import rc_decode_plane


@functools.partial(jax.jit, static_argnames=(
    "w", "h", "nplanes", "cc", "coded_bits", "five", "bits", "batch",
    "nh", "nv"))
def _rgb_decode_assemble(bufs, states, one_tab, zero_tab, qt,
                         low0, range0, pos0, by, ry, w: int, h: int,
                         nplanes: int, cc: int, coded_bits: int,
                         five: bool, bits: int, batch: int, nh: int,
                         nv: int):
    """Fused RGB decode + device postprocess: RCT-domain scan, per-lane
    inverse RCT (ffv1dec.c:264-269, v4 coefficients via by/ry), slice
    grid assembly, and output packing (uint8 BGRA / uint16 b,g,r
    planes) — one device program, wire-dtype transfer."""
    from .dec_scan_lanes import rc_decode_rgb_lanes
    planes_dev, states_out, low, rng, pos = rc_decode_rgb_lanes(
        bufs, states, one_tab, zero_tab, qt, low0, range0, pos0,
        w, h, nplanes, cc, coded_bits, five)
    offset = 1 << bits
    b = planes_dev[1] - offset
    r = planes_dev[2] - offset
    gg = planes_dev[0] - ((b * by[:, None, None] +
                           r * ry[:, None, None]) >> 2)
    b = b + gg
    r = r + gg

    def assemble(x):
        x = x.reshape(batch, nv, nh, h, w)
        return jnp.transpose(x, (0, 1, 3, 2, 4)).reshape(
            batch, nv * h, nh * w)

    if bits <= 8:
        a = planes_dev[3] if nplanes == 4 else jnp.zeros_like(b)
        # uint32 LE store b | g<<8 | r<<16 | a<<24 (ffv1dec.c:272)
        full = jnp.stack([assemble(c) & 0xFF for c in (b, gg, r, a)],
                         axis=-1).astype(jnp.uint8)
        planes_full = (full,)
    else:
        planes_full = tuple((assemble(c) & 0xFFFF).astype(jnp.uint16)
                            for c in (b, gg, r))
    lrp = jnp.stack([low, rng, pos])
    return planes_full, states_out, lrp


class TPUFFV1Decoder:
    """Device-resident FFV1 decoder.

    ``batch`` > 1 decodes that many independent streams in lockstep
    (lanes = batch x slices), the decode mirror of TPUFFV1Encoder's
    stream batching.  Use decode_frames([pkt0, pkt1, ...]).
    """

    def __init__(self, width: int, height: int, extradata: bytes,
                 batch: int = 1, mesh=None, device_out: bool = False):
        """``device_out``: collect_frames returns the decoded planes as
        stacked (batch, Hk, Wk) DEVICE arrays instead of per-stream
        host numpy — the shape TPUFFV1Encoder.submit_device_frames
        consumes, so a decode->encode transcode chain keeps every pixel
        in HBM.  Damage concealment needs host pixels, so a CRC/
        sentinel failure raises in this mode instead of concealing."""
        g = read_extra_header(extradata)
        self.golomb = g.ac == T.AC_GOLOMB_RICE
        self.rgb = g.colorspace == 1
        if self.rgb and self.golomb:
            raise NotImplementedError("device RGB decode requires the "
                                      "range coder")
        self.g = g
        self.width = width
        self.height = height
        self.batch = batch
        # mirror FFV1Decoder attribute surface used by read_slice_header
        self.version = g.version
        self.num_h_slices = g.num_h_slices
        self.num_v_slices = g.num_v_slices
        self.plane_count = g.plane_count
        self.quant_table_count = g.quant_table_count
        self.ec = g.ec
        self.bits = 8 if g.bits_per_raw_sample <= 8 else g.bits_per_raw_sample
        # output format string (ffv1dec.c:698-790 reconstruction), the
        # attribute the CLI/filtergraph consumers read off any decoder
        from ..codec.pixfmt import reconstruct_pix_fmt
        self.pix_fmt = reconstruct_pix_fmt(
            g.colorspace, g.bits_per_raw_sample or 8, g.chroma_planes,
            g.chroma_h_shift, g.chroma_v_shift, g.transparency)
        # RGB planes code at 9 bits for <=8-bit sources, bits+1 above
        # (ffv1dec.c:252-255); selects the kernel schedule (<=10 the
        # distinct-slot form, 11..17 the ext running-row form)
        self.coded_bits = (9 if self.bits <= 8 else self.bits + 1) \
            if self.rgb else self.bits
        if g.ac == T.AC_RANGE_CUSTOM_TAB:
            one, zero = custom_state_tables(g.state_transition)
        else:
            one, zero = default_state_tables()
        self.tables = (one, zero)
        self.one_tab = jnp.asarray(one)
        self.zero_tab = jnp.asarray(zero)

        self.geoms = slice_grid(width, height, g.num_h_slices,
                                g.num_v_slices)
        self.n_slices = len(self.geoms)
        self.L = self.n_slices * batch
        # multi-chip: decode slice lanes shard over a 1-D mesh, the
        # distributed analog of the decoder's slice-thread pool
        # (ffv1dec.c:991-996); see sharding.decode_lanes_sharded
        self.mesh = mesh
        if mesh is not None and self.L % mesh.devices.size:
            raise ValueError(
                f"lane count {self.L} (slices x batch) must divide the "
                f"mesh size {mesh.devices.size}")
        self.qts = [jnp.asarray(q, dtype=jnp.int32) for q in g.quant_tables]

        # fused lane-major path requires a uniform grid (block-reshape
        # plane scatter) and coded width <= 10 (distinct-slot get_symbol)
        g0 = self.geoms[0]
        nh, nv = g.num_h_slices, g.num_v_slices
        self.uniform = (
            all(gm.width == g0.width and gm.height == g0.height
                for gm in self.geoms) and
            width % nh == 0 and height % nv == 0 and
            (not g.chroma_planes or
             (g0.width % (1 << g.chroma_h_shift) == 0 and
              g0.height % (1 << g.chroma_v_shift) == 0)))
        if self.rgb and not self.uniform:
            raise NotImplementedError(
                "device RGB decode requires a uniform slice grid; use the "
                "host decoder otherwise")
        # ya8 (transparency without chroma at 8 bits, colorspace 0):
        # decoded as a luma + alpha plane pair, returned interleaved
        self.ya = (not self.rgb and g.transparency
                   and not g.chroma_planes and self.bits <= 8)

        # range-coder decode scan for this device and coded width (the
        # CUDA kernel on the GPU, the XLA lane scan on the CPU)
        self.scan = None if self.golomb else device_scan(
            self.coded_bits,
            mesh.devices.flat[0] if mesh is not None else None)

        if self.golomb and not self.uniform:
            raise NotImplementedError(
                "device Golomb-Rice decode requires a uniform slice grid; "
                "use the host decoder otherwise")
        # device VLC states for the Golomb path (drift, error_sum,
        # bias, count), GOP-persistent like the range-coder states
        self.device_out = device_out
        if device_out and (self.golomb or self.rgb or not self.uniform):
            raise NotImplementedError(
                "device_out requires the fused planar range-coder "
                "decode path (uniform grid, coded width <= 10)")
        self.vlc_states = None
        # per-stream host state
        self.key_frame_ok = [False] * batch
        self.last_planes = [None] * batch
        self.slice_damaged = np.zeros((batch, self.n_slices), bool)
        # device states: fused path keeps one (L, CC, 32) array; the
        # fallback path keeps per-lane entries
        self.states = None
        self.slice_states: list = [None] * self.L
        self._pending: list = []
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(max_workers=1)
        # result transfers are issued from the worker right after the
        # scan dispatch (before the next frame's scan enters the device
        # queue) and resolved at collect time
        self._xfer_pool = ThreadPoolExecutor(max_workers=4)

    # -------------------------------------------------------------- API

    def reset(self):
        """Flush analog (avcodec_flush_buffers): forget GOP contexts,
        concealment reference and keyframe gate — the seek entry point
        (next packet must be a keyframe, ffv1dec.c:931).  Compiled
        pipelines are retained."""
        assert not self._pending, \
            "collect in-flight frames before reset()"
        self.key_frame_ok = [False] * self.batch
        self.last_planes = [None] * self.batch
        self.slice_damaged[:] = False
        self.states = None
        self.vlc_states = None
        self.slice_states = [None] * self.L

    def decode_frame(self, pkt: bytes):
        assert self.batch == 1
        return self.decode_frames([pkt])[0]

    def decode_frames(self, pkts):
        self.submit_frames(pkts)
        return self.collect_frames()

    # ------------------------------------------------------- host parse

    def _split_slices(self, pkt: bytes):
        trailer = 3 + 5 * (1 if self.ec else 0)
        count = 0
        p = len(pkt)
        bounds = []
        while count < T.MAX_SLICES and p > 3:
            size = int.from_bytes(pkt[p - trailer:p - trailer + 3], "big")
            if size + trailer > p:
                break
            bounds.append((p - size - trailer, p))
            p -= size + trailer
            count += 1
        bounds.reverse()
        return bounds

    def _parse_packet(self, bi: int, pkt: bytes):
        """Keyframe bit + footer chain + CRC + slice headers for one
        stream's packet.  Returns (keyframe, per-slice list of
        (buf, qidx, low, range, pos), per-slice list of
        (rct_by, rct_ry, coding_mode, reset_contexts))."""
        rc = RangeDecoder(pkt, *default_state_tables())
        keystate = np.array([128], dtype=np.uint8)
        keyframe = bool(rc.get_rac(keystate, 0))
        if not keyframe and not self.key_frame_ok[bi]:
            raise ValueError("cannot decode non-keyframe without keyframe")
        if keyframe:
            # set at parse time so pipelined submits (decode order ==
            # submission order) pass the cannot-decode-P-without-I guard
            self.key_frame_ok[bi] = True
        bounds = self._split_slices(pkt)
        if len(bounds) != len(self.geoms):
            raise ValueError("slice count mismatch")
        slices = []
        extras = []
        for si, (start, end) in enumerate(bounds):
            if keyframe:
                self.slice_damaged[bi, si] = False
            if self.ec and crc32_ieee(pkt[start:end]) != 0:
                self.slice_damaged[bi, si] = True
            buf = pkt[start:end] if si else pkt[:end]
            src = RangeDecoder(buf)
            src.set_tables(*self.tables)
            if si == 0:
                src.low, src.range, src.pos = rc.low, rc.range, rc.pos
            ex = (1, 1, 0, 0)
            try:
                ss = SliceState(geom=self.geoms[si])
                qidxs, _ = read_slice_header(self, ss, src)
                qidx = qidxs[0]
                # v4 per-slice RCT coefficients / PCM mode / context
                # reset (ffv1dec.c:345-356); defaults below v4
                ex = (ss.slice_rct_by_coef, ss.slice_rct_ry_coef,
                      ss.slice_coding_mode, ss.slice_reset_contexts)
            except (ValueError, IndexError):
                self.slice_damaged[bi, si] = True
                qidx = 0
            extras.append(ex)
            if self.golomb:
                # bit reader starts at ac_byte_count after the range-
                # coded header (+ v3.2 sentinel), ffv1dec.c:427-434
                if (self.version == 3 and self.g.micro_version > 1) or \
                        self.version > 3:
                    sentinel = np.array([129], dtype=np.uint8)
                    src.get_rac(sentinel, 0)
                slices.append((buf, qidx, 0, 0,
                               src.bytes_consumed() - 1))
            else:
                slices.append((buf, qidx, src.low, src.range, src.pos))
        return keyframe, slices, extras

    def _plane_specs(self):
        g = self.g
        g0 = self.geoms[0]
        sw, sh = g0.width, g0.height
        cc = None  # filled by caller per qidx
        specs = [(sw, sh, 0)]
        if g.chroma_planes:
            cw = ceil_rshift(sw, g.chroma_h_shift)
            ch = ceil_rshift(sh, g.chroma_v_shift)
            specs += [(cw, ch, 1), (cw, ch, 1)]
        if g.transparency:
            specs.append((sw, sh, 2 if g.chroma_planes else 1))
        return specs

    def _fresh_states(self, qidx: int):
        g = self.g
        cc = g.context_counts[qidx]
        if self.rgb:
            # RGB state planes: g->0, b/r->1, a->2 ((p+1)/2,
            # ffv1dec.c:253)
            n_state_planes = 2 + (1 if g.transparency else 0)
        else:
            n_state_planes = 1 + (1 if g.chroma_planes else 0) + \
                (1 if g.transparency else 0)
        total_cc = n_state_planes * cc
        init = g.initial_states[qidx]
        if init is not None:
            st = np.tile(np.asarray(init[:cc]), (n_state_planes, 1))
        else:
            st = np.full((total_cc, 32), 128, np.uint8)
        return st

    def _reset_lane_states(self, keyframes, resets, qidx0, total_cc):
        """Apply per-stream keyframe resets and v4 reset_contexts to the
        GOP-persistent device state table; runs on the single-worker
        executor in submit order so the context-inheritance chain stays
        intact (ffv1dec.c:376-403 / :419-420).  Shared by the planar
        and RGB submit paths."""
        if self.states is None or self.states.shape[1] != total_cc:
            self.states = jnp.asarray(np.tile(
                self._fresh_states(qidx0)[None], (self.L, 1, 1)))
        if any(keyframes) or resets.any():
            st = np.array(self.states)
            fresh = self._fresh_states(qidx0)
            for bi, kf in enumerate(keyframes):
                if kf:
                    st[bi * self.n_slices:
                       (bi + 1) * self.n_slices] = fresh
            st[resets] = fresh
            self.states = jnp.asarray(st)
        return self.states

    # ------------------------------------------------------ fused path

    def lane_inputs(self, parsed):
        """Lane-major scan inputs from parsed packets: (bufs uint8[L,
        cap], low, range, pos, buffer lengths), lane = stream *
        n_slices + slice.  The cap is bucketed to a power of two to
        bound recompiles."""
        maxlen = max(len(s[0]) for p in parsed for s in p[1])
        cap = max(4096, 1 << (maxlen - 1).bit_length())
        bufs = np.zeros((self.L, cap), np.uint8)
        lows = np.zeros(self.L, np.int32)
        ranges = np.zeros(self.L, np.int32)
        poss = np.zeros(self.L, np.int32)
        buflens = np.zeros(self.L, np.int64)
        for bi, (kf, sl, _ex) in enumerate(parsed):
            for si, (buf, qidx, lo, ra, po) in enumerate(sl):
                lane = bi * self.n_slices + si
                bufs[lane, :len(buf)] = np.frombuffer(buf, np.uint8)
                lows[lane], ranges[lane], poss[lane] = lo, ra, po
                buflens[lane] = len(buf)
        return bufs, lows, ranges, poss, buflens

    def submit_frames(self, pkts):
        """Async half: parse headers, upload buffers, dispatch the fused
        device scan without waiting (overlaps with the previous frame's
        collect, like pthread_frame.c's packet fan-out)."""
        assert len(pkts) == self.batch
        g = self.g
        parsed = [self._parse_packet(bi, pkt)
                  for bi, pkt in enumerate(pkts)]
        keyframes = [p[0] for p in parsed]
        qidx0 = parsed[0][1][0][1]
        same_q = all(s[1] == qidx0 for p in parsed for s in p[1])

        if not (self.uniform and same_q):
            if self.rgb:
                raise NotImplementedError(
                    "device RGB decode requires a shared quant table "
                    "across slices; use the host decoder")
            planes_out = [self._decode_stream_fallback(bi, parsed[bi])
                          for bi in range(self.batch)]
            self._pending.append(dict(results=[
                (self._conceal(bi, planes_out[bi]), keyframes[bi])
                for bi in range(self.batch)]))
            return

        cc = g.context_counts[qidx0]
        specs = tuple((w, h, sp * cc) for (w, h, sp) in self._plane_specs())
        total_cc = self._fresh_states(qidx0).shape[0]

        bufs, lows, ranges, poss, buflens = self.lane_inputs(parsed)

        qt = self.qts[qidx0]
        five = bool(g.quant_tables[qidx0][3][127])

        # v4 per-slice extras (ffv1dec.c:345-356): PCM slices can't ride
        # the fused scans (host decoder handles them); reset_contexts
        # resets that lane's adaptive states; RCT coefficients feed the
        # RGB inverse transform per lane
        resets = np.zeros(self.L, bool)
        for bi, (_kf, _sl, ex) in enumerate(parsed):
            for si, (_by, _ry, mode, rst) in enumerate(ex):
                if mode != 0:
                    raise NotImplementedError(
                        "v4 PCM slices are host-only; use FFV1Decoder")
                resets[bi * self.n_slices + si] = bool(rst)

        if self.golomb:
            self._submit_golomb(parsed, keyframes, bufs, poss, qidx0,
                                cc, specs, total_cc, buflens)
            return

        if self.rgb:
            self._submit_rgb(parsed, keyframes, resets, bufs, lows,
                             ranges, poss, qt, qidx0, total_cc, buflens,
                             five)
            return

        def work():
            # runs on the single-worker executor in submit order, so
            # reading/advancing self.states here keeps the GOP context
            # inheritance chain intact (keyframe resets are per stream)
            states0 = self._reset_lane_states(keyframes, resets,
                                               qidx0, total_cc)
            db = jnp.asarray(bufs)
            if self.mesh is not None:
                from .sharding import decode_lanes_sharded
                planes_dev, states_out, low, rng, pos = \
                    decode_lanes_sharded(
                        self.mesh, db, states0, self.one_tab,
                        self.zero_tab, qt, jnp.asarray(lows),
                        jnp.asarray(ranges), jnp.asarray(poss), specs,
                        self.bits, five)
            else:
                planes_dev, states_out, low, rng, pos = rc_decode_planes(
                    self.scan, db, states0, self.one_tab, self.zero_tab,
                    qt, jnp.asarray(lows), jnp.asarray(ranges),
                    jnp.asarray(poss), specs, self.bits, five)
            self.states = states_out
            # device-side postprocess: assemble full frames (inverse
            # block reshape) and narrow to the wire dtype, so the
            # transfer is 1-2 bytes/pixel instead of the scan's int32 —
            # then issue the result fetches NOW, before the next
            # frame's scan is enqueued (a fetch submitted at collect
            # time waits behind every queued scan)
            nh, nv = g.num_h_slices, g.num_v_slices
            planes_full = []
            for k, (w, h, _sp) in enumerate(specs):
                x = planes_dev[k].reshape(self.batch, nv, nh, h, w)
                x = jnp.transpose(x, (0, 1, 3, 2, 4)) \
                    .reshape(self.batch, nv * h, nh * w)
                if self.bits <= 8:
                    x = (x & 0xFF).astype(jnp.uint8)
                elif self._packed_at_lsb():
                    x = x.astype(jnp.uint16)
                else:
                    x = ((x << (16 - self.bits)) & 0xFFFF) \
                        .astype(jnp.uint16)
                planes_full.append(x)
            plane_futs = None if self.device_out else \
                [self._xfer_pool.submit(lambda a=pl: np.asarray(a))
                 for pl in planes_full]
            lrp = jnp.stack([low, rng, pos])     # one fetch RPC
            lrp_fut = self._xfer_pool.submit(
                lambda: tuple(np.asarray(lrp)))
            return dict(plane_futs=plane_futs, lrp_fut=lrp_fut,
                        keyframes=keyframes, parsed=parsed,
                        buflens=buflens, specs=specs,
                        planes_dev=(tuple(planes_full)
                                    if self.device_out else None))

        self._pending.append(self._executor.submit(work))

    def _submit_rgb(self, parsed, keyframes, resets, bufs, lows, ranges,
                    poss, qt, qidx0, total_cc, buflens, five):
        """Fused line-interleaved RGB decode (ffv1dec.c:226-280):
        rc_decode_rgb_lanes yields RCT-domain samples; the inverse RCT,
        slice-grid assembly and output packing all run on device so the
        transfer is the final frame bytes.  Output convention matches
        FFV1Decoder._alloc_frame: <=8-bit -> one (h, w, 4) uint8 BGRA
        array per stream; >8-bit -> three uint16 planes in coded
        (b, g, r) order."""
        from .dec_scan_lanes import rc_decode_rgb_lanes
        g = self.g
        g0 = self.geoms[0]
        nplanes = 3 + (1 if g.transparency else 0)
        lbd = self.bits <= 8
        nh, nv = g.num_h_slices, g.num_v_slices
        # per-lane v4 RCT coefficients (1, 1 below v4)
        by = np.ones(self.L, np.int32)
        ry = np.ones(self.L, np.int32)
        for bi, (_kf, _sl, ex) in enumerate(parsed):
            for si, (eby, ery, _m, _r) in enumerate(ex):
                lane = bi * self.n_slices + si
                by[lane], ry[lane] = eby, ery

        def work():
            states0 = self._reset_lane_states(keyframes, resets,
                                               qidx0, total_cc)
            planes_full, states_out, lrp = _rgb_decode_assemble(
                jnp.asarray(bufs), states0, self.one_tab, self.zero_tab,
                qt, jnp.asarray(lows), jnp.asarray(ranges),
                jnp.asarray(poss), jnp.asarray(by), jnp.asarray(ry),
                g0.width, g0.height, nplanes, g.context_counts[qidx0],
                self.coded_bits, five, self.bits, self.batch, nh, nv)
            self.states = states_out
            plane_futs = [self._xfer_pool.submit(
                lambda a=pl: np.asarray(a)) for pl in planes_full]
            lrp_fut = self._xfer_pool.submit(
                lambda: tuple(np.asarray(lrp)))
            return dict(plane_futs=plane_futs, lrp_fut=lrp_fut,
                        keyframes=keyframes, parsed=parsed,
                        buflens=buflens, specs=None)

        self._pending.append(self._executor.submit(work))

    def _submit_golomb(self, parsed, keyframes, bufs, poss, qidx0, cc,
                       specs, total_cc, buflens):
        """Fused Golomb-Rice decode (coder=0): lane-major VLC/run scan
        (golomb_dec_lanes.py).  VLC states are device-resident across
        the GOP; there is no rc sentinel/byte-count check in Golomb
        mode (ffv1dec.c only validates it for the range coder)."""
        from .golomb_dec_lanes import golomb_decode_planes_lanes
        g = self.g
        qt = self.qts[qidx0]
        five = bool(g.quant_tables[qidx0][3][127])

        def fresh_vlc():
            return np.tile(np.array([0, 4, 0, 1], np.int32),
                           (self.L, total_cc, 1))

        def work():
            if self.vlc_states is None or \
                    self.vlc_states.shape[1] != total_cc:
                self.vlc_states = jnp.asarray(fresh_vlc())
            if any(keyframes):
                st = np.array(self.vlc_states)
                for bi, kf in enumerate(keyframes):
                    if kf:
                        st[bi * self.n_slices:(bi + 1) * self.n_slices] \
                            = np.array([0, 4, 0, 1], np.int32)
                self.vlc_states = jnp.asarray(st)
            planes_dev, vlc_out, _bitpos = golomb_decode_planes_lanes(
                jnp.asarray(bufs), self.vlc_states, qt,
                jnp.asarray(poss), specs, self.bits, five)
            self.vlc_states = vlc_out
            nh, nv = g.num_h_slices, g.num_v_slices
            planes_full = []
            for k, (w, h, _sp) in enumerate(specs):
                x = planes_dev[k].reshape(self.batch, nv, nh, h, w)
                x = jnp.transpose(x, (0, 1, 3, 2, 4)) \
                    .reshape(self.batch, nv * h, nh * w)
                if self.bits <= 8:
                    x = (x & 0xFF).astype(jnp.uint8)
                elif self._packed_at_lsb():
                    x = x.astype(jnp.uint16)
                else:
                    x = ((x << (16 - self.bits)) & 0xFFFF) \
                        .astype(jnp.uint16)
                planes_full.append(x)
            plane_futs = [self._xfer_pool.submit(
                lambda a=pl: np.asarray(a)) for pl in planes_full]
            return dict(plane_futs=plane_futs, lrp_fut=None,
                        keyframes=keyframes, parsed=parsed,
                        buflens=buflens, specs=specs)

        self._pending.append(self._executor.submit(work))

    def collect_frames(self):
        assert self._pending, "no submit_frames() in flight"
        p = self._pending.pop(0)
        if isinstance(p, dict) and "results" in p:
            return p["results"]
        p = p.result()
        g = self.g
        specs = p["specs"]
        keyframes = p["keyframes"]
        nh, nv = g.num_h_slices, g.num_v_slices
        dt = np.uint8 if self.bits <= 8 else np.uint16

        # sentinel + byte-count validation per lane (ffv1dec.c:459-467);
        # Golomb mode has no terminating sentinel (lrp_fut is None)
        parsed_iter = enumerate(p["parsed"]) if p["lrp_fut"] is not None \
            else []
        if p["lrp_fut"] is not None:
            low, rng, pos = p["lrp_fut"].result()
        for bi, (kf, sl, _ex) in parsed_iter:
            for si, (buf, *_rest) in enumerate(sl):
                lane = bi * self.n_slices + si
                src = RangeDecoder(buf)
                src.set_tables(*self.tables)
                src.low, src.range, src.pos = (int(low[lane]),
                                               int(rng[lane]),
                                               int(pos[lane]))
                sentinel = np.array([129], dtype=np.uint8)
                try:
                    src.get_rac(sentinel, 0)
                    v = (len(buf) - src.pos) - 2 - 5 * (1 if self.ec else 0)
                    if v:
                        raise ValueError("bytestream end mismatch")
                except (ValueError, IndexError):
                    self.slice_damaged[bi, si] = True

        if p.get("planes_dev") is not None:
            # device-sink mode: planes stay in HBM, shaped for
            # TPUFFV1Encoder.submit_device_frames (transcode chain).
            # Concealment re-encodes from host pixels, so damage is
            # fatal here — the caller opted out of host round-trips.
            if self.slice_damaged.any():
                raise RuntimeError(
                    "damaged slice in device_out mode; decode with "
                    "device_out=False to conceal from the previous "
                    "frame")
            return p["planes_dev"], keyframes

        full_planes = [f.result() for f in p["plane_futs"]]
        results = []
        for bi in range(self.batch):
            planes = [fp[bi] for fp in full_planes]
            # yuv shares the chroma plane spec twice; specs order is the
            # plane order already
            results.append((self._conceal(bi, planes), keyframes[bi]))
        return results

    # -------------------------------------------------- fallback path

    def _decode_stream_fallback(self, bi: int, parsed):
        """Per-slice scans (non-uniform grids / mixed quant tables /
        bits > 10) — the round-1 formulation."""
        g = self.g
        keyframe, slices = parsed[0], parsed[1]
        h, w = self.height, self.width
        dt = np.uint8 if self.bits <= 8 else np.uint16
        planes = [np.zeros((h, w), dtype=dt)]
        hs, vs = g.chroma_h_shift, g.chroma_v_shift
        if g.chroma_planes:
            planes += [np.zeros((ceil_rshift(h, vs), ceil_rshift(w, hs)),
                                dtype=dt) for _ in range(2)]
        if g.transparency:
            planes.append(np.zeros((h, w), dtype=dt))

        for si, (buf, qidx, lo, ra, po) in enumerate(slices):
            lane = bi * self.n_slices + si
            try:
                self._decode_slice_scans(lane, si, qidx, buf, lo, ra, po,
                                         planes, keyframe)
            except (ValueError, IndexError):
                self.slice_damaged[bi, si] = True
        return planes

    def _decode_slice_scans(self, lane, si, qidx, buf, lo, ra, po,
                            planes, keyframe):
        g = self.g
        geom = self.geoms[si]
        cc = g.context_counts[qidx]
        qt = self.qts[qidx]
        five = bool(g.quant_tables[qidx][3][127])
        if keyframe or self.slice_states[lane] is None:
            states = jnp.asarray(self._fresh_states(qidx))
        else:
            states = self.slice_states[lane]

        dbuf = jnp.asarray(np.frombuffer(buf, dtype=np.uint8))
        low, rng, pos = jnp.int32(lo), jnp.int32(ra), jnp.int32(po)

        x, y, sw, sh = geom.x, geom.y, geom.width, geom.height
        hs, vs = g.chroma_h_shift, g.chroma_v_shift
        jobs = [(0, sw, sh, x, y, planes[0])]
        if g.chroma_planes:
            cw, ch = ceil_rshift(sw, hs), ceil_rshift(sh, vs)
            jobs.append((1, cw, ch, x >> hs, y >> vs, planes[1]))
            jobs.append((1, cw, ch, x >> hs, y >> vs, planes[2]))
        if g.transparency:
            jobs.append((2 if g.chroma_planes else 1, sw, sh, x, y,
                         planes[-1]))

        for sp, pw, ph, px, py, dst in jobs:
            plane, states, low, rng, pos = rc_decode_plane(
                dbuf, states, self.one_tab, self.zero_tab, qt,
                jnp.int32(sp * cc), low, rng, pos, pw, ph, self.bits, five)
            out = np.asarray(plane)
            if self.bits <= 8:
                dst[py:py + ph, px:px + pw] = out & 0xFF
            elif self._packed_at_lsb():
                dst[py:py + ph, px:px + pw] = out
            else:
                dst[py:py + ph, px:px + pw] = (out << (16 - self.bits)) \
                    & 0xFFFF
        self.slice_states[lane] = states

        # sentinel + byte-count check (ffv1dec.c:459-467)
        src = RangeDecoder(buf)
        src.set_tables(*self.tables)
        src.low, src.range, src.pos = int(low), int(rng), int(pos)
        sentinel = np.array([129], dtype=np.uint8)
        src.get_rac(sentinel, 0)
        v = (len(buf) - src.pos) - 2 - 5 * (1 if self.ec else 0)
        if v:
            raise ValueError(f"slice {si} bytestream end mismatch by {v}")

    # ----------------------------------------------------- concealment

    def _conceal(self, bi: int, planes):
        """Copy damaged slice rects from the stream's previous picture
        (ffv1dec.c:1001-1021); damage persists until the next keyframe."""
        g = self.g
        if self.last_planes[bi] is not None:
            for si in range(self.n_slices):
                if not self.slice_damaged[bi, si]:
                    continue
                geom = self.geoms[si]
                hs, vs = g.chroma_h_shift, g.chroma_v_shift
                for j, src_p in enumerate(self.last_planes[bi]):
                    # fetched planes are read-only views into the
                    # batched transfer buffer; copy before patching
                    if not planes[j].flags.writeable:
                        planes[j] = np.array(planes[j])
                    dst = planes[j]
                    sh = hs if j in (1, 2) and g.chroma_planes else 0
                    sv = vs if j in (1, 2) and g.chroma_planes else 0
                    ys, xs = geom.y >> sv, geom.x >> sh
                    he = ceil_rshift(geom.y + geom.height, sv)
                    we = ceil_rshift(geom.x + geom.width, sh)
                    dst[ys:he, xs:we] = src_p[ys:he, xs:we]
        self.last_planes[bi] = planes
        self.key_frame_ok[bi] = True
        if self.ya:
            # ya8 output convention: one (h, w, 2) interleaved array
            # (FFV1Decoder's channel-strided storage, ffv1dec.c:185)
            return [np.stack((planes[0], planes[1]), axis=-1)]
        return planes

    def _packed_at_lsb(self):
        return self.g.bits_per_raw_sample in (9, 10) or \
            (self.g.bits_per_raw_sample <= 8)
