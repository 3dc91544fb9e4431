"""Experimental motion-compensated FFV1-P codec (framework extension).

The fork's direction (SURVEY §0.3, §2.4): FFV1 inter frames with block
motion compensation built from the reference's motion machinery —
SAD search (motion_est.c:904), OBMC prediction (snow.c:327
ff_snow_pred_block / snow.h:279 add_yblock) — wired into an
FFV1-STRUCTURED bitstream.  Gated behind experimental=True exactly as
the reference gates unfinished versions (ffv1enc.c:703-706).

Stream layout (round 2 — single integrated bitstream):

  * Keyframes are plain FFV1 intra packets, byte-identical to the base
    encoder — the seek/recovery points (SURVEY §5).
  * P-frame packets reuse the full FFV1 packet STRUCTURE: the keyframe
    rac bit (0), then per-slice payloads each ending in the 3-byte
    length footer + optional CRC (ffv1enc.c:1326-1354).  One slice
    payload is a single range-coder stream:

      slice_header            (write_slice_header, ffv1enc.c:1031-1062)
      per 16x16 luma block of the slice (row-major):
        inter_flag            (put_rac, persistent per-slice state)
        if inter: d_dy, d_dx  (signed put_symbol vs the previous
                               frame's MV of the same block, persistent
                               per-slice contexts)
      residual planes         (encode_plane at bits+1 width — the RGB
                               offset trick, ffv1enc.c:464-467 — with
                               per-slice plane states persistent across
                               the GOP, cleared only at keyframes)
      sentinel + terminate    (ffv1enc.c:1331-1334)

  * Prediction is OBMC: each pixel blends the MC predictions of its 4
    nearest block neighbors with exact-integer bilinear tent weights
    (sum 4B^2; partition of unity), the vectorized analog of snow's
    add_yblock window.  Intra blocks predict the bit-depth midpoint.
  * Motion search is rate-aware: cost = SAD + LAMBDA * |mv - mv_prev|
    where mv_prev is the same block's previous-frame vector — the same
    predictor the MV deltas are coded against.  Chroma reuses luma MVs
    scaled by the subsampling shifts (no extra side info).

Slices stay fully independent (motion search, OBMC and all contexts are
per-slice), preserving the slice-parallel/trasher-concealment properties
of the base codec; damaged P slices conceal from the previous picture
and stay damaged until the next keyframe (ffv1dec.c:1001-1021).
"""
from __future__ import annotations

import numpy as np

from ..bitstream.headers import read_slice_header, write_slice_header
from ..bitstream.symbols import get_symbol, put_symbol
from ..codec.context import clear_slice_state
from ..codec.decoder import FFV1Decoder
from ..codec.encoder import FFV1Encoder
from ..codec.params import EncoderParams
from ..core import tables as T
from ..core.crc import crc32_ieee
from ..core.intmath import ceil_rshift
from ..core.rac import RangeDecoder, RangeEncoder, default_state_tables
from .motion import pad_to_block

BLOCK = 16
LAMBDA = 16         # rate weight: SAD units per |mv delta| component

# The P stream is an experimental extension (no reference counterpart),
# so its format carries its OWN version marker: the base FFV1 extradata
# is followed by a magic + version tail.  Streams written before the
# marker existed (or with a different P wire format — e.g. the v2-era
# bare-put_rac inter flag) fail loudly instead of decoding garbage.
P_MAGIC = b"FFV1P"
P_FORMAT_VERSION = 3      # matches goldens/pframe_v3.sha256


def p_extradata(base_extradata: bytes) -> bytes:
    """Extradata for an FFV1-P stream: base FFV1 header + P marker."""
    return base_extradata + P_MAGIC + bytes([P_FORMAT_VERSION])


def split_p_extradata(extradata: bytes) -> bytes:
    """Validate + strip the P-format marker; returns the base FFV1
    extradata.  Raises on missing marker (pre-marker or non-P stream)
    or unsupported P version."""
    if len(extradata) < len(P_MAGIC) + 1 or \
            extradata[-len(P_MAGIC) - 1:-1] != P_MAGIC:
        raise ValueError(
            "extradata carries no FFV1-P format marker (plain-FFV1 or "
            "pre-v3 P stream); P wire formats before the marker are "
            "not decodable by this version")
    ver = extradata[-1]
    if ver != P_FORMAT_VERSION:
        raise ValueError(f"unsupported FFV1-P format version {ver} "
                         f"(this build speaks v{P_FORMAT_VERSION})")
    return extradata[:-len(P_MAGIC) - 1]


class _Bits9View:
    """Attribute view of a ResolvedParams/decoder forcing LSB-packed
    sample IO: residuals are raw (bits+1)-wide integers, not
    MSB-justified 16-bit samples."""

    packed_at_lsb = True

    def __init__(self, rp):
        self._rp = rp

    def __getattr__(self, k):
        return getattr(self._rp, k)


def obmc_predict(ref_pad: np.ndarray, mvs: np.ndarray,
                 intra: np.ndarray, mid: int,
                 block_y: int = BLOCK, block_x: int = BLOCK):
    """Overlapped-block MC with exact-integer bilinear tent weights.

    Each pixel blends the predictions of its 2x2 nearest block centers
    (weights sum to 4*By*Bx = 1 << 10 for B=16 — snow.h:48
    LOG2_OBMC_MAX analog).  ``ref_pad``: (H, W) int array padded to
    block multiples; ``mvs``: (bh, bw, 2); ``intra``: (bh, bw) bool —
    intra blocks contribute the constant ``mid``.  Blocks may be
    rectangular (chroma under 422-style subsampling).  Returns int32
    (H, W).
    """
    H, W = ref_pad.shape
    bh, bw = H // block_y, W // block_x
    y = np.arange(H)
    x = np.arange(W)
    # block-center coordinates scaled by 2B: center of block i at
    # (2i+1)B; pixel y sits at 2y+1
    ty = (2 * y + 1 - block_y) // (2 * block_y)      # top neighbor row
    wy1 = (2 * y + 1 - block_y) - ty * 2 * block_y   # 0..2B-1 (bottom w)
    tx = (2 * x + 1 - block_x) // (2 * block_x)
    wx1 = (2 * x + 1 - block_x) - tx * 2 * block_x
    acc = np.zeros((H, W), np.int64)
    for dy in (0, 1):
        iy = np.clip(ty + dy, 0, bh - 1)
        wy = np.where(dy == 0, 2 * block_y - wy1, wy1)[:, None]
        for dx in (0, 1):
            ix = np.clip(tx + dx, 0, bw - 1)
            wx = np.where(dx == 0, 2 * block_x - wx1, wx1)[None, :]
            byx = iy[:, None].repeat(W, 1), ix[None, :].repeat(H, 0)
            mv = mvs[byx[0], byx[1]]                 # (H, W, 2)
            ys = np.clip(y[:, None] + mv[..., 0], 0, H - 1)
            xs = np.clip(x[None, :] + mv[..., 1], 0, W - 1)
            p = ref_pad[ys, xs].astype(np.int64)
            p = np.where(intra[byx[0], byx[1]], mid, p)
            acc += wy.astype(np.int64) * wx * p
    shift = 2 + (block_y - 1).bit_length() + (block_x - 1).bit_length()
    return ((acc + (1 << (shift - 1))) >> shift).astype(np.int32)


class _PSliceState:
    """Per-slice persistent P-frame state (cleared at keyframes)."""

    def __init__(self):
        self.flag_state = None       # uint8[32] inter/intra rac state
        self.mv_states = None        # uint8[2, 32] dy/dx symbol contexts
        self.prev_mvs = None         # int32[bh, bw, 2] previous MV field
        self.ss = None               # SliceState for residual planes


class FFV1PEncoder:
    """Inter-frame FFV1 with OBMC block motion (experimental)."""

    def __init__(self, params: EncoderParams, radius: int = 7,
                 experimental: bool = False, me: str = "full"):
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
        self.params = params
        self.radius = radius
        self.me = me
        self.base = FFV1Encoder(params)
        rp = self.base.rp
        if rp.bits_per_raw_sample > 15 or rp.colorspace != 0 or \
                rp.fmt.interleaved:
            # residuals are coded at bits+1 <= 16 through the uint16
            # slice-plane path (the RGB offset trick, ffv1enc.c:464-467)
            raise NotImplementedError(
                "FFV1-P supports planar YUV/gray input up to 15 bits")
        if rp.ac == T.AC_GOLOMB_RICE:
            raise NotImplementedError("FFV1-P requires the range coder")
        if rp.version < 3:
            raise NotImplementedError("FFV1-P requires version >= 3")
        self.rp = rp
        self.extradata = p_extradata(self.base.extradata)
        self.picture_number = 0
        self.ref_planes = None
        self.pstates = [_PSliceState() for _ in self.base.slices]

    # ---------------------------------------------------------------

    def _search_slice(self, cur_pad, ref_pad, prev_mvs):
        from .motion import SEARCH_FNS
        mvs, sad, cost = SEARCH_FNS[self.me](
            cur_pad, ref_pad, prev_mvs, BLOCK, self.radius, LAMBDA)
        mvs, sad, cost = (np.asarray(mvs), np.asarray(sad),
                          np.asarray(cost))
        # per-block intra/inter decision (motion_est.c:904's mb_var vs
        # motion cost comparison, simplified): intra when even the best
        # motion candidate is worse than coding around the block mean
        B2 = BLOCK * BLOCK
        blocks = cur_pad.reshape(cur_pad.shape[0] // BLOCK, BLOCK,
                                 cur_pad.shape[1] // BLOCK, BLOCK) \
            .transpose(0, 2, 1, 3).astype(np.int32)
        mean = (blocks.reshape(*blocks.shape[:2], B2).sum(-1) + B2 // 2) \
            // B2
        intra_sad = np.abs(blocks - mean[..., None, None]) \
            .reshape(*blocks.shape[:2], B2).sum(-1)
        intra = cost > intra_sad + B2    # bias toward inter (MV chain)
        return mvs, intra

    def reset(self):
        """Flush analog: restart the GOP (fresh keyframe, reference
        plane and MV predictor chain dropped)."""
        self.picture_number = 0
        self.ref_planes = None
        self.pstates = [_PSliceState() for _ in self.base.slices]
        self.base.reset()

    def encode_frame(self, planes):
        planes = [np.asarray(p) for p in planes]
        keyframe = self.picture_number % self.params.gop_size == 0
        self.picture_number += 1

        if keyframe:
            self.base.picture_number = 0  # force keyframe path
            pkt, _ = self.base.encode_frame(planes)
            self.ref_planes = [p.copy() for p in planes]
            self.pstates = [_PSliceState() for _ in self.base.slices]
            return pkt, True

        rp = self.rp
        bits = rp.bits_per_raw_sample
        mid = 1 << (bits - 1)
        offset = 1 << bits

        rc0 = RangeEncoder(*default_state_tables())
        keystate = np.array([128], dtype=np.uint8)
        rc0.put_rac(keystate, 0, 0)
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            rc0.set_tables(*self.base._slice_tables)

        payloads = []
        for si, ss in enumerate(self.base.slices):
            rc = rc0 if si == 0 else RangeEncoder(*self.base._slice_tables)
            payloads.append(self._encode_slice_p(
                si, planes, rc, mid, offset, bits))

        out = bytearray()
        for payload in payloads:
            chunk = bytearray(payload)
            chunk += len(payload).to_bytes(3, "big")
            if rp.ec:
                chunk.append(0)
                chunk += int(crc32_ieee(bytes(chunk))).to_bytes(4, "little")
            out += chunk
        self.ref_planes = [p.copy() for p in planes]
        return bytes(out), False

    def _encode_slice_p(self, si, planes, rc, mid, offset, bits):
        rp = self.rp
        base_ss = self.base.slices[si]
        geom = base_ss.geom
        ps = self.pstates[si]

        # luma slice region, padded to block multiples
        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        cur = planes[0][y:y + h, x:x + w]
        ref = self.ref_planes[0][y:y + h, x:x + w]
        cur_pad = pad_to_block(cur, BLOCK).astype(np.int32)
        ref_pad = pad_to_block(ref, BLOCK).astype(np.int32)
        bh, bw = cur_pad.shape[0] // BLOCK, cur_pad.shape[1] // BLOCK

        if ps.flag_state is None:
            ps.flag_state = np.full(32, 128, np.uint8)
            ps.mv_states = np.full((2, 32), 128, np.uint8)
            ps.prev_mvs = np.zeros((bh, bw, 2), np.int32)
            import copy
            ps.ss = copy.deepcopy(base_ss)
            clear_slice_state(rp, ps.ss)

        mvs, intra = self._search_slice(cur_pad, ref_pad, ps.prev_mvs)
        mvs = np.where(intra[..., None], 0, mvs)

        # slice header + MV section + residual planes in ONE rac stream
        ps.ss.slice_coding_mode = 0
        ps.ss.slice_rct_by_coef = 1
        ps.ss.slice_rct_ry_coef = 1
        write_slice_header(rp, ps.ss, rc)
        for by in range(bh):
            for bx in range(bw):
                # inter flag as a put_symbol on its own context row (not
                # a bare put_rac): makes the whole post-header payload
                # one uniform put_symbol stream, so the lane-major
                # device scan can code the MV section and the residual
                # planes in a single pass (pframe/tpu.py)
                put_symbol(rc, ps.flag_state,
                           0 if intra[by, bx] else 1, True)
                if not intra[by, bx]:
                    put_symbol(rc, ps.mv_states[0],
                               int(mvs[by, bx, 0] - ps.prev_mvs[by, bx, 0]),
                               True)
                    put_symbol(rc, ps.mv_states[1],
                               int(mvs[by, bx, 1] - ps.prev_mvs[by, bx, 1]),
                               True)
        # inter blocks update the MV predictor field; intra keep it
        ps.prev_mvs = np.where(intra[..., None], ps.prev_mvs, mvs)

        # residuals at bits+1 through the standard slice plane coder
        from ..core.golomb import BitWriter
        jobs = self._residual_jobs(planes, geom, mvs, intra, mid)
        coder = (rc, BitWriter())
        rpv = _Bits9View(rp)
        use_native = self.base.engine == "native"
        if use_native:
            from .. import native as N
            nsc = N.NativeSliceCoder(rp, w * h * 8 + 4096)
        for (res, pw, ph, pi) in jobs:
            if use_native:
                N.encode_plane(rpv, ps.ss, nsc, coder, res, pw, ph, pi,
                               bits + 1)
            else:
                from ..codec.slice_codec import encode_plane
                encode_plane(rpv, ps.ss, coder, res, pw, ph, pi, bits + 1)

        sentinel = np.array([129], dtype=np.uint8)
        rc.put_rac(sentinel, 0, 0)
        return rc.terminate()

    def _residual_jobs(self, planes, geom, mvs, intra, mid):
        """(residual, w, h, plane_index) per coded plane of one slice."""
        rp = self.rp
        bits = rp.bits_per_raw_sample
        offset = 1 << bits
        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        jobs = []

        def res_for(cur, ref, blk, pmvs, pintra, pw, ph, pi):
            cur_pad = pad_to_block(cur, blk).astype(np.int32)
            ref_pad = pad_to_block(ref, blk).astype(np.int32)
            pred = obmc_predict(ref_pad, pmvs, pintra, mid, *blk)
            res = cur_pad[:ph, :pw] - pred[:ph, :pw] + offset
            jobs.append((res.astype(np.uint16), pw, ph, pi))

        res_for(planes[0][y:y + h, x:x + w],
                self.ref_planes[0][y:y + h, x:x + w],
                (BLOCK, BLOCK), mvs, intra, w, h, 0)
        if rp.chroma_planes:
            hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
            cx, cy = x >> hs, y >> vs
            cw, ch = ceil_rshift(w, hs), ceil_rshift(h, vs)
            cblk = (max(BLOCK >> vs, 2), max(BLOCK >> hs, 2))
            cmvs = np.stack([mvs[..., 0] >> vs, mvs[..., 1] >> hs], -1)
            for pi, pl in ((1, 1), (1, 2)):
                res_for(planes[pl][cy:cy + ch, cx:cx + cw],
                        self.ref_planes[pl][cy:cy + ch, cx:cx + cw],
                        cblk, cmvs, intra, cw, ch, pi)
        if rp.transparency:
            res_for(planes[-1][y:y + h, x:x + w],
                    self.ref_planes[-1][y:y + h, x:x + w],
                    (BLOCK, BLOCK), mvs, intra, w, h,
                    2 if rp.chroma_planes else 1)
        return jobs


class FFV1PDecoder:
    """Decoder for the integrated FFV1-P stream."""

    def __init__(self, width: int, height: int, extradata: bytes):
        from ..core.rac import custom_state_tables
        self.base = FFV1Decoder(width, height,
                                split_p_extradata(extradata))
        self.width = width
        self.height = height
        self.ref_planes = None
        self.pstates = [_PSliceState() for _ in self.base.slices]
        self.slice_damaged = np.zeros(len(self.base.slices), bool)
        st = self.base.state_transition
        self._tables = custom_state_tables(st) if st is not None \
            else default_state_tables()

    def reset(self):
        """Flush analog: the seek entry point (next packet must be a
        keyframe)."""
        self.ref_planes = None
        self.pstates = [_PSliceState() for _ in self.base.slices]
        self.slice_damaged[:] = False
        self.base.reset()

    def decode_frame(self, pkt: bytes):
        f = self.base
        rc = RangeDecoder(pkt, *default_state_tables())
        keystate = np.array([128], dtype=np.uint8)
        keyframe = bool(rc.get_rac(keystate, 0))
        if keyframe:
            planes, _ = f.decode_frame(pkt)
            self.ref_planes = [np.asarray(p).copy() for p in planes]
            self.pstates = [_PSliceState() for _ in f.slices]
            self.slice_damaged[:] = False
            return planes, True
        if self.ref_planes is None:
            raise ValueError("cannot decode non-keyframe without keyframe")

        rp = f.rp if hasattr(f, "rp") else f
        bits = f.bits_per_raw_sample
        mid = 1 << (bits - 1)
        offset = 1 << bits
        out = [p.copy() for p in self.ref_planes]

        bounds = self._split_slices(pkt)
        for si, (start, end) in enumerate(bounds):
            if f.ec and crc32_ieee(pkt[start:end]) != 0:
                self.slice_damaged[si] = True
                continue
            buf = pkt[start:end] if si else pkt[:end]
            src = RangeDecoder(buf)
            src.set_tables(*self._tables)
            if si == 0:
                src.low, src.range, src.pos = rc.low, rc.range, rc.pos
            try:
                self._decode_slice_p(si, buf, src, out, mid, offset, bits)
            except (ValueError, IndexError):
                self.slice_damaged[si] = True

        # concealment: damaged slices keep the previous picture's rect
        # (out started as a copy of it), matching ffv1dec.c:1001-1021
        self.ref_planes = [p.copy() for p in out]
        return out, False

    def _split_slices(self, pkt: bytes):
        f = self.base
        trailer = 3 + 5 * (1 if f.ec else 0)
        p = len(pkt)
        bounds = []
        while len(bounds) < T.MAX_SLICES and p > 3:
            size = int.from_bytes(pkt[p - trailer:p - trailer + 3], "big")
            if size + trailer > p:
                break
            bounds.append((p - size - trailer, p))
            p -= size + trailer
        bounds.reverse()
        if len(bounds) != len(f.slices):
            raise ValueError("slice count mismatch")
        return bounds

    def _decode_slice_p(self, si, buf, src, out, mid, offset, bits):
        f = self.base
        ps = self.pstates[si]
        ss = f.slices[si]
        geom = ss.geom
        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        bh = pad_to_block(np.zeros((h, 1)), BLOCK).shape[0] // BLOCK
        bw = pad_to_block(np.zeros((1, w)), BLOCK).shape[1] // BLOCK

        fresh = ps.flag_state is None
        if fresh:
            ps.flag_state = np.full(32, 128, np.uint8)
            ps.mv_states = np.full((2, 32), 128, np.uint8)
            ps.prev_mvs = np.zeros((bh, bw, 2), np.int32)
            import copy
            ps.ss = copy.deepcopy(ss)

        qidxs, _ = read_slice_header(f, ps.ss, src)
        if fresh:
            f._ensure_plane_states(ps.ss, qidxs)
            f._clear_slice(ps.ss)

        mvs = np.zeros((bh, bw, 2), np.int32)
        intra = np.zeros((bh, bw), bool)
        for by in range(bh):
            for bx in range(bw):
                inter = get_symbol(src, ps.flag_state, True)
                if inter:
                    mvs[by, bx, 0] = ps.prev_mvs[by, bx, 0] + \
                        get_symbol(src, ps.mv_states[0], True)
                    mvs[by, bx, 1] = ps.prev_mvs[by, bx, 1] + \
                        get_symbol(src, ps.mv_states[1], True)
                else:
                    intra[by, bx] = True
        ps.prev_mvs = np.where(intra[..., None], ps.prev_mvs, mvs)

        # residual planes, then OBMC reconstruction
        jobs = [(0, w, h, x, y, 0, (BLOCK, BLOCK), mvs)]
        if f.chroma_planes:
            hs, vs = f.chroma_h_shift, f.chroma_v_shift
            cw, ch = ceil_rshift(w, hs), ceil_rshift(h, vs)
            cblk = (max(BLOCK >> vs, 2), max(BLOCK >> hs, 2))
            cmvs = np.stack([mvs[..., 0] >> vs, mvs[..., 1] >> hs], -1)
            jobs.append((1, cw, ch, x >> hs, y >> vs, 1, cblk, cmvs))
            jobs.append((2, cw, ch, x >> hs, y >> vs, 1, cblk, cmvs))
        if f.transparency:
            jobs.append((len(out) - 1, w, h, x, y,
                         2 if f.chroma_planes else 1, (BLOCK, BLOCK), mvs))

        coder = (src, None)
        rpv = _Bits9View(f._dec_rp())
        use_native = getattr(f, "engine", "spec") == "native"
        if use_native:
            from .. import native as N
        for (pl, pw, ph, px, py, pi, blk, pmvs) in jobs:
            res = np.zeros((ph, pw), np.uint16)
            if use_native:
                N.decode_plane(rpv, ps.ss, None, coder, res, pw, ph, pi,
                               bits + 1, buf)
            else:
                from ..codec.slice_codec import decode_plane
                decode_plane(rpv, ps.ss, coder, res, pw, ph, pi, bits + 1)
            res = res.astype(np.int32)
            ref_pad = pad_to_block(
                np.asarray(self.ref_planes[pl][py:py + ph, px:px + pw]),
                blk).astype(np.int32)
            pred = obmc_predict(ref_pad, pmvs, intra, mid, *blk)
            rec = pred[:ph, :pw] + res - offset
            rec = np.clip(rec, 0, (1 << bits) - 1)
            out[pl][py:py + ph, px:px + pw] = rec.astype(out[pl].dtype)

        sentinel = np.array([129], dtype=np.uint8)
        src.get_rac(sentinel, 0)
        v = (len(buf) - src.pos) - 2 - 5 * (1 if f.ec else 0)
        if v:
            raise ValueError(f"slice {si} bytestream end mismatch by {v}")
