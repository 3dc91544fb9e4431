"""Minimal swscale analog: bit-exact planar conversions for the CLI.

The FATE harness routes every vcodec test through swscale with
``-sws_flags neighbor+bitexact`` (tests/fate/vcodec.mak:119-121,
tests/fate-run.sh:168); this module reproduces the subset those tests
need, byte-identically to the reference library:

* bit-depth changes between planar YUV/gray formats — the unscaled
  planar copy path (libswscale/swscale_unscaled.c:1408
  ``planarCopyWrapper``):
    - up-conversions shift left (``shiftonly`` applies to chroma and
      limited-range luma, :1421, :1453-1461)
    - down-conversions apply the ordered-dither copy
      (``DITHER_COPY``, :1387-1406) with the normative ``dithers`` and
      ``dither_scale`` tables (:37-128)
* chroma subsampling changes (444/440/422/420/411/410) with the
  nearest-neighbor sample rule of SWS_POINT: src = floor((dst+0.5) *
  src_size/dst_size) — verified against the reference binary
  (tests/test_swscale.py)
* packed RGB (bgr0/bgra) <-> planar YUV via the integer BT.601
  limited-range transform (libswscale/yuv2rgb.c tables); interop
  accuracy only — FATE itself asserts PSNR, not bytes, on RGB
  conversions (tests/ref/vsynth/vsynth1-ffv1-v3-bgr0:4)

Conversions are host-side numpy (IO tier, not the device compute path).
"""
from __future__ import annotations

import numpy as np

from .codec.pixfmt import get_pix_fmt
from .core.intmath import ceil_rshift

# libswscale/swscale_unscaled.c:37-110 — ordered dither matrices for
# (src_depth - 9) in 0..7, i.e. 9..16-bit sources
DITHERS = np.array([
    [[0, 1, 0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0],
     [0, 1, 0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0],
     [0, 1, 0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0],
     [0, 1, 0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0]],
    [[1, 2, 1, 2, 1, 2, 1, 2], [3, 0, 3, 0, 3, 0, 3, 0],
     [1, 2, 1, 2, 1, 2, 1, 2], [3, 0, 3, 0, 3, 0, 3, 0],
     [1, 2, 1, 2, 1, 2, 1, 2], [3, 0, 3, 0, 3, 0, 3, 0],
     [1, 2, 1, 2, 1, 2, 1, 2], [3, 0, 3, 0, 3, 0, 3, 0]],
    [[2, 4, 3, 5, 2, 4, 3, 5], [6, 0, 7, 1, 6, 0, 7, 1],
     [3, 5, 2, 4, 3, 5, 2, 4], [7, 1, 6, 0, 7, 1, 6, 0],
     [2, 4, 3, 5, 2, 4, 3, 5], [6, 0, 7, 1, 6, 0, 7, 1],
     [3, 5, 2, 4, 3, 5, 2, 4], [7, 1, 6, 0, 7, 1, 6, 0]],
    [[4, 8, 7, 11, 4, 8, 7, 11], [12, 0, 15, 3, 12, 0, 15, 3],
     [6, 10, 5, 9, 6, 10, 5, 9], [14, 2, 13, 1, 14, 2, 13, 1],
     [4, 8, 7, 11, 4, 8, 7, 11], [12, 0, 15, 3, 12, 0, 15, 3],
     [6, 10, 5, 9, 6, 10, 5, 9], [14, 2, 13, 1, 14, 2, 13, 1]],
    [[9, 17, 15, 23, 8, 16, 14, 22], [25, 1, 31, 7, 24, 0, 30, 6],
     [13, 21, 11, 19, 12, 20, 10, 18], [29, 5, 27, 3, 28, 4, 26, 2],
     [8, 16, 14, 22, 9, 17, 15, 23], [24, 0, 30, 6, 25, 1, 31, 7],
     [12, 20, 10, 18, 13, 21, 11, 19], [28, 4, 26, 2, 29, 5, 27, 3]],
    [[18, 34, 30, 46, 17, 33, 29, 45], [50, 2, 62, 14, 49, 1, 61, 13],
     [26, 42, 22, 38, 25, 41, 21, 37], [58, 10, 54, 6, 57, 9, 53, 5],
     [16, 32, 28, 44, 19, 35, 31, 47], [48, 0, 60, 12, 51, 3, 63, 15],
     [24, 40, 20, 36, 27, 43, 23, 39], [56, 8, 52, 4, 59, 11, 55, 7]],
    [[18, 34, 30, 46, 17, 33, 29, 45], [50, 2, 62, 14, 49, 1, 61, 13],
     [26, 42, 22, 38, 25, 41, 21, 37], [58, 10, 54, 6, 57, 9, 53, 5],
     [16, 32, 28, 44, 19, 35, 31, 47], [48, 0, 60, 12, 51, 3, 63, 15],
     [24, 40, 20, 36, 27, 43, 23, 39], [56, 8, 52, 4, 59, 11, 55, 7]],
    [[36, 68, 60, 92, 34, 66, 58, 90], [100, 4, 124, 28, 98, 2, 122, 26],
     [52, 84, 44, 76, 50, 82, 42, 74], [116, 20, 108, 12, 114, 18, 106, 10],
     [32, 64, 56, 88, 38, 70, 62, 94], [96, 0, 120, 24, 102, 6, 126, 30],
     [48, 80, 40, 72, 54, 86, 46, 78], [112, 16, 104, 8, 118, 22, 110, 14]],
], dtype=np.int64)

# libswscale/swscale.c:39-49 — the vertical output stage's ordered
# dither for >8-bit sources reduced to 8 bits (row = dstY & 7)
DITHER_8X8_128 = np.array([
    [36, 68, 60, 92, 34, 66, 58, 90],
    [100, 4, 124, 28, 98, 2, 122, 26],
    [52, 84, 44, 76, 50, 82, 42, 74],
    [116, 20, 108, 12, 114, 18, 106, 10],
    [32, 64, 56, 88, 38, 70, 62, 94],
    [96, 0, 120, 24, 102, 6, 126, 30],
    [48, 80, 40, 72, 54, 86, 46, 78],
    [112, 16, 104, 8, 118, 22, 110, 14],
], dtype=np.int64)

# libswscale/swscale_unscaled.c:112-128
DITHER_SCALE = np.array([
    [2, 3, 3, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5],
    [2, 3, 7, 7, 13, 13, 25, 25, 25, 25, 25, 25, 25, 25, 25, 25],
    [3, 3, 4, 15, 15, 29, 57, 57, 57, 113, 113, 113, 113, 113, 113, 113],
    [3, 4, 4, 5, 31, 31, 61, 121, 241, 241, 241, 241, 481, 481, 481, 481],
    [3, 4, 5, 5, 6, 63, 63, 125, 249, 497, 993, 993, 993, 993, 993, 1985],
    [3, 5, 6, 6, 6, 7, 127, 127, 253, 505, 1009, 2017, 4033, 4033, 4033,
     4033],
    [3, 5, 6, 7, 7, 7, 8, 255, 255, 509, 1017, 2033, 4065, 8129, 16257,
     16257],
    [3, 5, 6, 8, 8, 8, 8, 9, 511, 511, 1021, 2041, 4081, 8161, 16321,
     32641],
    [3, 5, 7, 8, 9, 9, 9, 9, 10, 1023, 1023, 2045, 4089, 8177, 16353,
     32705],
    [3, 5, 7, 8, 10, 10, 10, 10, 10, 11, 2047, 2047, 4093, 8185, 16369,
     32737],
    [3, 5, 7, 8, 10, 11, 11, 11, 11, 11, 12, 4095, 4095, 8189, 16377,
     32753],
    [3, 5, 7, 9, 10, 12, 12, 12, 12, 12, 12, 13, 8191, 8191, 16381, 32761],
    [3, 5, 7, 9, 10, 12, 13, 13, 13, 13, 13, 13, 14, 16383, 16383, 32765],
    [3, 5, 7, 9, 10, 12, 14, 14, 14, 14, 14, 14, 14, 15, 32767, 32767],
    [3, 5, 7, 9, 11, 12, 14, 15, 15, 15, 15, 15, 15, 15, 16, 65535],
], dtype=np.int64)


def _depth_convert(plane: np.ndarray, src_depth: int, dst_depth: int,
                   shiftonly: bool = True) -> np.ndarray:
    """One plane's bit-depth change, byte-exact to planarCopyWrapper.

    ``shiftonly`` matches swscale_unscaled.c:1421 — true for chroma and
    limited-range luma (all YUV handled here); full-range up-conversions
    replicate high bits into the low bits instead.
    """
    p = plane.astype(np.int64)
    if src_depth == dst_depth:
        return plane.copy()
    if src_depth < dst_depth:
        if shiftonly:
            out = p << (dst_depth - src_depth)
        else:
            out = (p << (dst_depth - src_depth)) | \
                (p >> (2 * src_depth - dst_depth))
        return out.astype(np.uint8 if dst_depth <= 8 else np.uint16)
    # down-conversion: DITHER_COPY (swscale_unscaled.c:1387-1406)
    scale = int(DITHER_SCALE[dst_depth - 1][src_depth - 1])
    shift = src_depth - dst_depth + int(
        DITHER_SCALE[src_depth - 2][dst_depth - 1])
    h, w = p.shape
    dith = DITHERS[src_depth - 9]
    tiled = dith[np.arange(h)[:, None] & 7, np.arange(w)[None, :] & 7]
    out = ((p + tiled) * scale) >> shift
    return out.astype(np.uint8 if dst_depth <= 8 else np.uint16)


def _scaler_plane(plane: np.ndarray, src_depth: int, dst_depth: int,
                  dst_h: int, dst_w: int, range_conv: str | None,
                  chroma: bool, dither_offset: int = 0) -> np.ndarray:
    """One plane through the real scaler pipeline — the path swscale
    takes whenever subsampling or range changes (SWS_POINT, bitexact):

      hScale (neighbor pick + promote to the 15- or 19-bit intermediate,
      swscale.c:66-150; truncating shifts) -> optional range conversion
      (swscale.c:154-184) -> vertical neighbor pick -> yuv2plane1 output
      (output.c:144-276; +dither/rounding, clipped).

    ``range_conv``: None | 'to_jpeg' | 'from_jpeg' (luma limited<->full,
    e.g. yuv<->gray).  8-bit output from >8-bit sources uses the
    ff_dither_8x8_128 ordered dither (swscale.c:487-489); constant 64
    otherwise (swscale.c:345-346).
    """
    p = _resample(plane, dst_h, dst_w).astype(np.int64)
    wide = dst_depth > 14                     # 19-bit intermediate
    if wide:
        inter = (p * (1 << 14)) >> (src_depth - 5) if src_depth > 8 \
            else p << 11
        inter = np.minimum(inter, (1 << 19) - 1)
        if range_conv is not None:
            raise ValueError("range conversion to 16-bit: unsupported")
        return np.clip((inter + 4) >> 3, 0, 65535).astype(np.uint16)
    inter = (p * (1 << 14)) >> (src_depth - 1) if src_depth > 8 \
        else p << 7
    inter = np.minimum(inter, (1 << 15) - 1)
    if range_conv == "to_jpeg":
        if chroma:
            inter = (np.minimum(inter, 30775) * 4663 - 9289992) >> 12
        else:
            inter = (np.minimum(inter, 30189) * 19077 - 39057361) >> 14
    elif range_conv == "from_jpeg":
        if chroma:
            inter = (inter * 1799 + 4081085) >> 11
        else:
            inter = (inter * 14071 + 33561947) >> 14
    if dst_depth == 8:
        if src_depth > 8:
            # the V plane's dither columns are rotated by 3
            # (vscale.c:91: yuv2plane1(..., c->chrDither8, 3))
            h, w = inter.shape
            dith = DITHER_8X8_128[
                np.arange(h)[:, None] & 7,
                (np.arange(w)[None, :] + dither_offset) & 7]
        else:
            dith = 64
        return np.clip((inter + dith) >> 7, 0, 255).astype(np.uint8)
    shift = 15 - dst_depth
    out = (inter + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, (1 << dst_depth) - 1).astype(np.uint16)


def _nearest_axis(n_dst: int, n_src: int) -> np.ndarray:
    """SWS_POINT sample rule, bit-exact to the reference filter-position
    build (libswscale/utils.c):

      xInc = ((srcW << 16) + (dstW >> 1)) / dstW          (:1257)
      pos  = 128 on both sides (get_local_pos, :284-291 — the luma
             positions and every default chroma position resolve to
             128), so xDstInSrc starts at ((128*xInc)>>8) - 0x8000
             and xx_i = (xDstInSrc + (1<<15)) >> 16        (:344-358)
      borders clamp to [0, srcW-1]                         (:627-641)

    Equivalent to floor((dst+0.5)*src/dst) only at integer ratios; the
    fixed-point rounding differs at fractional ones (e.g. 48 -> 20),
    and the reference's near-unity fast path (:333, |xInc-2^16| < 10)
    is identity."""
    xinc = ((n_src << 16) + (n_dst >> 1)) // n_dst
    if abs(xinc - 0x10000) < 10:
        return np.minimum(np.arange(n_dst), n_src - 1)
    idx = (((128 * xinc) >> 8) +
           np.arange(n_dst, dtype=np.int64) * xinc) >> 16
    return np.clip(idx, 0, n_src - 1)


def _resample(plane: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    h, w = plane.shape
    if (h, w) == (dst_h, dst_w):
        return plane
    return plane[_nearest_axis(dst_h, h)[:, None],
                 _nearest_axis(dst_w, w)[None, :]]


def _yuv2rgb_bt601(y, u, v, bits):
    """Integer BT.601 limited-range YUV -> 8-bit RGB (interop tier;
    coefficient layout of libswscale/yuv2rgb.c)."""
    y = y.astype(np.int64) >> (bits - 8) if bits > 8 else y.astype(np.int64)
    u = u.astype(np.int64) >> (bits - 8) if bits > 8 else u.astype(np.int64)
    v = v.astype(np.int64) >> (bits - 8) if bits > 8 else v.astype(np.int64)
    cy = (255 << 16) // 219
    yv = (y - 16) * cy + (1 << 15)
    r = (yv + 104597 * (v - 128)) >> 16
    g = (yv - 25675 * (u - 128) - 53279 * (v - 128)) >> 16
    b = (yv + 132201 * (u - 128)) >> 16
    clip = lambda x: np.clip(x, 0, 255).astype(np.uint8)  # noqa: E731
    return clip(r), clip(g), clip(b)


def _rgb2yuv_bt601(r, g, b):
    """Integer BT.601 limited-range 8-bit RGB -> YUV (interop tier)."""
    r = r.astype(np.int64)
    g = g.astype(np.int64)
    b = b.astype(np.int64)
    y = (16829 * r + 33039 * g + 6416 * b + (16 << 16) + (1 << 15)) >> 16
    u = (-9714 * r - 19071 * g + 28784 * b + (128 << 16) + (1 << 15)) >> 16
    v = (28784 * r - 24103 * g - 4681 * b + (128 << 16) + (1 << 15)) >> 16
    clip = lambda x: np.clip(x, 0, 255).astype(np.uint8)  # noqa: E731
    return clip(y), clip(u), clip(v)


def scale_convert(frame, src_fmt: str, dst_fmt: str,
                  src_w: int, src_h: int, dst_w: int, dst_h: int):
    """ONE sws pass that resizes AND converts (the vf_scale case when
    lavfi format negotiation assigns the scale filter a different
    output format): hScale/vScale nearest pick straight to the
    destination plane geometry, then the intermediate-domain output
    stage (dither/rounding) at destination coordinates.  This is NOT
    the same bytes as resize-then-convert — the composition of two
    nearest maps and a pre-resize dither differ from the single pass.

    Only planar YUV/gray pairs (the scaler path of convert()); when
    the size is unchanged sws takes its unscaled path instead
    (swscale.c:1678 check), so callers should use convert() there.
    """
    sf = get_pix_fmt(src_fmt)
    df = get_pix_fmt(dst_fmt)
    if sf.interleaved or df.interleaved or sf.colorspace == 1 \
            or df.colorspace == 1:
        raise ValueError(f"scale+convert {src_fmt} -> {dst_fmt}: only "
                         "planar YUV/gray (insert format=... around "
                         "the scale)")
    planes = [np.asarray(p) for p in frame]
    src_full = not sf.chroma_planes
    dst_full = not df.chroma_planes
    range_conv = None
    if src_full != dst_full:
        range_conv = "to_jpeg" if dst_full else "from_jpeg"
    out = [_scaler_plane(planes[0], sf.bits, df.bits, dst_h, dst_w,
                         range_conv, chroma=False)]
    if df.chroma_planes:
        ch = ceil_rshift(dst_h, df.chroma_v_shift)
        cw = ceil_rshift(dst_w, df.chroma_h_shift)
        if sf.chroma_planes:
            for k in (1, 2):
                out.append(_scaler_plane(planes[k], sf.bits, df.bits,
                                         ch, cw, range_conv, chroma=True,
                                         dither_offset=3 * (k == 2)))
        else:
            mid = 1 << (df.bits - 1) if df.bits > 8 else 128
            dt = np.uint8 if df.bits <= 8 else np.uint16
            out.append(np.full((ch, cw), mid, dt))
            out.append(np.full((ch, cw), mid, dt))
    if df.transparency:
        mx = (1 << df.bits) - 1
        dt = np.uint8 if df.bits <= 8 else np.uint16
        if sf.transparency:
            out.append(_scaler_plane(planes[-1], sf.bits, df.bits,
                                     dst_h, dst_w, None, chroma=False))
        else:
            out.append(np.full((dst_h, dst_w), mx, dt))
    return out


def convert(frame, src_fmt: str, dst_fmt: str, width: int, height: int):
    """Convert one frame between pixel formats (frame data convention of
    codec/pixfmt.py).  Raises ValueError for unsupported pairs."""
    sf = get_pix_fmt(src_fmt)
    df = get_pix_fmt(dst_fmt)
    if sf.name == df.name:
        return frame

    # normalize the source to planar YUV/gray or RGB planes
    if sf.colorspace == 1:
        if not df.colorspace == 1 and df.interleaved is False:
            # RGB -> planar YUV
            if sf.interleaved:
                arr = np.asarray(frame)
                b, g, r = arr[..., 0], arr[..., 1], arr[..., 2]
            else:
                # gbrp: plane order G, B, R
                g, b, r = [np.asarray(p) for p in frame[:3]]
                if sf.bits > 8:
                    sh = sf.bits - 8
                    g, b, r = g >> sh, b >> sh, r >> sh
            y, u, v = _rgb2yuv_bt601(r, g, b)
            yuv = [y.astype(np.uint8),
                   _resample(u, ceil_rshift(height, df.chroma_v_shift),
                             ceil_rshift(width, df.chroma_h_shift)),
                   _resample(v, ceil_rshift(height, df.chroma_v_shift),
                             ceil_rshift(width, df.chroma_h_shift))]
            if df.bits != 8:
                yuv = [_depth_convert(p, 8, df.bits) for p in yuv]
            if df.transparency:
                yuv.append(np.full((height, width),
                                   (1 << df.bits) - 1,
                                   np.uint8 if df.bits <= 8 else np.uint16))
            if not df.chroma_planes:
                yuv = [yuv[0]]
            return yuv
        raise ValueError(f"unsupported conversion {src_fmt} -> {dst_fmt}")

    if df.colorspace == 1:
        # planar YUV -> RGB
        y = np.asarray(frame[0])
        if sf.chroma_planes:
            u = _resample(np.asarray(frame[1]), height, width)
            v = _resample(np.asarray(frame[2]), height, width)
        else:
            mid = 128 << (sf.bits - 8) if sf.bits > 8 else 128
            dt = np.uint8 if sf.bits <= 8 else np.uint16
            u = np.full((height, width), mid, dt)
            v = np.full((height, width), mid, dt)
        r, g, b = _yuv2rgb_bt601(y, u, v, sf.bits)
        if df.interleaved:
            out = np.zeros((height, width, 4), np.uint8)
            out[..., 0] = b
            out[..., 1] = g
            out[..., 2] = r
            if df.transparency:
                out[..., 3] = 255
            return out
        sh = df.bits - 8
        return [(g.astype(np.uint16) << sh), (b.astype(np.uint16) << sh),
                (r.astype(np.uint16) << sh)]

    if sf.interleaved or df.interleaved:
        raise ValueError(f"unsupported conversion {src_fmt} -> {dst_fmt}")

    # planar YUV/gray -> planar YUV/gray.  Gray formats are full-range
    # (JPEG levels); planar YUV is limited — a range change or a
    # subsampling change routes through the real scaler pipeline, the
    # rest through the unscaled planar copy (swscale_unscaled.c:1743+
    # dispatch).
    planes = [np.asarray(p) for p in frame]
    src_full = not sf.chroma_planes            # gray8/gray16
    dst_full = not df.chroma_planes
    same_sub = (sf.chroma_planes == df.chroma_planes and
                sf.chroma_h_shift == df.chroma_h_shift and
                sf.chroma_v_shift == df.chroma_v_shift)
    range_conv = None
    if src_full != dst_full:
        range_conv = "to_jpeg" if dst_full else "from_jpeg"
    out = []
    if same_sub and range_conv is None:
        # planarCopyWrapper: shiftonly for limited-range luma and all
        # chroma; full-range (gray) luma replicates high bits into low
        out.append(_depth_convert(planes[0], sf.bits, df.bits,
                                  shiftonly=not src_full))
        if df.chroma_planes:
            out.append(_depth_convert(planes[1], sf.bits, df.bits))
            out.append(_depth_convert(planes[2], sf.bits, df.bits))
    else:
        out.append(_scaler_plane(planes[0], sf.bits, df.bits, height,
                                 width, range_conv, chroma=False))
        if df.chroma_planes:
            ch = ceil_rshift(height, df.chroma_v_shift)
            cw = ceil_rshift(width, df.chroma_h_shift)
            if sf.chroma_planes:
                for k in (1, 2):
                    out.append(_scaler_plane(planes[k], sf.bits, df.bits,
                                             ch, cw, range_conv,
                                             chroma=True,
                                             dither_offset=3 * (k == 2)))
            else:
                mid = 1 << (df.bits - 1) if df.bits > 8 else 128
                dt = np.uint8 if df.bits <= 8 else np.uint16
                out.append(np.full((ch, cw), mid, dt))
                out.append(np.full((ch, cw), mid, dt))
    if df.transparency:
        if sf.transparency:
            out.append(_depth_convert(planes[-1], sf.bits, df.bits))
        else:
            mx = (1 << df.bits) - 1
            dt = np.uint8 if df.bits <= 8 else np.uint16
            out.append(np.full((height, width), mx, dt))
    return out
