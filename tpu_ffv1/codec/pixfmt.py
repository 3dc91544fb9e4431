"""Pixel-format registry for the FFV1 framework.

Covers every format the reference encoder advertises
(libavcodec/ffv1enc.c:1425-1438) plus the decoder's reconstruction map
(libavcodec/ffv1dec.c:698-790).

Frame data convention used throughout this framework:
  * colorspace 0 (YUV/gray): list of planar numpy arrays
      [Y(H,W)], [+U,V at chroma dims], [+A(H,W)];
      dtype uint8 for bits<=8 else uint16.
  * ya8: single (H, W, 2) uint8 array (interleaved luma/alpha, step 2).
  * colorspace 1, <=8 bit (rgb32 / 0rgb32): single (H, W, 4) uint8 array in
    memory byte order B,G,R,A (AV_PIX_FMT_RGB32 on little-endian).
  * colorspace 1, >8 bit (gbrp9..14): three (H, W) uint16 planes in FFmpeg
    plane order data[0]=G, data[1]=B, data[2]=R.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PixFmt:
    name: str
    colorspace: int           # 0 = YUV/gray, 1 = RGB
    bits: int                 # bits per raw sample the encoder selects
    chroma_h_shift: int
    chroma_v_shift: int
    chroma_planes: bool
    transparency: bool
    packed_at_lsb: bool       # 16-bit container holds value in low bits
    interleaved: bool = False  # ya8 / rgb32-style packed storage
    comp_step: int = 1        # bytes per sample step of component 0 (ps)


def _yuv(name, bits, hs, vs, alpha=False, lsb=False):
    step = 1 if bits <= 8 else 2
    return PixFmt(name, 0, bits, hs, vs, True, alpha, lsb, False, step)


_FORMATS = {}


def _reg(fmt: PixFmt):
    _FORMATS[fmt.name] = fmt


# --- grayscale ---
_reg(PixFmt("gray8", 0, 8, 0, 0, False, False, False, False, 1))
_reg(PixFmt("gray16le", 0, 16, 0, 0, False, False, False, False, 2))
_reg(PixFmt("ya8", 0, 8, 0, 0, False, True, False, True, 2))

# --- planar YUV 8-bit ---
for name, hs, vs in [("yuv444p", 0, 0), ("yuv440p", 0, 1), ("yuv422p", 1, 0),
                     ("yuv420p", 1, 1), ("yuv411p", 2, 0), ("yuv410p", 2, 2)]:
    _reg(_yuv(name, 8, hs, vs))
for name, hs, vs in [("yuva444p", 0, 0), ("yuva422p", 1, 0), ("yuva420p", 1, 1)]:
    _reg(_yuv(name, 8, hs, vs, alpha=True))

# --- planar YUV 9/10/16-bit (9/10 packed at LSB; 16 full range) ---
for bits, lsb in [(9, True), (10, True), (16, False)]:
    for name_base, hs, vs in [("444", 0, 0), ("422", 1, 0), ("420", 1, 1)]:
        _reg(_yuv(f"yuv{name_base}p{bits}le" if bits != 16 else f"yuv{name_base}p16le",
                  bits, hs, vs, lsb=lsb))
        _reg(_yuv(f"yuva{name_base}p{bits}le" if bits != 16 else f"yuva{name_base}p16le",
                  bits, hs, vs, alpha=True, lsb=lsb))

# --- packed RGB 8-bit (memory order B,G,R,A / B,G,R,X) ---
_reg(PixFmt("bgra", 1, 8, 0, 0, True, True, False, True, 4))   # AV_PIX_FMT_RGB32 (LE)
_reg(PixFmt("bgr0", 1, 8, 0, 0, True, False, False, True, 4))  # AV_PIX_FMT_0RGB32 (LE)

# --- planar GBR >8-bit ---
for bits in (9, 10, 12, 14):
    _reg(PixFmt(f"gbrp{bits}le", 1, bits, 0, 0, True, False, True, False, 2))

# aliases without the "le" suffix
for alias, target in [("gray16", "gray16le"), ("gray", "gray8"),
                      ("rgb32", "bgra"), ("0rgb32", "bgr0")] + [
        (f"yuv{c}p{b}", f"yuv{c}p{b}le") for c in ("444", "422", "420") for b in (9, 10, 16)] + [
        (f"yuva{c}p{b}", f"yuva{c}p{b}le") for c in ("444", "422", "420") for b in (9, 10, 16)] + [
        (f"gbrp{b}", f"gbrp{b}le") for b in (9, 10, 12, 14)]:
    _FORMATS[alias] = _FORMATS[target]


def get_pix_fmt(name: str) -> PixFmt:
    try:
        return _FORMATS[name]
    except KeyError:
        raise ValueError(f"unsupported pix_fmt: {name!r}") from None


def reconstruct_pix_fmt(colorspace: int, bits: int, chroma_planes: bool,
                        hs: int, vs: int, transparency: bool) -> str:
    """Decoder-side pix_fmt reconstruction (ffv1dec.c:698-790)."""
    if colorspace == 0:
        if not transparency and not chroma_planes:
            return "gray8" if bits <= 8 else "gray16le"
        if transparency and not chroma_planes:
            if bits <= 8:
                return "ya8"
            raise ValueError("gray+alpha >8 bit unsupported")
        a = "a" if transparency else ""
        sub = {(0, 0): "444", (0, 1): "440", (1, 0): "422", (1, 1): "420",
               (2, 0): "411", (2, 2): "410"}[(hs, vs)]
        if bits <= 8:
            return f"yuv{a}{sub}p"
        return f"yuv{a}{sub}p{bits}le"
    if colorspace == 1:
        if hs or vs:
            raise ValueError("chroma subsampling invalid for RGB")
        if bits <= 8:
            return "bgra" if transparency else "bgr0"
        return f"gbrp{bits}le"
    raise ValueError(f"unsupported colorspace {colorspace}")
