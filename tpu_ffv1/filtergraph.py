"""Linear video filtergraph — the ffmpeg `-vf` chain analog.

The reference builds a full libavfilter graph from the `-vf` string
(`ffmpeg_filter.c:979` configure_filtergraph ->
`avfilter_graph_parse2`, `ffmpeg_filter.c:1027`); FFV1 workflows use it
as a LINEAR chain (source -> filters -> sink), which is the scope here.
Labeled pads / multi-branch graphs (`[a]split[b]` syntax) are rejected
with a clear error.

Filters (reference semantics, file:line cited per class):

  null, copy          vf_null.c / vf_copy.c — identity
  format=FMT[|FMT..]  vf_format.c — converts to the first listed format
                      the framework supports (the reference constrains
                      pad formats and lets lavfi auto-insert sws;
                      a linear chain converts in place, byte-identical
                      to the swscale analog's neighbor+bitexact path)
  scale=W:H           vf_scale.c SWS_POINT+bitexact subset: nearest
                      sample rule per plane (swscale.h SWS_POINT;
                      sample positions swscale.py:_nearest_axis);
                      0 keeps the source size, negative values keep
                      aspect (vf_scale.c:303-326: av_rescale to the
                      other axis, snapped to a multiple of -n)
  crop=W:H[:x:y]      vf_crop.c — default centred (:344-345
                      x=(in_w-out_w)/2), x/y aligned down to the chroma
                      grid (:222-223 `x &= ~((1<<hsub)-1)`)
  hflip / vflip       vf_hflip.c / vf_vflip.c — per-plane mirror
  transpose=DIR       vf_transpose.c — 0 ccw+vflip, 1 cw, 2 ccw,
                      3 cw+vflip; requires square subsampling
                      (hsub == vsub), as the output chroma grid of a
                      rotated 422 frame is not expressible
  trim=start_frame=N:end_frame=M
                      vf_trim.c frame-count subset — drops frames
                      outside [N, M)

Scale/format conversions run through the swscale analog
(tpu_ffv1/swscale.py), which is byte-identical to the reference's
`-sws_flags neighbor+bitexact` paths for planar YUV/gray; parity is
asserted against the reference binary in tests/test_filtergraph.py.

Filtering is host-side numpy (IO tier): frames at the CLI boundary are
host arrays on both ends, and these ops are memory-bound reshuffles a
device round trip would only slow down.  The device compute tier
starts at the codec (tpu_ffv1/tpu).
"""
from __future__ import annotations

import numpy as np

from .codec.pixfmt import get_pix_fmt
from .core.intmath import ceil_rshift
from .swscale import convert, scale_convert, _resample


def _rescale_near(a: int, b: int, c: int) -> int:
    """av_rescale with AV_ROUND_NEAR_INF for positive operands
    (mathematics.c): round-half-away."""
    return (a * b + c // 2) // c


class _Filter:
    name = "?"

    def configure(self, fmt: str, w: int, h: int):
        """Returns the output (fmt, w, h)."""
        return fmt, w, h

    def apply(self, frame, n: int):
        """Transform one frame (may return None to drop it)."""
        return frame


class _Null(_Filter):
    """vf_null.c / vf_copy.c (copy clones the buffer; frames here are
    already per-node arrays, so both are the identity)."""

    def __init__(self, name, args):
        self.name = name
        if args:
            raise ValueError(f"{name} takes no arguments")


class _Format(_Filter):
    """vf_format.c — constrains the link format.  The filter itself is
    passthrough; when the negotiated upstream format is not in the list
    lavfi auto-inserts an sws converter on the input link
    (avfiltergraph.c query_formats merge failure), which is what
    ``apply`` performs here."""
    name = "format"

    def __init__(self, name, args):
        pix = args.get("pix_fmts") or args.get(0)
        if not pix:
            raise ValueError("format: missing pix_fmts")
        self.choices = str(pix).split("|")

    def configure(self, fmt, w, h):
        if fmt in self.choices:             # negotiated: no conversion
            self.src_fmt = self.dst_fmt = fmt
            return fmt, w, h
        for cand in self.choices:
            try:
                get_pix_fmt(cand)
            except (KeyError, ValueError):
                continue
            self.src_fmt, self.dst_fmt = fmt, cand
            self.w, self.h = w, h
            return cand, w, h
        raise ValueError(f"format: no supported format in {self.choices}")

    def apply(self, frame, n):
        if self.src_fmt == self.dst_fmt:
            return frame
        return convert(frame, self.src_fmt, self.dst_fmt, self.w, self.h)


class _Scale(_Filter):
    """vf_scale.c — and, per lavfi negotiation, the node that ABSORBS a
    downstream format constraint: when the next constrained link (a
    format filter's list, or the sink's pix_fmt) differs from the input,
    the resize and the conversion are ONE sws pass
    (swscale.scale_convert), which is not byte-equal to composing them.
    ``neg_dst_fmt`` is assigned by FilterGraph before configure()."""
    name = "scale"

    neg_dst_fmt = None

    def __init__(self, name, args):
        self.w_arg = int(args.get("w", args.get("width", args.get(0, 0))))
        self.h_arg = int(args.get("h", args.get("height", args.get(1, 0))))

    def configure(self, fmt, w, h):
        pf = get_pix_fmt(fmt)
        if pf.interleaved:
            raise ValueError("scale: packed RGB input unsupported; "
                             "insert format=... first")
        ow, oh = self.w_arg, self.h_arg
        # vf_scale.c:303-326 — 0 keeps the input size; -n derives the
        # axis from the other one at the input aspect, snapped to a
        # multiple of n
        fw = -ow if ow < 0 else 1
        fh = -oh if oh < 0 else 1
        if ow == 0:
            ow = w
        if oh == 0:
            oh = h
        if ow < 0 and oh < 0:
            ow, oh = w, h
        if ow < 0:
            ow = _rescale_near(oh, w, h * fw) * fw
        if oh < 0:
            oh = _rescale_near(ow, h, w * fh) * fh
        if ow <= 0 or oh <= 0:
            raise ValueError(f"scale: bad output size {ow}x{oh}")
        self.fmt, self.src_w, self.src_h = fmt, w, h
        self.dst_w, self.dst_h = int(ow), int(oh)
        self.dst_fmt = self.neg_dst_fmt or fmt
        return self.dst_fmt, self.dst_w, self.dst_h

    def apply(self, frame, n):
        resize = (self.src_w, self.src_h) != (self.dst_w, self.dst_h)
        if self.fmt != self.dst_fmt:
            if not resize:
                # equal dims -> sws takes the unscaled converter path
                # (swscale.c:1678)
                return convert(frame, self.fmt, self.dst_fmt,
                               self.src_w, self.src_h)
            return scale_convert(frame, self.fmt, self.dst_fmt,
                                 self.src_w, self.src_h,
                                 self.dst_w, self.dst_h)
        if not resize:
            return frame
        pf = get_pix_fmt(self.fmt)
        out = []
        for i, p in enumerate(frame):
            chroma = pf.chroma_planes and i in (1, 2)
            hs = pf.chroma_h_shift if chroma else 0
            vs = pf.chroma_v_shift if chroma else 0
            out.append(_resample(np.asarray(p),
                                 ceil_rshift(self.dst_h, vs),
                                 ceil_rshift(self.dst_w, hs)))
        return out


class _Crop(_Filter):
    name = "crop"

    def __init__(self, name, args):
        self.w_arg = args.get("w", args.get("out_w", args.get(0)))
        self.h_arg = args.get("h", args.get("out_h", args.get(1)))
        self.x_arg = args.get("x", args.get(2))
        self.y_arg = args.get("y", args.get(3))

    def configure(self, fmt, w, h):
        pf = get_pix_fmt(fmt)
        if pf.interleaved:
            raise ValueError("crop: packed RGB input unsupported")
        ow = int(self.w_arg) if self.w_arg is not None else w
        oh = int(self.h_arg) if self.h_arg is not None else h
        # defaults centre the window (vf_crop.c:344-345)
        x = int(self.x_arg) if self.x_arg is not None else (w - ow) // 2
        y = int(self.y_arg) if self.y_arg is not None else (h - oh) // 2
        if not (0 < ow <= w and 0 < oh <= h):
            raise ValueError(f"crop: {ow}x{oh} out of {w}x{h}")
        x = max(0, min(x, w - ow))
        y = max(0, min(y, h - oh))
        # chroma-grid alignment (vf_crop.c:222-223)
        if pf.chroma_planes:
            x &= ~((1 << pf.chroma_h_shift) - 1)
            y &= ~((1 << pf.chroma_v_shift) - 1)
        self.fmt, self.x, self.y = fmt, x, y
        self.ow, self.oh = ow, oh
        return fmt, ow, oh

    def apply(self, frame, n):
        pf = get_pix_fmt(self.fmt)
        out = []
        for i, p in enumerate(frame):
            chroma = pf.chroma_planes and i in (1, 2)
            hs = pf.chroma_h_shift if chroma else 0
            vs = pf.chroma_v_shift if chroma else 0
            x, y = self.x >> hs, self.y >> vs
            out.append(np.asarray(p)[y:y + ceil_rshift(self.oh, vs),
                                     x:x + ceil_rshift(self.ow, hs)])
        return out


class _HFlip(_Filter):
    """vf_hflip.c — per-plane column mirror."""
    name = "hflip"

    def __init__(self, name, args):
        if args:
            raise ValueError("hflip takes no arguments")

    def apply(self, frame, n):
        return [np.asarray(p)[:, ::-1] for p in frame]


class _VFlip(_Filter):
    """vf_vflip.c — per-plane row mirror."""
    name = "vflip"

    def __init__(self, name, args):
        if args:
            raise ValueError("vflip takes no arguments")

    def apply(self, frame, n):
        return [np.asarray(p)[::-1, :] for p in frame]


class _Transpose(_Filter):
    name = "transpose"

    # vf_transpose.c dir values
    CCW_VFLIP, CW, CCW, CW_VFLIP = 0, 1, 2, 3

    def __init__(self, name, args):
        self.dir = int(args.get("dir", args.get(0, 0)))
        if self.dir not in (0, 1, 2, 3):
            raise ValueError(f"transpose: bad dir {self.dir}")

    def configure(self, fmt, w, h):
        pf = get_pix_fmt(fmt)
        if pf.interleaved:
            raise ValueError("transpose: packed RGB input unsupported")
        if pf.chroma_planes and pf.chroma_h_shift != pf.chroma_v_shift:
            raise ValueError(
                "transpose: needs square chroma subsampling "
                "(a rotated 422 chroma grid is not a pixel format)")
        return fmt, h, w

    def apply(self, frame, n):
        out = []
        for p in frame:
            a = np.asarray(p)
            if self.dir == self.CW:
                a = np.rot90(a, k=-1)
            elif self.dir == self.CCW:
                a = np.rot90(a, k=1)
            elif self.dir == self.CW_VFLIP:
                a = np.rot90(a, k=-1)[::-1, :]
            else:                              # CCW_VFLIP
                a = np.rot90(a, k=1)[::-1, :]
            out.append(np.ascontiguousarray(a))
        return out


class _Trim(_Filter):
    """vf_trim.c frame-count subset: keep frames n with
    start_frame <= n < end_frame."""
    name = "trim"

    def __init__(self, name, args):
        self.start = int(args.get("start_frame", args.get(0, 0)))
        end = args.get("end_frame", args.get(1))
        self.end = int(end) if end is not None else None

    def apply(self, frame, n):
        if n < self.start:
            return None
        if self.end is not None and n >= self.end:
            return None
        return frame


FILTERS = {
    "null": _Null, "copy": _Null, "format": _Format, "scale": _Scale,
    "crop": _Crop, "hflip": _HFlip, "vflip": _VFlip,
    "transpose": _Transpose, "trim": _Trim,
}


def _parse_args(argstr: str):
    """ffmpeg filter-arg syntax: ':'-separated, positional or
    key=value (avfilter.c av_opt_set_from_string semantics, shorthand
    first)."""
    args = {}
    if not argstr:
        return args
    for pos, part in enumerate(argstr.split(":")):
        if "=" in part:
            k, v = part.split("=", 1)
            args[k.strip()] = v.strip()
        else:
            args[pos] = part.strip()
    return args


def parse_graph(desc: str):
    """Parse a linear `-vf` chain into filter instances."""
    if any(c in desc for c in "[];"):
        raise ValueError(
            "only linear filter chains are supported (no labeled pads "
            "or multi-branch graphs)")
    nodes = []
    for seg in desc.split(","):
        seg = seg.strip()
        if not seg:
            continue
        name, _, argstr = seg.partition("=")
        name = name.strip()
        if name not in FILTERS:
            raise ValueError(f"unknown filter '{name}' (supported: "
                             f"{', '.join(sorted(FILTERS))})")
        nodes.append(FILTERS[name](name, _parse_args(argstr)))
    return nodes


def _pick_fmt(cur: str, choices):
    """pick_format subset for a constrained link: keep the incoming
    format when the list allows it (avfiltergraph.c's reduce step
    prefers no-conversion), else the first supported entry."""
    if choices is None or cur in choices:
        return cur
    for cand in choices:
        try:
            pf = get_pix_fmt(cand)
        except (KeyError, ValueError):
            continue
        if not pf.interleaved and pf.colorspace != 1:
            return cand
    return cur


class FilterGraph:
    """A configured linear chain: feed frames, get filtered frames.

    ``dst_fmt`` is the sink's format constraint (the CLI's ``-pix_fmt``,
    the buffersink/choose_pixel_fmt analog).  Negotiation follows
    lavfi's linear-chain behavior: each scale node's output format is
    the nearest downstream constrained link (a format filter's list or
    the sink), so resize+convert collapse into one sws pass; format
    nodes whose negotiated input already matches are passthrough; a
    trailing conversion is auto-inserted when nothing absorbed the sink
    constraint.

    >>> g = FilterGraph("scale=176:144,format=yuv422p", "yuv420p",
    ...                 352, 288)
    >>> g.out_fmt, g.out_w, g.out_h
    ('yuv422p', 176, 144)
    """

    def __init__(self, desc: str, src_fmt: str, width: int, height: int,
                 dst_fmt: str | None = None):
        self.nodes = parse_graph(desc)
        # backward sweep: nearest downstream format constraint per node
        nxt = [dst_fmt] if dst_fmt else None
        next_c = [None] * len(self.nodes)
        for i in range(len(self.nodes) - 1, -1, -1):
            next_c[i] = nxt
            if isinstance(self.nodes[i], _Format):
                nxt = self.nodes[i].choices
        fmt, w, h = src_fmt, width, height
        for i, node in enumerate(self.nodes):
            if isinstance(node, _Scale):
                node.neg_dst_fmt = _pick_fmt(fmt, next_c[i])
            fmt, w, h = node.configure(fmt, w, h)
        if dst_fmt and fmt != dst_fmt:
            tail = _Format("format", {0: dst_fmt})
            fmt, w, h = tail.configure(fmt, w, h)
            self.nodes.append(tail)
        self.out_fmt, self.out_w, self.out_h = fmt, w, h
        self._n = 0

    def run_frame(self, frame):
        """Push one frame through the chain; None if dropped."""
        n = self._n
        self._n += 1
        for node in self.nodes:
            frame = node.apply(frame, n)
            if frame is None:
                return None
        return frame

    def run(self, frames):
        out = []
        for f in frames:
            r = self.run_frame(f)
            if r is not None:
                out.append(r)
        return out
