#!/usr/bin/env python3
"""Bring-up check of the GPU device pipeline.

Drives the main path through the entry points a user calls
(TPUFFV1Encoder / TPUFFV1Decoder and the FFV1-P pair) at real geometry,
checks every packet byte-exact against the host engines and every
decoded plane against its source, and times each CUDA range-coder
kernel against the XLA scan it stands in for.

  python chip_smoke.py           phases (a)-(e) on one GPU
  python chip_smoke.py --four    slice-sharded encode + decode on four
                                 GPUs, against one card and the native
                                 engine (no other phase)

Each phase prints its results on lines of its own; the last line is one
JSON object, {"ok": true, "device": {...}}.  The script exits non-zero
without that line when JAX finds no GPU, when it runs outside the
repository, or when any phase fails.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H = 1920, 1080
FLAGSHIP = dict(width=W, height=H, pix_fmt="yuv420p", level=3, coder=2,
                slices=24, gop_size=12)
CARD = ""


def say(msg):
    print(msg, flush=True)


def card_lines():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def frames_420(n, w, h, seed):
    """Gradient + noise luma moving 3 px a frame, noisy flat chroma."""
    rng = np.random.RandomState(seed)
    base = np.add.outer(np.arange(h), np.arange(w)) + 7 * seed
    out = []
    for t in range(n):
        y = ((base + 3 * t) % 256 + rng.randint(0, 16, (h, w)))
        u = rng.randint(0, 8, (h // 2, w // 2)) + 100 + seed
        v = rng.randint(0, 8, (h // 2, w // 2)) + 160 - seed
        out.append([a.astype(np.uint8) for a in (y, u, v)])
    return out


def frames_deep(n, w, h, bits, seed):
    """Three full-resolution planes of ``bits``-bit samples."""
    rng = np.random.RandomState(seed)
    top = 1 << bits
    base = np.add.outer(np.arange(h), np.arange(w)) * 257
    return [[(((base + 1031 * t + 7919 * k) % top +
               rng.randint(0, 255, (h, w))) % top).astype(np.uint16)
             for k in range(3)] for t in range(n)]


def timed_steps(n, submit, collect):
    """Depth-1 pipeline over n steps: returns (compile s, steady step
    times s, results per step)."""
    t0 = time.perf_counter()
    submit(0)
    res = [collect()]
    compile_s = time.perf_counter() - t0
    steps = []
    if n > 1:
        submit(1)
    t = time.perf_counter()
    for k in range(2, n + 1):
        if k < n:
            submit(k)
        res.append(collect())
        now = time.perf_counter()
        steps.append(now - t)
        t = now
    return compile_s, steps, res


def report(name, compile_s, steps, pixels_per_step):
    med = float(np.median(steps)) if steps else float("nan")
    say(f"{name}: compile {compile_s:.2f} s, steady step "
        f"{med * 1e3:.2f} ms (median of {len(steps)}), "
        f"{pixels_per_step / med / 1e6:.2f} Mpixel/s [{CARD}]")


def native_packets(params, streams, engine="native"):
    from tpu_ffv1.codec.encoder import FFV1Encoder
    out = []
    for frames in streams:
        enc = FFV1Encoder(params, engine=engine)
        out.append([enc.encode_frame(f) for f in frames])
    return out


def check_packets(name, got, ref):
    """got/ref: per stream, per frame (packet, keyframe)."""
    bad = [(b, k) for b in range(len(ref)) for k in range(len(ref[b]))
           if got[b][k] != ref[b][k]]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} packets differ, first "
                             f"(stream, frame) {bad[0]}")
    n = sum(len(r) for r in ref)
    say(f"{name}: {n} packets byte-exact "
        f"({sum(len(p) for r in ref for p, _k in r)} bytes)")


def check_planes(name, got, src):
    """got/src: per stream, per frame, list of planes."""
    for b in range(len(src)):
        for k in range(len(src[b])):
            for p, (a, s) in enumerate(zip(got[b][k], src[b][k])):
                if not np.array_equal(np.asarray(a), s):
                    raise AssertionError(f"{name}: stream {b} frame {k} "
                                         f"plane {p} differs")
    say(f"{name}: {sum(len(s) for s in src)} frames lossless")


def encode_run(enc, streams, device=False):
    """All frames of ``streams`` (per stream, per frame) through
    submit_frames (or submit_device_frames) / collect_frames."""
    import jax.numpy as jnp
    n = len(streams[0])
    nplanes = len(streams[0][0])
    staged = None
    if device:
        staged = [tuple(jnp.asarray(np.stack([s[k][p] for s in streams]))
                        for p in range(nplanes)) for k in range(n)]

    def submit(k):
        if device:
            enc.submit_device_frames(staged[k])
        else:
            enc.submit_frames([s[k] for s in streams])

    compile_s, steps, res = timed_steps(n, submit, enc.collect_frames)
    got = [[res[k][b] for k in range(n)] for b in range(len(streams))]
    return compile_s, steps, got


def decode_run(dec, pkts, device_out=False):
    n = len(pkts[0])
    compile_s, steps, res = timed_steps(
        n, lambda k: dec.submit_frames([p[k][0] for p in pkts]),
        dec.collect_frames)
    if device_out:
        got = [[[pl[b] for pl in res[k][0]] for k in range(n)]
               for b in range(len(pkts))]
    else:
        got = [[res[k][b][0] for k in range(n)] for b in range(len(pkts))]
    return compile_s, steps, got


# ------------------------------------------------------------ phases

def phase_a(ctx):
    """Flagship: 1080p yuv420p, range coder, 24 slices, batch 5."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    batch, n = 5, 12
    params = EncoderParams(**FLAGSHIP)
    src = [frames_420(n, W, H, seed=b) for b in range(batch)]
    ref = native_packets(params, src)
    enc = TPUFFV1Encoder(params, batch=batch)
    ctx["enc"], ctx["src"], ctx["pkts"] = enc, src, ref
    say(f"(a) scan: encode={enc.scan} ({enc.L} lanes)")
    c, st, got = encode_run(enc, src)
    report("(a) encode host-source", c, st, batch * W * H)
    check_packets("(a) encode host-source", got, ref)
    enc.reset()
    c, st, got = encode_run(enc, src, device=True)
    report("(a) encode device-source", c, st, batch * W * H)
    check_packets("(a) encode device-source", got, ref)
    for dev_out in (False, True):
        dec = TPUFFV1Decoder(W, H, enc.extradata, batch=batch,
                             device_out=dev_out)
        if not dev_out:
            say(f"(a) scan: decode={dec.scan}")
        c, st, got = decode_run(dec, ref, device_out=dev_out)
        name = f"(a) decode device_out={dev_out}"
        report(name, c, st, batch * W * H)
        check_planes(name, got, src)
    cli_roundtrip(src[0][:2])


def cli_roundtrip(frames):
    """The CLI's -engine tpu encode and decode of raw 1080p frames: the
    container must equal the native engine's byte for byte and the
    decoded file the input."""
    from tpu_ffv1.cli.main import run
    from tpu_ffv1.io.rawvideo import write_frames
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    raw, back = os.path.join(work, "in.yuv"), os.path.join(work, "back.yuv")
    write_frames(raw, frames)
    enc_args = ["-f", "rawvideo", "-pix_fmt", "yuv420p", "-s", f"{W}x{H}",
                "-i", raw, "-c:v", "ffv1", "-level", "3", "-coder", "2",
                "-slices", "24", "-g", "12", "-engine"]
    out = {}
    t0 = time.perf_counter()
    try:
        for engine in ("tpu", "native"):
            out[engine] = os.path.join(work, f"{engine}.avi")
            run(enc_args + [engine, out[engine]])
        run(["-i", out["tpu"], "-f", "rawvideo", "-pix_fmt", "yuv420p",
             "-engine", "tpu", back])
    except SystemExit as e:
        raise AssertionError(f"(a) CLI exited with {e.code}") from e
    files = {}
    for k, path in dict(out, raw=raw, back=back).items():
        with open(path, "rb") as f:
            files[k] = f.read()
    if files["tpu"] != files["native"] or files["back"] != files["raw"]:
        raise AssertionError("(a) CLI -engine tpu: output differs")
    say(f"(a) CLI -engine tpu: {len(frames)} frames encoded byte-exact "
        f"({len(files['tpu'])} bytes of AVI) and decoded lossless in "
        f"{time.perf_counter() - t0:.2f} s [{CARD}]")


def phase_b(ctx):
    """Ext schedule: yuv444p16 encode + decode, gbrp14 encode."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    n = 3
    p16 = EncoderParams(width=W, height=H, pix_fmt="yuv444p16le", level=3,
                        coder=2, slices=24, gop_size=12)
    src = [frames_deep(n, W, H, 16, seed=11)]
    ref = native_packets(p16, src)
    enc = TPUFFV1Encoder(p16)
    say(f"(b) scan: yuv444p16 encode={enc.scan} (coded {enc.bits} bits)")
    c, st, got = encode_run(enc, src)
    report("(b) yuv444p16 encode", c, st, W * H)
    check_packets("(b) yuv444p16 encode", got, ref)
    dec = TPUFFV1Decoder(W, H, enc.extradata)
    say(f"(b) scan: yuv444p16 decode={dec.scan}")
    c, st, got = decode_run(dec, ref)
    report("(b) yuv444p16 decode", c, st, W * H)
    check_planes("(b) yuv444p16 decode", got, src)
    p14 = EncoderParams(width=W, height=H, pix_fmt="gbrp14le", level=3,
                        coder=2, slices=24, gop_size=12)
    src = [frames_deep(n, W, H, 14, seed=12)]
    ref = native_packets(p14, src)
    enc = TPUFFV1Encoder(p14)
    say(f"(b) scan: gbrp14 encode={enc.scan} (coded {enc.bits} bits)")
    c, st, got = encode_run(enc, src)
    report("(b) gbrp14 encode", c, st, W * H)
    check_packets("(b) gbrp14 encode", got, ref)


def phase_c(ctx):
    """Golomb-Rice (coder=0) at 1080p: encode + decode."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    n = 3
    params = EncoderParams(**dict(FLAGSHIP, coder=0))
    src = [ctx["src"][0][:n]] if "src" in ctx else [frames_420(n, W, H, 0)]
    ref = native_packets(params, src)
    enc = TPUFFV1Encoder(params)
    say("(c) scan: golomb encode=xla (lane VLC scan)")
    c, st, got = encode_run(enc, src)
    report("(c) golomb encode", c, st, W * H)
    check_packets("(c) golomb encode", got, ref)
    dec = TPUFFV1Decoder(W, H, enc.extradata)
    c, st, got = decode_run(dec, ref)
    report("(c) golomb decode", c, st, W * H)
    check_planes("(c) golomb decode", got, src)


def phase_d(ctx):
    """FFV1-P at 1280x720, 6 frames, against the host FFV1-P codec."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.pframe.codec import FFV1PEncoder
    from tpu_ffv1.pframe.tpu import TPUFFV1PDecoder, TPUFFV1PEncoder
    pw, ph, n = 1280, 720, 6
    params = EncoderParams(width=pw, height=ph, pix_fmt="yuv420p", level=3,
                           coder=2, slices=12, gop_size=12)
    rng = np.random.RandomState(1)
    base = np.add.outer(np.arange(ph + 64), np.arange(pw + 64)) % 256
    src = [[[(base[2 * t:2 * t + ph, 3 * t:3 * t + pw] +
              rng.randint(0, 8, (ph, pw))).astype(np.uint8),
             (rng.randint(0, 8, (ph // 2, pw // 2)) + 100).astype(np.uint8),
             (rng.randint(0, 8, (ph // 2, pw // 2)) + 160).astype(np.uint8)]
            for t in range(n)]]
    host = FFV1PEncoder(params, experimental=True)
    ref = [[host.encode_frame(f) for f in src[0]]]
    enc = TPUFFV1PEncoder(params, experimental=True)
    say(f"(d) scan: P encode={enc.scan} (residuals at {enc.p_bits} bits)")
    c, st, got = encode_run(enc, src)
    report("(d) FFV1-P encode", c, st, pw * ph)
    check_packets("(d) FFV1-P encode", got, ref)
    dec = TPUFFV1PDecoder(pw, ph, enc.extradata)
    say(f"(d) scan: P decode={dec.scan}")
    t0 = time.perf_counter()
    out = [dec.decode_frame(p)[0] for p, _k in ref[0]]
    say(f"(d) FFV1-P decode: {n} frames in "
        f"{time.perf_counter() - t0:.2f} s incl. compile [{CARD}]")
    check_planes("(d) FFV1-P decode", [out], src)


def median_time(fn, args, runs):
    import jax
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def phase_e(ctx, runs=10):
    """CUDA kernels against the XLA scans on identical 120-lane 1080p
    inputs (the phase-(a) frames and packets)."""
    import jax
    import jax.numpy as jnp
    from tpu_ffv1.tpu.cuda_scan import rc_decode_planes, rc_encode_packed
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.rc_scan_lanes import finalize_packed
    enc, src = ctx["enc"], ctx["src"]
    batch = enc.batch
    planes = tuple(jnp.asarray(np.stack([s[0][p] for s in src]))
                   for p in range(3))
    ctxs, diffs, acts = jax.jit(enc._streams_uniform)(planes)
    lows, ranges, prefixes, plens = (jnp.asarray(a) for a in
                                     enc._prefix_arrays(True))
    states0 = jnp.full_like(enc.states, 128)
    args = (ctxs, diffs, acts, states0, enc.one_tab, enc.zero_tab, lows,
            ranges)
    outs, times = {}, {}
    for impl in ("cuda", "xla"):
        fn = jax.jit(lambda *a, impl=impl: rc_encode_packed(
            impl, *a, enc.bits))
        t0 = time.perf_counter()
        outs[impl] = jax.block_until_ready(fn(*args))
        comp = time.perf_counter() - t0
        times[impl] = median_time(fn, args, runs)[0]
        say(f"(e) encode scan {impl}: first call {comp:.2f} s, median "
            f"{times[impl] * 1e3:.2f} ms of {runs} runs, "
            f"{batch * W * H / times[impl] / 1e6:.2f} Mpixel/s "
            f"({enc.L} lanes x {ctxs.shape[1]} px) [{CARD}]")
    pc, px = (np.asarray(outs[i][0]) for i in ("cuda", "xla"))
    px = px * ((px >> 20) & 1)        # XLA keeps values in silent slots
    same = np.array_equal(pc, px) and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(outs["cuda"][1:], outs["xla"][1:]))
    fin = [finalize_packed(o[0], o[1], o[2], prefixes, plens)
           for o in (outs["cuda"], outs["xla"])]
    same = same and all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(fin[0], fin[1]))
    if not same:
        raise AssertionError("(e) encode: CUDA and XLA scans differ")
    say(f"(e) encode scan: CUDA == XLA (emitted slots, low, range, states, "
        f"finalized bytes); CUDA {times['xla'] / times['cuda']:.1f}x "
        f"faster [{CARD}]")

    dec = TPUFFV1Decoder(W, H, enc.extradata, batch=batch)
    parsed = [dec._parse_packet(b, ctx["pkts"][b][0][0])
              for b in range(batch)]
    bufs, lo, ra, po, _lens = dec.lane_inputs(parsed)
    qidx = parsed[0][1][0][1]
    cc = dec.g.context_counts[qidx]
    specs = tuple((w, h, sp * cc) for (w, h, sp) in dec._plane_specs())
    st0 = jnp.asarray(np.tile(dec._fresh_states(qidx)[None],
                              (dec.L, 1, 1)))
    five = bool(dec.g.quant_tables[qidx][3][127])
    dargs = (jnp.asarray(bufs), st0, dec.one_tab, dec.zero_tab,
             dec.qts[qidx], jnp.asarray(lo), jnp.asarray(ra),
             jnp.asarray(po))
    for impl in ("cuda", "xla"):
        fn = jax.jit(lambda *a, impl=impl: rc_decode_planes(
            impl, *a, specs, dec.bits, five))
        t0 = time.perf_counter()
        outs[impl] = jax.block_until_ready(fn(*dargs))
        comp = time.perf_counter() - t0
        times[impl] = median_time(fn, dargs, runs)[0]
        say(f"(e) decode scan {impl}: first call {comp:.2f} s, median "
            f"{times[impl] * 1e3:.2f} ms of {runs} runs, "
            f"{batch * W * H / times[impl] / 1e6:.2f} Mpixel/s "
            f"({dec.L} lanes) [{CARD}]")
    la, lb = (jax.tree.leaves(outs[i]) for i in ("cuda", "xla"))
    if not all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(la, lb)):
        raise AssertionError("(e) decode: CUDA and XLA scans differ")
    say(f"(e) decode scan: CUDA == XLA (planes, states, low, range, pos); "
        f"CUDA {times['xla'] / times['cuda']:.1f}x faster [{CARD}]")


def phase_four(ctx):
    """Slice sharding over four cards: 1080p, 24 slices, batch 2 (48
    lanes), encode and decode, against one card and the native
    engine."""
    import jax
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
    from tpu_ffv1.tpu.sharding import make_mesh
    batch, n = 2, 6
    params = EncoderParams(**FLAGSHIP)
    src = [frames_420(n, W, H, seed=b) for b in range(batch)]
    ref = native_packets(params, src)
    mesh = make_mesh(4)
    enc4 = TPUFFV1Encoder(params, batch=batch, mesh=mesh)
    say(f"(4) mesh: {mesh.devices.size} x {jax.devices()[0].device_kind}, "
        f"scan={enc4.scan}, {enc4.L} lanes")
    c, st, got4 = encode_run(enc4, src)
    report("(4) sharded encode", c, st, batch * W * H)
    check_packets("(4) sharded encode vs native", got4, ref)
    enc1 = TPUFFV1Encoder(params, batch=batch)
    c, st, got1 = encode_run(enc1, src)
    report("(4) one-card encode", c, st, batch * W * H)
    check_packets("(4) sharded encode vs one card", got4, got1)
    dec = TPUFFV1Decoder(W, H, enc4.extradata, batch=batch, mesh=mesh)
    c, st, got = decode_run(dec, ref)
    report("(4) sharded decode (decode_lanes_sharded)", c, st,
           batch * W * H)
    check_planes("(4) sharded decode", got, src)


def main(argv):
    global CARD
    four = "--four" in argv
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    try:
        from tpu_ffv1.cache import enable_compile_cache
    except ImportError as e:
        print(f"run chip_smoke.py from the repository root ({e})",
              file=sys.stderr)
        return 2
    want = 4 if four else 1
    if len(devs) < want:
        print(f"needs {want} GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    cards = card_lines()
    CARD = cards[0]
    for ln in cards:
        say(f"card: {ln}")
    say(f"platform {devs[0].platform}, device kind {devs[0].device_kind}, "
        f"{len(devs)} device(s); compile cache {cache}")
    phases = ([("four", phase_four)] if four else
              [("a", phase_a), ("b", phase_b), ("c", phase_c),
               ("d", phase_d), ("e", phase_e)])
    ctx, failed = {}, []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(ctx)
            say(f"phase {name}: PASS in {time.perf_counter() - t0:.1f} s")
        except Exception as e:
            import traceback
            traceback.print_exc()
            say(f"phase {name}: FAIL ({type(e).__name__}: {e})")
            failed.append(name)
    if failed:
        say(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
