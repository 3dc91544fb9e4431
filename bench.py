#!/usr/bin/env python3
"""Benchmark driver: FFV1 encode throughput on the GPU device path.

Prints ONE JSON line:
  {"metric": "ffv1_encode_1080p_mpix_s", "value": N, "unit": "Mpixel/s",
   "vs_baseline": N / 62.2, "device": {...}, ...}

Baseline: 1080p30 real-time per chip = 1920*1080*30 / 1e6 = 62.2 Mpixel/s
(BASELINE.md; the reference's number is ffmpeg encoding RAM-resident
frames).  The headline ``value`` is the sustained device-source rate:
frames resident in device memory (as a device decode/filter stage
produces them), full encode pipeline + payload download + host packet
assembly every step.  ``host_source_e2e_mpix_s`` is the same pipeline
fed from host memory.  Secondary numbers (host native engine, decode,
P-frame) are separate keys.

Needs a GPU: without one, or when any leg fails, it exits non-zero.
The full artifact goes to bench_full.json; first compiles land in the
persistent compile cache (tpu_ffv1.cache).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_MPIX_S = 1920 * 1080 * 30 / 1e6  # 1080p30 real-time


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synth_1080p(n_frames=4, seed=0):
    rng = np.random.RandomState(seed)
    frames = []
    base = (np.add.outer(np.arange(1080), np.arange(1920)) % 256)
    for t in range(n_frames):
        y = ((base + t * 3) + rng.randint(0, 16, (1080, 1920))).astype(
            np.uint8)
        u = (rng.randint(0, 8, (540, 960)) + 100).astype(np.uint8)
        v = (rng.randint(0, 8, (540, 960)) + 160).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def bench_encode(frames, budget_s=900.0):
    import jax
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    batch = int(os.environ.get("FFV1_BENCH_BATCH", "5"))
    enc = TPUFFV1Encoder(EncoderParams(
        width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
        slices=24), batch=batch)
    log(f"devices: {jax.devices()}; stream batch: {batch} "
        f"({enc.L} lanes)")
    # independent streams: offset frame sequences of the same clip
    streams0 = [frames[i % len(frames)] for i in range(batch)]
    t0 = time.time()
    res = enc.encode_frames(streams0)
    log(f"first step (compile): {time.time() - t0:.1f}s, "
        f"{len(res[0][0])} bytes")
    payload_mb = sum(len(r[0]) for r in res) / 1e6
    # pipelined steady state (default depth 2): upload of frame k+2,
    # device scan of frame k+1, and result download of frame k are all
    # in flight together
    depth = int(os.environ.get("FFV1_BENCH_DEPTH", "2"))
    from tpu_ffv1 import log as flog
    flog.collect_phases(True)     # per-phase medians -> JSON artifact
    t0 = time.time()
    steps = []
    n_steps = max(len(frames), 10)
    for d in range(depth):
        # per-lane distinct priming frames, like the steady-state steps
        enc.submit_frames([frames[(i + 1 + d) % len(frames)]
                           for i in range(batch)])
    for k in range(depth + 1, n_steps + depth + 1):
        enc.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if k < n_steps + 1:
            enc.submit_frames([frames[(i + k) % len(frames)]
                               for i in range(batch)])
        if sum(steps) > budget_s and not enc._pending:
            break
    step_ms = sorted(s * 1000 for s in steps)
    phases = flog.phase_stats()
    flog.collect_phases(False)
    med = step_ms[len(step_ms) // 2]
    mpix = batch * 1920 * 1080 / (med / 1000) / 1e6
    log(f"encode steady: median {med:.0f} ms/step, min {step_ms[0]:.0f}, "
        f"max {step_ms[-1]:.0f} ({batch} frames/step); phases: "
        + json.dumps(phases))

    # device-resident compute: the fused pipeline timed with the planes
    # already in device memory (no host transfers)
    comp_ms = None
    try:
        import jax
        import jax.numpy as jnp
        streams_np = tuple(
            tuple(np.asarray(p) for p in frames[i % len(frames)])
            for i in range(batch))
        dev = tuple(jnp.asarray(np.stack([s[k] for s in streams_np]))
                    for k in range(len(streams_np[0])))
        lows, ranges, prefixes, plens = enc._prefix_arrays(True)
        args = (dev, jnp.full_like(enc.states, 128),
                jnp.asarray(lows), jnp.asarray(ranges),
                jnp.asarray(prefixes), jnp.asarray(plens))
        jax.block_until_ready(enc._frame_fn(*args))       # warm
        reps = []
        for _ in range(5):
            t0 = time.time()
            jax.block_until_ready(enc._frame_fn(*args))
            reps.append((time.time() - t0) * 1000)
        comp_ms = sorted(reps)[len(reps) // 2]
        log(f"encode compute (device-resident): {comp_ms:.0f} ms/step = "
            f"{batch * 1920 * 1080 / comp_ms / 1000:.1f} Mpixel/s")
    except Exception as e:
        log(f"compute probe failed: {e}")
    stats = dict(median_ms=round(med, 1), min_ms=round(step_ms[0], 1),
                 max_ms=round(step_ms[-1], 1), n_steps=len(step_ms),
                 frames_per_step=batch,
                 upload_mb_per_step=round(
                     batch * 1920 * 1080 * 1.5 / 1e6, 2),
                 download_mb_per_step=round(payload_mb, 2),
                 phases=phases)
    if comp_ms is not None:
        stats["compute_ms_per_step"] = round(comp_ms, 1)
        stats["compute_mpix_s"] = round(
            batch * 1920 * 1080 / comp_ms / 1000, 2)
    return mpix, stats


def bench_encode_device_source(frames, budget_s=600.0):
    """Sustained encode throughput with a DEVICE-RESIDENT source.

    Frames are placed in device memory up front (as a device
    decode/filtergraph stage would produce them) and encoded
    back-to-back; only the compressed payload crosses to the host each
    step (submit_device_frames).  The fair analog of the reference's
    RAM-resident benchmark (BASELINE.md measures ffmpeg with frames
    already in RAM).  The host-source end-to-end number is reported
    alongside."""
    import jax
    import jax.numpy as jnp
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    batch = int(os.environ.get("FFV1_BENCH_BATCH", "5"))
    enc = TPUFFV1Encoder(EncoderParams(
        width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
        slices=24), batch=batch)
    # the same synthetic clip as the host-source bench, staged on device
    # once (untimed: a production source produces frames on-device)
    nstage = len(frames)
    staged = []
    for k in range(nstage):
        streams = [frames[(i + k) % nstage] for i in range(batch)]
        staged.append(tuple(
            jnp.asarray(np.stack([s[j] for s in streams]))
            for j in range(3)))
    jax.block_until_ready(staged[-1][0])
    t0 = time.time()
    enc.submit_device_frames(staged[0])
    enc.collect_frames()
    log(f"device-source first step: {time.time() - t0:.1f}s")
    depth = int(os.environ.get("FFV1_BENCH_DEPTH", "2"))
    n_steps = int(os.environ.get("FFV1_BENCH_STEPS", "12"))
    from tpu_ffv1 import log as flog
    flog.collect_phases(True)
    steps = []
    t0 = time.time()
    for d in range(depth):
        enc.submit_device_frames(staged[(1 + d) % nstage])
    for k in range(depth + 1, n_steps + depth + 1):
        enc.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if k < n_steps + 1:
            enc.submit_device_frames(staged[k % nstage])
        if sum(steps) > budget_s and not enc._pending:
            break
    step_ms = sorted(s * 1000 for s in steps)
    phases = flog.phase_stats()
    flog.collect_phases(False)
    med = step_ms[len(step_ms) // 2]
    log(f"device-source steady: median {med:.0f} ms/step, "
        f"min {step_ms[0]:.0f}, max {step_ms[-1]:.0f} "
        f"({batch} frames/step)")
    return batch * 1920 * 1080 / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), min_ms=round(step_ms[0], 1),
        max_ms=round(step_ms[-1], 1), n_steps=len(step_ms),
        frames_per_step=batch, phases=phases)


def bench_encode_scan_only(frames, budget_s=240.0):
    """Device COMPUTE throughput of the fused encode pipeline: frames
    start in device memory and the compressed payload is LEFT there —
    only the (L,) per-slice byte counts reach the host each step.

    The sustainable rate of an all-on-device chain (encode feeding a
    device consumer, as in the transcode path's decode sink),
    published next to the end-to-end device-source number so the
    payload download's share of the step is explicit.
    Replaces hot loop ffv1enc.c:271-371 + rangecoder.h:85-102."""
    import jax
    import jax.numpy as jnp
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    batch = int(os.environ.get("FFV1_BENCH_BATCH", "5"))
    enc = TPUFFV1Encoder(EncoderParams(
        width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
        slices=24), batch=batch)
    nstage = len(frames)
    staged = []
    for k in range(nstage):
        streams = [frames[(i + k) % nstage] for i in range(batch)]
        staged.append(tuple(
            jnp.asarray(np.stack([s[j] for s in streams]))
            for j in range(3)))
    jax.block_until_ready(staged[-1][0])
    pk = enc._prefix_arrays(True)
    pnk = enc._prefix_arrays(False)
    gop = max(enc.rp.gop_size, 1)
    state = {"s": jnp.full_like(enc.states, 128)}

    def step(k):
        # runs on the 1-worker executor: strictly in submit order, so
        # the GOP context chain stays intact (as in _submit_fast)
        key = k % gop == 0
        lows, ranges, prefixes, plens = pk if key else pnk
        s0 = jnp.full_like(state["s"], 128) if key else state["s"]
        (out, counts, states_out, _ovf, _packed, _low, _rng,
         _rb) = enc._frame_fn(staged[k % nstage], s0, jnp.asarray(lows),
                              jnp.asarray(ranges), jnp.asarray(prefixes),
                              jnp.asarray(plens))
        state["s"] = states_out
        return counts

    ex = ThreadPoolExecutor(max_workers=1)
    t0 = time.time()
    np.asarray(ex.submit(step, 0).result())   # compile (keyframe)
    np.asarray(ex.submit(step, 1).result())   # compile (non-key)
    log(f"scan-only first steps (compile): {time.time() - t0:.1f}s")
    depth = 2
    n_steps = int(os.environ.get("FFV1_BENCH_STEPS", "12"))
    futs = deque()
    steps = []
    t0 = time.time()
    for d in range(depth):
        futs.append(ex.submit(step, 2 + d))
    for k in range(2 + depth, 2 + n_steps + depth):
        np.asarray(futs.popleft().result())   # tiny (L,) counts fetch
        steps.append(time.time() - t0)
        t0 = time.time()
        if k < 2 + n_steps:
            futs.append(ex.submit(step, k))
        if sum(steps) > budget_s and not futs:
            break
    while futs:
        np.asarray(futs.popleft().result())
    ex.shutdown(wait=False)
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"scan-only steady: median {med:.0f} ms/step, min "
        f"{step_ms[0]:.0f}, max {step_ms[-1]:.0f} "
        f"({batch} frames/step, payload resident)")
    return batch * 1920 * 1080 / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), min_ms=round(step_ms[0], 1),
        max_ms=round(step_ms[-1], 1), n_steps=len(step_ms),
        frames_per_step=batch, payload_resident=True)


def bench_host(frames):
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.codec.params import EncoderParams

    enc = FFV1Encoder(EncoderParams(
        width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
        slices=24))
    enc.encode_frame(frames[0])  # warm
    t0 = time.time()
    for f in frames[1:3]:
        enc.encode_frame(f)
    dt = (time.time() - t0) / 2
    return 1920 * 1080 / dt / 1e6


def bench_decode(frames, budget_s=600.0):
    """Lane-major batched device decode throughput (archival
    read-back)."""
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    batch = int(os.environ.get("FFV1_BENCH_DEC_BATCH",
                            os.environ.get("FFV1_BENCH_BATCH", "8")))

    def mk_enc():
        return FFV1Encoder(EncoderParams(
            width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
            slices=24))

    # distinct streams per decode lane group (each an independent GOP
    # sequence, decoded in order) — replicating one packet across the
    # batch would flatter the lane-major design (no straggler lanes)
    streams = []
    for bi in range(batch):
        senc = mk_enc()
        sframes = synth_1080p(seed=bi)
        streams.append([senc.encode_frame(f)[0] for f in sframes])
    dec = TPUFFV1Decoder(1920, 1080, mk_enc().extradata, batch=batch)
    nf = len(streams[0])

    def step_pkts(k):
        return [streams[i][k % nf] for i in range(batch)]

    t0 = time.time()
    dec.decode_frames(step_pkts(0))
    log(f"decode first step (compile): {time.time() - t0:.1f}s")
    n_steps = max(nf, 6)
    depth = int(os.environ.get("FFV1_BENCH_DEPTH", "2"))
    t0 = time.time()
    n = 0
    for d in range(depth):
        dec.submit_frames(step_pkts(1 + d))
    steps = []
    for k in range(depth + 1, n_steps + depth + 1):
        dec.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        n += 1
        if k < n_steps + 1:
            dec.submit_frames(step_pkts(k))
        if sum(steps) > budget_s and not dec._pending:
            break
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"decode steady: median {med:.0f} ms/step "
        f"({batch} frames/step)")
    return batch * 1920 * 1080 / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), min_ms=round(step_ms[0], 1),
        max_ms=round(step_ms[-1], 1), n_steps=len(step_ms))


def bench_decode_sink(frames, budget_s=400.0):
    """Decode with a DEVICE-RESIDENT sink: packets go up, planes stay
    in device memory (TPUFFV1Decoder(device_out=True)) for an on-device
    consumer (transcode/filter/ML ingest).  Isolates decode compute
    from the 12 MB/step plane download."""
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    batch = int(os.environ.get("FFV1_BENCH_DEC_BATCH",
                            os.environ.get("FFV1_BENCH_BATCH", "8")))

    def mk_enc():
        return FFV1Encoder(EncoderParams(
            width=1920, height=1080, pix_fmt="yuv420p", level=3,
            coder=2, slices=24))

    streams = []
    for bi in range(batch):
        senc = mk_enc()
        streams.append([senc.encode_frame(f)[0]
                        for f in synth_1080p(seed=bi)])
    dec = TPUFFV1Decoder(1920, 1080, mk_enc().extradata, batch=batch,
                         device_out=True)
    nf = len(streams[0])

    def step_pkts(k):
        return [streams[i][k % nf] for i in range(batch)]

    t0 = time.time()
    dec.decode_frames(step_pkts(0))
    log(f"decode-sink first step (compile): {time.time() - t0:.1f}s")
    depth = int(os.environ.get("FFV1_BENCH_DEPTH", "2"))
    n_steps = 8
    steps = []
    t0 = time.time()
    for d in range(depth):
        dec.submit_frames(step_pkts(1 + d))
    for k in range(depth + 1, n_steps + depth + 1):
        dec.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if k < n_steps + 1:
            dec.submit_frames(step_pkts(k))
        if sum(steps) > budget_s and not dec._pending:
            break
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"decode-sink steady: median {med:.0f} ms/step, "
        f"min {step_ms[0]:.0f} ({batch} frames/step)")
    return batch * 1920 * 1080 / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), min_ms=round(step_ms[0], 1),
        max_ms=round(step_ms[-1], 1), n_steps=len(step_ms),
        frames_per_step=batch)


def bench_tiny_latency(budget_s=120.0):
    """BASELINE config 1 shape (64x64 8-bit 420 single-slice): per-
    frame encode LATENCY on the device path (small-frame dispatch
    cost, not throughput)."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    rng = np.random.RandomState(9)
    frames = [[rng.randint(0, 255, (64, 64)).astype(np.uint8),
               rng.randint(0, 255, (32, 32)).astype(np.uint8),
               rng.randint(0, 255, (32, 32)).astype(np.uint8)]
              for _ in range(4)]
    enc = TPUFFV1Encoder(EncoderParams(
        width=64, height=64, pix_fmt="yuv420p", level=3, coder=2))
    t0 = time.time()
    enc.encode_frame(frames[0])
    log(f"tiny first frame (compile): {time.time() - t0:.1f}s")
    lat = []
    t_end = time.time() + budget_s
    for k in range(1, 13):
        t0 = time.time()
        enc.encode_frame(frames[k % 4])
        lat.append((time.time() - t0) * 1000)
        if time.time() > t_end:
            break
    lat.sort()
    med = lat[len(lat) // 2]
    log(f"tiny 64x64 single-slice: median {med:.1f} ms/frame")
    return med, dict(median_ms=round(med, 2), min_ms=round(lat[0], 2),
                     n=len(lat))


def bench_16bit_archival(budget_s=400.0):
    """BASELINE config 3 shape (16-bit archival): yuv444p16 device
    encode via the extended (11..17-bit) schedule."""
    import jax
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    W, H = 960, 540     # quarter-1080p keeps the ext-scan step sane
    batch = int(os.environ.get("FFV1_BENCH_BATCH16", "4"))
    rng = np.random.RandomState(3)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 257 % 65536)
    frames = []
    for t in range(3):
        planes = [((base + t * 1031 + k * 7919) % 65536).astype(
            np.uint16) + rng.randint(0, 255, (H, W)).astype(np.uint16)
            for k in range(3)]
        frames.append([(p & 0xFFFF).astype(np.uint16) for p in planes])
    enc = TPUFFV1Encoder(EncoderParams(
        width=W, height=H, pix_fmt="yuv444p16le", level=3, coder=2,
        slices=12), batch=batch)
    assert enc.ext
    # distinct streams per lane group (offset sequences of the clip):
    # identical lanes would flatter the lane-major design (no straggler
    # lanes / identical code lengths)
    def step_frames(k):
        return [frames[(i + k) % 3] for i in range(batch)]
    t0 = time.time()
    enc.encode_frames(step_frames(0))
    log(f"16-bit first step (compile): {time.time() - t0:.1f}s")
    steps = []
    n_steps = 6
    enc.submit_frames(step_frames(1))
    t0 = time.time()
    for k in range(2, n_steps + 2):
        enc.submit_frames(step_frames(k))
        enc.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if sum(steps) > budget_s:
            break
    enc.collect_frames()
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"16-bit archival steady: median {med:.0f} ms/step "
        f"({batch} frames/step)")
    return batch * W * H / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), n_steps=len(step_ms),
        frames_per_step=batch, geometry=f"{W}x{H} yuv444p16")


def bench_rgb14_archival(budget_s=400.0):
    """BASELINE config 3, RGB flavor: deepest-RGB device encode the
    reference fork supports — gbrp14 (ffv1enc.c:1435 pix_fmts cap at
    GBRP14; RGB48/GBRP16 postdate this fork, so no byte-exact oracle
    exists for them).  Exercises the RCT (ffv1enc.c:446-473 two-byte
    RGB line read + bgr RCT) AND the extended (bits+1 = 15) schedule
    together on the device tier."""
    import jax
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.encoder import TPUFFV1Encoder

    W, H = 960, 540
    batch = int(os.environ.get("FFV1_BENCH_BATCH16", "4"))
    rng = np.random.RandomState(5)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 129 % 16384)
    frames = []
    for t in range(3):
        planes = [((base + t * 1031 + k * 4099) % 16384).astype(
            np.uint16) + rng.randint(0, 63, (H, W)).astype(np.uint16)
            for k in range(3)]
        frames.append([(p & 0x3FFF).astype(np.uint16) for p in planes])
    enc = TPUFFV1Encoder(EncoderParams(
        width=W, height=H, pix_fmt="gbrp14le", level=3, coder=2,
        slices=12), batch=batch)
    assert enc.ext and enc.rgb

    def step_frames(k):
        return [frames[(i + k) % 3] for i in range(batch)]
    t0 = time.time()
    enc.encode_frames(step_frames(0))
    log(f"gbrp14 first step (compile): {time.time() - t0:.1f}s")
    steps = []
    n_steps = 6
    enc.submit_frames(step_frames(1))
    t0 = time.time()
    for k in range(2, n_steps + 2):
        enc.submit_frames(step_frames(k))
        enc.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if sum(steps) > budget_s:
            break
    enc.collect_frames()
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"gbrp14 archival steady: median {med:.0f} ms/step "
        f"({batch} frames/step)")
    return batch * W * H / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), n_steps=len(step_ms),
        frames_per_step=batch, geometry=f"{W}x{H} gbrp14 (RCT + ext)",
        note="fork's pix_fmts cap at GBRP14 (ffv1enc.c:1435); "
             "RGB48 has no oracle in this reference")


def bench_decode16_sink(budget_s=400.0):
    """16-bit DECODE throughput: yuv444p16 streams through the device
    decode scan with a device-resident sink (planes stay on device),
    isolating decode compute from the 16-bit plane downloads.
    Reference: ffv1dec.c:100-181 at bits=16."""
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.tpu.decoder import TPUFFV1Decoder

    W, H = 960, 540
    batch = int(os.environ.get("FFV1_BENCH_DEC16_BATCH", "4"))
    rng = np.random.RandomState(3)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 257 % 65536)

    def mk_frames(seed):
        rng = np.random.RandomState(seed)
        out = []
        for t in range(3):
            planes = [((base + t * 1031 + k * 7919) % 65536).astype(
                np.uint16) + rng.randint(0, 255, (H, W)).astype(np.uint16)
                for k in range(3)]
            out.append([(p & 0xFFFF).astype(np.uint16) for p in planes])
        return out

    def mk_enc():
        return FFV1Encoder(EncoderParams(
            width=W, height=H, pix_fmt="yuv444p16le", level=3, coder=2,
            slices=12))

    streams = []
    for bi in range(batch):
        senc = mk_enc()
        streams.append([senc.encode_frame(f)[0]
                        for f in mk_frames(bi)])
    dec = TPUFFV1Decoder(W, H, mk_enc().extradata, batch=batch,
                         device_out=True)
    nf = len(streams[0])

    def step_pkts(k):
        return [streams[i][k % nf] for i in range(batch)]

    t0 = time.time()
    dec.decode_frames(step_pkts(0))
    log(f"decode16 first step (compile): {time.time() - t0:.1f}s")
    depth = int(os.environ.get("FFV1_BENCH_DEPTH", "2"))
    n_steps = 6
    steps = []
    t0 = time.time()
    for d in range(depth):
        dec.submit_frames(step_pkts(1 + d))
    for k in range(depth + 1, n_steps + depth + 1):
        dec.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        if k < n_steps + 1:
            dec.submit_frames(step_pkts(k))
        if sum(steps) > budget_s and not dec._pending:
            break
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"decode16 sink steady: median {med:.0f} ms/step "
        f"({batch} frames/step)")
    return batch * W * H / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), n_steps=len(step_ms),
        frames_per_step=batch, geometry=f"{W}x{H} yuv444p16")


def bench_pframe_720p(budget_s=600.0, me=None):
    """BASELINE config 4: 720p P-frame encode on the device pipeline
    (motion search + OBMC + residual + MV section all on device,
    pframe/tpu.py).  ``me`` selects full-grid vs EPZS-style
    predictor-seeded search (pframe/motion.py SEARCH_FNS); the stats
    carry bytes/frame so full-vs-pruned runs expose the compression
    delta alongside the throughput delta (motion_est.c:977 trade)."""
    from tpu_ffv1.codec.params import EncoderParams
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder

    W, H = 1280, 720
    batch = int(os.environ.get("FFV1_BENCH_BATCH", "5"))
    me = me or os.environ.get("FFV1_BENCH_ME", "full")
    rng = np.random.RandomState(1)
    base = (np.add.outer(np.arange(H + 64), np.arange(W + 64)) % 256)
    frames = []
    for t in range(8):
        y = (base[2 * t:2 * t + H, 3 * t:3 * t + W] +
             rng.randint(0, 8, (H, W))).astype(np.uint8)
        u = (rng.randint(0, 8, (H // 2, W // 2)) + 100).astype(np.uint8)
        v = (rng.randint(0, 8, (H // 2, W // 2)) + 160).astype(np.uint8)
        frames.append([y, u, v])
    enc = TPUFFV1PEncoder(EncoderParams(
        width=W, height=H, pix_fmt="yuv420p", level=3, coder=2,
        slices=12, gop_size=12), batch=batch, experimental=True, me=me)

    # distinct motion sequence per lane (offset orderings of the pan):
    # identical lanes would hide straggler-lane costs in the lane-major
    # MV/residual scans
    def step_frames(k):
        return [frames[1 + (i + k) % 7] for i in range(batch)]
    t0 = time.time()
    enc.encode_frames([frames[i % 8] for i in range(batch)])  # keyframe
    enc.encode_frames(step_frames(0))          # P compile
    log(f"pframe first steps (compile, me={me}): "
        f"{time.time() - t0:.1f}s")
    steps = []
    nbytes = nfr = 0
    n_steps = 8
    t0 = time.time()
    enc.submit_frames(step_frames(1))
    for k in range(2, n_steps + 2):
        enc.submit_frames(step_frames(k))
        got = enc.collect_frames()
        steps.append(time.time() - t0)
        t0 = time.time()
        nbytes += sum(len(p) for p, _ in got)
        nfr += len(got)
        if sum(steps) > budget_s:
            break
    enc.collect_frames()
    step_ms = sorted(s * 1000 for s in steps)
    med = step_ms[len(step_ms) // 2]
    log(f"pframe 720p steady (me={me}): median {med:.0f} ms/step, "
        f"{nbytes / max(nfr, 1) / 1e3:.0f} kB/P-frame")
    return batch * W * H / (med / 1000) / 1e6, dict(
        median_ms=round(med, 1), n_steps=len(step_ms), me=me,
        bytes_per_pframe=round(nbytes / max(nfr, 1)))


def bench_mv_search_4k(budget_s=300.0):
    """MV-search share at BASELINE config 5 geometry (4K 10-bit 422,
    16 slices): times the search stage ALONE for the full grid vs the
    EPZS-style pruned search (pframe/motion.py), on device-resident
    slice crops.  Publishes the measurement the exhaustive-search
    choice was missing (VERDICT r3 #6)."""
    import jax
    import jax.numpy as jnp
    from tpu_ffv1.pframe.codec import BLOCK, LAMBDA
    from tpu_ffv1.pframe.motion import SEARCH_FNS

    W, H = 3840, 2160
    nh, nv = 4, 4
    SW, SH = W // nh, H // nv            # 960x540 luma crops
    SWp = -(-SW // BLOCK) * BLOCK
    SHp = -(-SH // BLOCK) * BLOCK
    L = nh * nv
    rng = np.random.RandomState(4)
    cur = jnp.asarray(rng.randint(0, 1024, (L, SHp, SWp)), jnp.int32)
    ref = jnp.asarray(rng.randint(0, 1024, (L, SHp, SWp)), jnp.int32)
    pmv = jnp.zeros((L, SHp // BLOCK, SWp // BLOCK, 2), jnp.int32)
    out = {}
    for mode, fn in SEARCH_FNS.items():
        vf = jax.jit(jax.vmap(
            lambda c, r, p: fn(c, r, p, BLOCK, 7, LAMBDA)))
        jax.block_until_ready(vf(cur, ref, pmv))       # compile
        reps = []
        for _ in range(5):
            t0 = time.time()
            jax.block_until_ready(vf(cur, ref, pmv))
            reps.append((time.time() - t0) * 1000)
        out[f"search_{mode}_ms"] = round(sorted(reps)[len(reps) // 2], 1)
        log(f"4K MV search ({mode}): {out[f'search_{mode}_ms']:.0f} ms "
            f"for {L} slice lanes")
    return out


def bench_host_decode(frames):
    from tpu_ffv1.codec.encoder import FFV1Encoder
    from tpu_ffv1.codec.decoder import FFV1Decoder
    from tpu_ffv1.codec.params import EncoderParams

    enc = FFV1Encoder(EncoderParams(
        width=1920, height=1080, pix_fmt="yuv420p", level=3, coder=2,
        slices=24))
    pkts = [enc.encode_frame(f)[0] for f in frames[:3]]
    dec = FFV1Decoder(1920, 1080, enc.extradata)
    dec.decode_frame(pkts[0])  # warm
    t0 = time.time()
    for p in pkts[1:3]:
        dec.decode_frame(p)
    dt = (time.time() - t0) / 2
    return 1920 * 1080 / dt / 1e6


def main():
    import jax
    from tpu_ffv1.cache import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench.py measures the GPU path; JAX found "
            f"{devs[0].platform} only")
        sys.exit(2)
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(f"devices: {devs}")
    frames = synth_1080p()
    failed = []

    def leg(name, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:            # recorded; the run exits 1
            log(f"{name} failed: {type(e).__name__}: {e}")
            failed.append(name)
            return None

    out = {"metric": "ffv1_encode_1080p_mpix_s", "unit": "Mpixel/s",
           "device": device}
    host = leg("host_encode", bench_host, frames)
    hostd = leg("host_decode", bench_host_decode, frames)
    if host is not None:
        out["host_c_encode_mpix_s"] = round(host, 3)
    if hostd is not None:
        out["host_c_decode_mpix_s"] = round(hostd, 3)
    pairs = [
        ("host_source_e2e", bench_encode, (frames,)),
        ("device_source", bench_encode_device_source, (frames,)),
        ("encode_scan_only", bench_encode_scan_only, (frames,)),
        ("decode", bench_decode, (frames,)),
        ("decode_device_sink", bench_decode_sink, (frames,)),
        ("pframe_720p", bench_pframe_720p, ()),
        ("archival16", bench_16bit_archival, ()),
        ("rgb14", bench_rgb14_archival, ()),
        ("decode16", bench_decode16_sink, ()),
    ]
    for name, fn, args in pairs:
        r = leg(name, fn, *args)
        if r is not None:
            out[f"{name}_mpix_s"] = round(r[0], 3)
            out[f"{name}_steps"] = r[1]
    r = leg("pframe_720p_epzs", bench_pframe_720p, me="epzs")
    if r is not None:
        out["pframe_720p_epzs_mpix_s"] = round(r[0], 3)
        out["pframe_720p_epzs_steps"] = r[1]
    mv4k = leg("mv_search_4k", bench_mv_search_4k)
    if mv4k is not None:
        out["mv_search_4k"] = mv4k
    r = leg("tiny64_latency", bench_tiny_latency)
    if r is not None:
        out["tiny64_latency_ms"] = round(r[0], 2)
        out["tiny64_stats"] = r[1]
    head = out.get("device_source_mpix_s")
    if head is not None:
        out["value"] = head
        out["vs_baseline"] = round(head / BASELINE_MPIX_S, 4)
    out["failed"] = failed
    out["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime())
    full_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_full.json")
    with open(full_path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"full artifact -> {full_path}")
    print(json.dumps({k: out[k] for k in
                      ("metric", "value", "unit", "vs_baseline", "device",
                       "failed") if k in out}))
    sys.exit(1 if failed or head is None else 0)


if __name__ == "__main__":
    main()
