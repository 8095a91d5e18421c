#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wtracker_tpu_torch``) on one NVIDIA card.

Drives the port's main paths, the real-video tracking loop and the synthetic
live loop over many streams, at full width:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every hand-written kernel from ``wtracker_tpu_torch/csrc`` (K1,
   K2, the float64 polyfit K3 and the bias + SiLU pass K4; one ``nvcc`` per
   source, all started
   together; K3's, first needed in phase 14, finishes beside phases 3-13),
   prints the compiler's
   register report, and counts the int8 convolution's tensor-core
   instructions in its library (``cuobjdump -sass``: wgmma, no ``__dp4a``);
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and others, 1 to 64 views, crop origins at every
   residue mod 16, the chunk's last byte and a chunk view that is not
   16-byte aligned; times kernel, plain version and the library call of the
   same function beside the kernel's memory bound;
4. loads the trained YOLOv8s@416 checkpoint (BN-fused, bfloat16) and a
   seeded ResMLP with the reference topology;
5. runs ``run_video_live`` over a seeded 1430x1671 recording (40 cycles of
   12 imaging + 3 moving frames, chunks of 16 cycles) through the crop +
   letterbox kernel, with the launch counters set to 0 just before and read
   just after (K4, the bias + SiLU pass, 57 launches a forward);
6. runs the same loop through the plain crop -> letterbox -> detect branch,
   then both branches again with a float32 detector, and holds kernel loop
   against plain loop (float32: positions exact, boxes to 1e-2 px;
   bfloat16: within 2 px, since the branches round at different places),
   the kernel loop's detections against the worm's true track, and the
   card's bfloat16 detector against the float32 detector on the CPU
   (steps 4-6 run with ``fold_stem=False``: the path through the kernel);
7. holds the folded-stem detector against the standard letterbox -> conv
   detector (float32: boxes within 1e-3 px; bfloat16 against the CPU's
   float32 detector: IoU >= 0.9) and times both at one sub-batch of the
   synthetic loop;
8. runs the video loop at the default ``fold_stem=None``, which folds the
   stem for the BN-fused detector and so launches the kernel 0 times (K4
   56 times a forward: b0 is the folded stem's);
9. runs the synthetic flagship loop as the bench builds it
   (``tools/bench.py::build_flagship``, the port of the JAX package's
   ``bench.py``: S=96 streams, 360 px camera, 4 detect sub-batches a
   cycle), cut to 12 cycles: one warm-up (K4 56 launches a forward) and
   three timed runs, held to the trained-tracking bar; and in float32 at S=4 the folded and standard
   stems give the same tracks;
10. times the standalone 40 ms decision (``make_decision_step``, the
    bench's ``measure_decision_latency``) at S=1 and S=4, 30 decisions
    each, host until the move is on the host, then each of 30 more
    decisions' card busy time from a ``torch.profiler`` trace (K4 57
    launches a standard forward, 56 a folded one);
11. runs ROI streaming (``roi_window``) over the same recording at 480 and
    364 px (4 px of slack: chunks replay), through the kernel in bfloat16
    and float32 and at the default ``fold_stem=None``: each run bit-identical
    to the whole-frame loop of steps 5, 6 and 8, the kernel launched 2 times
    a cycle plus 2 per replayed cycle; then ROI and whole-frame cycles/s in
    turns;
12. writes the recording's first 16 cycles as 8-bit BMPs (the port's image
    codec, OpenCV's bytes: the card's host need not have OpenCV) into a
    temporary directory, reads them back
    with the port's ``FrameReader`` byte for byte, and runs ``python -m
    wtracker_tpu_torch.workflows.track_video`` on them with the trained
    checkpoint, whole-frame and with ``--roi 480`` at once: the two
    ``bboxes.csv`` files must be the same text and hold the tracking bar;
13. runs ``run_video_live_sharded`` over 4 seeded recordings at full width
    (8 cycles in chunks of 4), each stream held against its own
    ``run_video_live`` (float32: positions exact, boxes to 1e-2 px;
    bfloat16: within 2 px), and its stream-cycles/s;
14. replays a seeded 61,200-frame worm log at the deployment configuration
    (4,079 cycles) through the csv, optimal, polyfit and mlp controllers and
    the step motor (cycles/s each, every cycle; polyfit launches K3 once a
    cycle, the others never), polyfit over the first 250 of them through
    ``python -m wtracker_tpu_torch.workflows.simulate`` (the same rows), and
    every run once more on the CPU over every cycle beside the command
    (polyfit in a child process): the same ``bboxes.csv`` text (mlp: equal
    positions in >= 99.9 % of frames, none more than 2 px apart);
15. runs ``python -m wtracker_tpu_torch.workflows.sweep`` over
    configs/exp0-exp4 (mixed geometry, each at its own length), each
    experiment equal to its single-stream run (made beside the command), then 96 streams of the
    deployment configuration in one batch (stream-cycles/s);
16. runs the live YOLOv8s@416 + ResMLP loop over 30 streams of exp0-exp4's
    three camera sizes (``yolo_mlp_controller_hetero``, 12 cycles): steps/s,
    0 K1 launches, K4 57 a forward (the warm-up's, counted), every stream
    held to the tracking bar, and in float32 the
    mixed run against each camera size's streams alone;
17. runs ``python -m wtracker_tpu_torch.workflows.quantize_detector`` on
    phase 12's BMPs (64 calibration views at the initial camera window): the
    int8 artifact of the trained checkpoint that phases 18-22 use;
18. holds the int8 convolution kernel (K2) against its plain version at
    every distinct convolution of one int8 forward at 12 views, on the
    layers' own inputs: ``acc`` and ``logits`` bit-identical, ``silu_q``
    identical or off by one (counted); times each shape (kernel, plain
    version, ``torch._int_mm`` for 1x1 shapes) beside its bound, and sums
    them by class (3x3 stride 1, 3x3 stride 2, 1x1, head logits);
19. runs the video loop with the int8 detector over the recording, folded
    (``track_video``'s route: 0 K1 launches, 62 K2 a forward) and through K1
    (2 K1 launches a cycle, 63 K2 a forward), no K4, each held to the
    tracking bar;
20. measures the int8 folded detector's top-1 drift from the bf16 one on 48
    held-out views (median <= 1 px, >= 75 % within 8 px);
21. runs phase 9's synthetic loop with the int8 folded detect (steps/s beside
    phase 9's bf16 steps/s; 62 K2 launches a forward, no K4), and holds K2 against
    its plain version at every convolution shape of one of its 360-view
    forwards, as phase 18 does at 12 views;
22. runs ``track_video`` with the int8 artifact on the BMPs, held to the
    tracking bar, beside phase 23's commands;
23. runs ``python -m wtracker_tpu_torch.workflows.simulate --backend host``
    (the hook-based simulator) over phase 14's whole worm log, with the
    csv, optimal, polyfit and mlp
    controllers (four commands at once): each ``bboxes.csv`` is phase
    14's engine text row for row (mlp: differing rows counted, held to
    phase 14's bar), with wall time and the loop's cycles/s;
24. runs the live host loop, ``Simulator`` + ``LoggingController(
    YoloController)``, over phase 12's BMPs with the trained YOLOv8s@416 in
    float32 on the card: >= 95 % of decisions detected, the tracking bar,
    cycles/s, 0 launches of every hand kernel (the controller's detector is
    not BN-fused, so not even K4);
25. writes the trained checkpoint as an ultralytics-layout ``.pt`` and
    loads it back (state dict and 12-view logits identical to the ``.npz``
    load's), runs ``track_video --detector X.pt`` on phase 12's BMPs (phase
    12's CSV byte for byte), and times one ``WeightEvaluator.eval`` on the
    card over phase 14's log (the CPU's value exactly; K3 once a call);
26. computes the background of a seeded 1,024-frame recording at full size
    as the per-pixel median of 1,000 probes (``BGExtractor`` on the card:
    numpy's median on three bands of rows, the static background at >=
    99.9 % of pixels) and the classical boxes of all its frames
    (``BoxCalculator``, chunks of 256: frames/s, floods a chunk; the card's
    boxes equal to the CPU's on 16 frames, each around the worm's track),
    then splits one chunk's time into its stages (host gather, upload,
    threshold and morphology, the floods, the rest of the largest-blob
    step, by CUDA events);
27. runs ``python -m wtracker_tpu_torch.workflows.initialize_experiment`` on
    phase 12's BMPs, classical (background and boxes equal to this
    process's) and with the trained YOLOv8s at 1920 px (the trained scale
    on whole frames; held to the tracking bar), the two commands at once;
28. runs ``create_yolo_images`` (64 crops of 384 px) on them: each PNG,
    decoded by the port's codec, is the recording at the seed's window;
29. runs ``analysis`` on phase 12's ``bboxes.csv`` with BMP worm crops and
    phase 27's background on the card and on the CPU (the same
    ``analyzed.csv``), ``DataAnalyzer.calc_precise_error(batched=True)``
    over phase 14's log (rows/s, card = CPU) and ``visualize
    --save-frames`` over 30 frames (``VLC.render_frame``'s pixels), the
    three commands at once.  Phases 26-29 launch no hand kernel (asserted: each command runs
    in a child process that reports its own launch counts);
30. trains the ResMLP at ``predictor_training``'s defaults over phase 14's
    log: the first epoch's per-batch losses on the card against the CPU's,
    in float32 (the first three at rtol 1e-4) and in float64 (the first 40
    at rtol 1e-9; the whole epoch's mean loss in both), beside a CPU run
    from weights nudged by one ulp; samples/s and s an epoch; the command
    itself (2 epochs, run beside the CPU's epochs) whose ``.npz`` loads in
    ``load_predictor``;
31. runs the particle swarm (pop 100) over phase 14's log: ms an epoch,
    the card's first 20 epochs of history equal to the CPU's bit for bit
    (K3 once an epoch on the card), and the ``polyfit_optimizer`` command at
    its defaults (300 epochs);
32. runs ``yolo_training`` at full width (YOLOv8s, 384 px, batch 72, the
    full recipe with augmentation on) over 432 rendered worm images written
    as PNGs with exact YOLO labels (72 held out: 5 steps an epoch), 3
    epochs: the loss falls, ``best.npz`` loads, ``detect_multi`` gives the
    run's last validation mAP50, and on the trained checkpoint the card's
    ``detect_multi`` equals the CPU's and the validation pipeline's slot by
    slot; steps/s, images/s, s an epoch, s a validation, peak device
    memory; one step from the same weights on the card and on the CPU
    (augmentation off), in float32 and float64, agrees, gradients
    included; one recipe step runs under ``torch.profiler``;
33. phases 30-32 launch neither K1, K2 nor K4, and K3 only in phase 31's
    swarm (each command counted in its own process);
34. runs ``run_video_live_sharded`` over phase 13's recordings on a mesh of
    two slots on the card (``parallel/mesh.py``; each slot's slice of a
    chunk uploaded to its own device), through K1 (``fold_stem=False``: 2
    launches a cycle a slot, asserted) and folded (0): each slot equal to
    its streams run alone bit for bit, the whole within the bf16 bar of
    phase 13's run, stream-cycles/s beside the unsharded run;
35. runs the int8 serving loop (phase 21's folded detect,
    ``make_stream_batch_fused``) through ``run_engine_sharded`` on the two
    slots, a controller a slot from a factory: each slot equal to its
    streams alone, K2 62 launches a forward (asserted);
36. (run right after phase 15) runs the ``sweep`` command's ``main()``
    again with ``--mesh 2``: every ``bboxes.csv`` byte for byte phase 15's;
37. (run right after phase 32, on its images) the data-parallel detector
    step, YOLOv8s at 384 px, two gloo ranks on the card (this script run
    as ``--dp-worker``) against one device on the whole batch: float64 at
    batch 8 equal at rtol 1e-9 (loss, all-reduced gradients, BatchNorm
    statistics), float32 at batch 72 for 3 steps within phase 32's float32
    bounds; then the same two processes run ``yolo_training --dp
    --dp-ranks 2`` for one epoch, each as a rank that the command's
    launcher starts.  No hand kernel launches on these paths (counted
    in each rank from its start, asserted);
38. runs the detector's gates (``wtracker_tpu_torch/tools/gates.py``) at the
    JAX gates' sizes: held-out AP@0.5 >= 0.80 on 24 rendered images, the
    trained checkpoint's int8 drift (median <= 1 px), the closed loop at S=1
    x 6 cycles, the int8 drift of random s weights and the s/416 parity
    against the CPU; every gate passes, K2 launches in the two int8 gates,
    K1 in none, K4 57 times a forward of the BN-fused detectors on the card;
39. runs ``tools/trace_profile.py`` in process on the bf16 synthetic loop at
    S=8 x 2 cycles: a device busy share in (0, 1] and kernels listed;
40. runs the bench's measurement (``tools/bench.py::_measure``) in process
    at S=8 x 2 cycles, one timed window, 20 decisions a latency and 8 at the
    250 ms cadence, bf16 and int8 (K1 and K3 0 launches, K2 62 a forward of
    every int8 window and decision, K4 56 a folded and 57 a standard bf16
    forward; each latency's 20 traced calls with a card busy time in (0,
    the call's host time]), then ``tools/bench_video.py::run`` over a
    240-frame exp0 recording, whole frames and ROI 512 px, in chunks of 4
    cycles (of the hand kernels only K4, 56 launches a folded forward);
41. (run right after phase 14) holds K3 against its plain version on the
    card, 0 differing bits and one launch a call, on the polyfit replay's
    first 20 fits and on seeded fits of degree 1-5, 8, 9, 12 and 15 (y one
    column or two, one weighting or 100, zero weights, all masked,
    rank-deficient) and at the grid's edges (M around a column tile, P=1 x
    7,993 columns, P=1,000 x 2, deg 0-7 at the 48 KB limit, the edge cases
    over several tiles, N beyond the register form's rows at deg 2 and 8,
    the general form forced at deg 2, 7 and 8 in shared memory and in its
    workspace, the wave form below deg 7 over several tiles); reports each
    K3 kernel's registers, shared memory and spills from ``-Xptxas -v``;
    times K3, the plain version, ``torch.linalg.eigh`` of the same normal
    matrices, ``torch.linalg.lstsq`` of the same scaled systems (the whole
    fit, for full-rank inputs only) and an empty kernel at the replay's
    shape and the swarm's, at deg 2 and deg 8, beside the bound, and K3
    alone beside its bound at deg 3-7; with ``--k3-parent DIR`` (the
    parent commit's tree, unpacked by ``git archive``) also the parent's
    K3, built from it and timed with this one in turns, and ``eigh``,
    ``lstsq`` and the empty kernel at deg 3-7; then the polyfit replay at
    deg 8 over 200 cycles of phase 14's log (the card's text = the CPU's,
    which a child process computes beside the phase's checks; K3 once a
    cycle) beside the
    ``polyfit_optimizer --degree 8`` command on the card (K3 once an
    epoch);
42. (in a child process, beside phases 27-29) kills and resumes the
    detector recipe on the card at the CPU test's size (YOLOv8n, 64 px, 3
    epochs): two uninterrupted runs with the card's default kernels (their
    spread: not bit-equal), then with torch's deterministic algorithms two
    uninterrupted runs and the resumed one, all three bit-equal (weights,
    EMA weights, loss, mAP50, checkpoints);
43. (run right after phase 3) holds K4, the bf16 detector's bias + SiLU
    pass, within one bf16 ulp of its float32 version at 360-view shapes
    (b2.cv1 channels-last, b0 NCHW, 13 x 13 in both layouts), times it
    beside the six-launch eager chain it replaces and its byte bound, and
    counts its launches; its instantiations spill nothing.

Prints one JSON line of kernel results, one of K4's, one of loop results,
one for each of steps 7 to 42 (with ``--profile``, one more of
``torch.profiler`` runs of the loops, made after every timed phase), the
card line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the exit
code is not 0.  Needs one CUDA card and the
repository checkout around this file; run it as ``python3 chip_smoke.py``
from the checkout's root.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "models" / "yolov8s_worm416.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s outside
# the tensor cores.  Bounds below are for the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations
PEAK_F64_OPS_PER_S = 34e12  # float64 outside the tensor cores (K3's rounding needs the plain units)
# crop_letterbox work per output pixel: three 2-tap lerps (sub, mul, add each)
# and the 1/255 scale
OPS_PER_OUTPUT_PIXEL = 10

N_CYCLES = 40
CYCLES_PER_CHUNK = 16
SEED = 0
# crop_letterbox checks: the loop's shape, an upscale with clamped edges and a
# downscale, at 1 to 64 views
CHECK_SHAPES = ((360, 416), (48, 64), (480, 416))
CHECK_VIEWS = (1, 3, 12, 64)
FOLD_CHECK_VIEWS = 12
# the synthetic loop at bench.py's configuration, depth cut to 12 cycles
SYNTH_STREAMS = 96
SYNTH_CHUNKS = 4  # 96 x 15 / 4 = 360 views a detect sub-batch, as bench.py picks
SYNTH_CYCLES = 12
SYNTH_TIMED_RUNS = 3
DECISION_REPS = 30  # each traced decision costs ~0.1 s of torch.profiler's host work
# ROI streaming: windows of 480 px (60 px of slack around the camera) and of
# 364 px (4 px: the speculation misses and chunks replay; a 364-byte row is
# not a multiple of 16 bytes)
ROI_WINDOWS = ((480, 480), (364, 364))
ROI_CHUNK_CYCLES = 8
CLI_FRAMES = 16 * 15 + 1  # 16 cycles of the recording as BMPs, 0.58 GB
# the multi-recording loop, depth cut to 8 cycles in chunks of 4
STREAMS = 4
STREAM_CYCLES = 8
STREAM_CHUNK_CYCLES = 4
# replay at the deployment configuration: every logged cycle of its 61,200
# frames (4,079), on the card, for polyfit on the CPU too and in phase 23's
# host commands; the simulate command's default polyfit sample times; the
# simulate command cut to the first 250 cycles (its text the first rows of
# the in-process run's); --profile traces a cut of 200 cycles
REPLAY_POLYFIT_TIMES = (-15, -10, -5, 0, 3)
REPLAY_CLI_CYCLES = 250
# K3's general form (phase 41): the polyfit replay at deg 8 over 11 sample
# times for the first 200 cycles of the log, on the card and on the CPU; the
# polyfit_optimizer command at --degree 8 for a few epochs; 16 sample times
# for the cases of deg 12 and 15
HIGH_DEG = 8
HIGH_DEG_TIMES = tuple(range(-40, 1, 4))
HIGH_DEG_CYCLES = 200
HIGH_DEG_EPOCHS = 3
LSTSQ_REPS = 7  # torch.linalg.lstsq calls a timing (gels takes 17-54 ms at the swarm's shape)
LONG_TIMES = tuple(range(-60, 1, 4))
PROFILE_REPLAY_CYCLES = 200
SWEEP_STREAMS = 96
# the mixed-geometry live loop: 6 streams of each of exp0-exp4 (30 streams,
# 360 imaging views a decision), 12 cycles
HETERO_PER_GEOMETRY = 6
HETERO_CYCLES = 12
HETERO_TIMED_RUNS = 3
# the int8 serving form: the quantize command's calibration views (its
# default), held-out views of the drift check, timed int8 synthetic runs
INT8_CALIB_VIEWS = 64
DRIFT_VIEWS = 48
INT8_SYNTH_TIMED_RUNS = 2
# K4, the bias + SiLU pass (phase 43), at 360-view bf16 shapes: b2.cv1's output
# in the loop (channels-last), b0's in the mixed loop (NCHW), the smallest level
BIAS_SILU_TIMED = (
    ("b2.cv1", (360, 64, 104, 104), "channels_last"),
    ("b0", (360, 32, 208, 208), "nchw"),
    ("13x13", (360, 512, 13, 13), "channels_last"),
    ("13x13", (360, 512, 13, 13), "nchw"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# kernels: build, check against the plain version, time
# ---------------------------------------------------------------------------


def log_nvcc(reports: dict) -> None:
    """Each built kernel's register, spill and error lines of ``-Xptxas -v``."""
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")) or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")


def time_ms(fn, reps: int = 50, flush_bytes: int = 64 << 20, before=None) -> float:
    """Median device time of ``fn`` in ms, one call per CUDA event pair.

    Before each call a write of more than the 50 MB L2 evicts the inputs (the
    loop finds the frame chunk cold: the detector runs between two
    preprocessing calls), and a spin of about 0.5 ms keeps the card busy
    while the host queues the call, so the host's own overhead does not show
    up as device time.  With ``flush_bytes=0`` the inputs stay in L2 from the
    call before.  ``before``, if given, runs ahead of each call and its
    flush, outside the timed span (an in-place call's input put back)."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if before is not None:
            before()
        if flush_bytes:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def host_ms(fn, reps: int = 50) -> float:
    """Host time to queue one call (the card is kept busy meanwhile)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def crop_letterbox_bound(n: int, cam: int, imgsz: int, out_bytes: int) -> tuple[float, str]:
    """Least time (ms) for n views: each crop byte and index read once, each
    output written once; or the arithmetic, whichever is larger."""
    moved = n * (cam * cam + 4 + 8) + n * imgsz * imgsz * out_bytes
    ops = n * imgsz * imgsz * OPS_PER_OUTPUT_PIXEL
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_crop_letterbox(frames: torch.Tensor, rng: np.random.Generator) -> dict:
    """Kernel vs plain version at each of CHECK_SHAPES and CHECK_VIEWS, both
    output types: crop x origins at every residue mod 16, the first view at
    (0, 0) and the last on the chunk's last frame at (W - cam, H - cam),
    which reads the chunk's last byte; all of it once more on a view of the
    chunk that starts 7 bytes in, so not 16-byte aligned.  Returns the
    largest error of each output type."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_reference, crop_letterbox_views

    c, h, w = frames.shape
    shifted = frames.view(-1)[7 : 7 + (c - 1) * h * w].view(c - 1, h, w)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for chunk in (frames, shifted):
        for cam, imgsz in CHECK_SHAPES:
            for n in CHECK_VIEWS:
                x = rng.integers(0, w - cam + 1, n)
                x = np.clip(x - x % 16 + np.arange(n) % 16, 0, w - cam)
                tls = np.stack([x, rng.integers(0, h - cam + 1, n)], axis=1)
                idx = rng.integers(0, chunk.shape[0], n)
                tls[0] = (0, 0)
                tls[-1], idx[-1] = (w - cam, h - cam), chunk.shape[0] - 1
                idx_t = torch.from_numpy(idx.astype(np.int32)).cuda()
                tls_t = torch.from_numpy(tls.astype(np.int32)).cuda()
                for dtype, atol in ((torch.float32, 2e-6), (torch.bfloat16, 0.01)):
                    got = crop_letterbox_views(chunk, idx_t, tls_t, cam, imgsz, out_dtype=dtype)
                    torch.cuda.synchronize()
                    want = crop_letterbox_reference(chunk, idx_t, tls_t, cam, imgsz, out_dtype=dtype)
                    torch.cuda.synchronize()
                    if got.shape != (n, imgsz, imgsz, 3) or got.dtype != dtype:
                        raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype}")
                    err = (got.float() - want.float()).abs().max().item()
                    if not err <= atol:
                        raise AssertionError(
                            f"crop_letterbox {cam}->{imgsz} N={n} {dtype} at {chunk.data_ptr() % 16}: "
                            f"max error {err} > {atol}"
                        )
                    errs[dtype] = max(errs[dtype], err)
    return errs


def time_crop_letterbox(frames: torch.Tensor, cam: int, imgsz: int, n: int, rng: np.random.Generator) -> dict:
    """Kernel, plain version and ``F.interpolate`` at n views, bfloat16 out."""
    from wtracker_tpu_torch.ops.image import crop_views
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_reference, crop_letterbox_views

    c, h, w = frames.shape
    idx = torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).cuda()
    tls = torch.from_numpy(
        np.stack([rng.integers(0, w - cam + 1, n), rng.integers(0, h - cam + 1, n)], axis=1).astype(np.int32)
    ).cuda()
    # the library call gets the gathered, normalized float32 crops: the same
    # bilinear function (half-pixel centres, edge clamp) on the same pixels
    crops = crop_views(frames, tls, (cam, cam), frame_idx=idx)[:, None].float() * (1.0 / 255.0)
    lib = F.interpolate(crops, size=(imgsz, imgsz), mode="bilinear", align_corners=False)[:, 0]
    plain = crop_letterbox_reference(frames, idx, tls, cam, imgsz, out_dtype=torch.float32)[..., 0]
    lib_err = (lib - plain).abs().max().item()
    if not lib_err <= 1e-4:  # its weights are computed in another order
        raise AssertionError(f"F.interpolate differs from the plain version by {lib_err}")

    kernel = lambda: crop_letterbox_views(frames, idx, tls, cam, imgsz, out_dtype=torch.bfloat16)
    bound_ms, bound_by = crop_letterbox_bound(n, cam, imgsz, out_bytes=2)
    return {
        "host_ms": host_ms(kernel),
        "plain_host_ms": host_ms(lambda: crop_letterbox_reference(frames, idx, tls, cam, imgsz, out_dtype=torch.bfloat16)),
        "ms": time_ms(kernel),
        "ms_l2_warm": time_ms(kernel, flush_bytes=0),
        "plain_ms": time_ms(lambda: crop_letterbox_reference(frames, idx, tls, cam, imgsz, out_dtype=torch.bfloat16)),
        "library_ms": time_ms(
            lambda: F.interpolate(crops, size=(imgsz, imgsz), mode="bilinear", align_corners=False)
        ),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_max_abs_err": lib_err,
        # the same timing of a kernel that does nothing: the floor of the method
        "empty_kernel_ms": time_ms(lambda: torch.cuda._sleep(0)),
    }


def ptxas_kernels(report: str, name: str) -> dict:
    """Registers, static shared memory and spills of each kernel whose
    mangled name holds ``name``, from ``nvcc -Xptxas -v``'s report, by
    mangled name."""
    found, current = {}, None
    for line in report.splitlines():
        fn = re.search(r"Function properties for (\S+)", line)
        if fn:
            current = fn.group(1) if name in fn.group(1) else None
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            found.setdefault(current, {})["spill_stores"], found[current]["spill_loads"] = map(int, spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            found.setdefault(current, {})["registers"] = int(used.group(1))
            found[current]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return found


def time_bias_silu(report: str) -> dict:
    """Phase 43: K4, the bias + SiLU pass of every BN-fused convolution of
    the bf16 detector, at the 360-view shapes of b2.cv1 (channels-last, the
    loop cells), b0 (NCHW, the mixed cell) and the smallest (13 x 13, both
    layouts).  Each is held within one bf16 ulp of its float32 version, then
    timed (medians of 50 launches, L2 flushed, the input put back before
    each) beside the six-launch eager chain it replaces (the bias ``add_``
    and ``_silu``'s five passes) and its byte bound; the instantiations
    spill nothing, and ``bias_silu_.launches`` counts every launch."""
    from wtracker_tpu_torch.models.yolov8 import _silu
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_

    regs = ptxas_kernels(report, "bias_silu_kernel")  # empty where this checkout had built K4 before
    if any(r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in regs.values()):
        raise AssertionError(f"K4's instantiations must spill nothing: {regs}")
    out = {"registers": sorted({r["registers"] for r in regs.values()}), "shapes": []}
    bias_silu_.launches = 0
    launches = 0
    for name, shape, fmt in BIAS_SILU_TIMED:
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        memory_format = torch.channels_last if fmt == "channels_last" else torch.contiguous_format
        x0 = (torch.randn(shape, generator=g, device="cuda") * 4).to(torch.bfloat16)
        x0 = x0.contiguous(memory_format=memory_format)
        b = (torch.randn(shape[1], generator=g, device="cuda") * 2).to(torch.bfloat16)
        y = x0.float() + b.float().view(1, -1, 1, 1)
        want = 0.5 * y * (torch.tanh(0.5 * y) + 1.0)
        del y
        x = x0.clone()
        bias_silu_(x, b)
        _, exp = torch.frexp(want)
        ulps = ((x.float() - want).abs() / torch.ldexp(torch.ones_like(want), exp - 8)).max().item()
        del want, exp
        if not ulps <= 1.0:
            raise AssertionError(f"K4 at {name} {shape} {fmt} is {ulps} bf16 ulps from its float32 version")
        restore = lambda: x.copy_(x0)
        kernel_ms = time_ms(lambda: bias_silu_(x, b), before=restore)
        eager_ms = time_ms(lambda: _silu(x.add_(b.view(-1, 1, 1))), before=restore)
        queue_ms = host_ms(lambda: bias_silu_(x, b))
        bound_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES_PER_S * 1e3
        launches += 1 + 3 + 50 + 50
        out["shapes"].append({
            "name": name, "shape": list(shape), "layout": fmt, "max_ulps": ulps, "ms": kernel_ms,
            "eager_chain_ms": eager_ms, "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms,
            "speedup_vs_eager": eager_ms / kernel_ms, "host_ms": queue_ms,
        })
        del x, x0
        torch.cuda.empty_cache()
    if bias_silu_.launches != launches:
        raise AssertionError(f"bias_silu_ launched {bias_silu_.launches} times, expected {launches}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# the recording and the loop
# ---------------------------------------------------------------------------


class Recording:
    """Seeded synthetic recording: a static noisy agar background plus an
    elongated Gaussian worm blob on a smooth random-walk track.  Rendered in
    bulk into host memory at set-up, so the loop's frame source is a slice,
    as a decoder's output buffer would be."""

    def __init__(self, num_frames: int, hw: tuple[int, int], seed: int):
        from wtracker_tpu_torch.sim.synthetic import make_trajectory

        rng = np.random.default_rng(seed)
        self.hw = hw
        self.traj = make_trajectory(num_frames, hw, seed=seed + 1, margin=200)
        bg = np.clip(rng.normal(40.0, 6.0, hw), 0, 255).astype(np.uint8)
        self.background = bg
        self.data = np.repeat(bg[None], num_frames, axis=0)
        win = 32  # half side of the window the blob is drawn in
        dy, dx = np.mgrid[-win:win, -win:win].astype(np.float32)
        for i, (cx, cy) in enumerate(self.traj):
            x0, y0 = int(round(cx)), int(round(cy))
            blob = 160.0 * np.exp(-0.5 * (((dx + x0 - cx) / 5.0) ** 2 + ((dy + y0 - cy) / 3.0) ** 2))
            # the track keeps a 200 px margin, so the window lies inside the frame
            patch = self.data[i, y0 - win : y0 + win, x0 - win : x0 + win]
            patch[:] = np.clip(patch + blob, 0, 255).astype(np.uint8)

    def frames(self, start: int, count: int) -> np.ndarray:
        return self.data[start : start + count]

    def windows(self, start: int, count: int, top_lefts: np.ndarray, out: np.ndarray) -> np.ndarray:
        """ROI streaming's window source: one window of each frame, at its
        (x, y) origin, into ``out`` (count, win_h, win_w)."""
        win_h, win_w = out.shape[1:3]
        for i, (x, y) in enumerate(np.asarray(top_lefts, dtype=np.int64)):
            out[i] = self.data[start + i, y : y + win_h, x : x + win_w]
        return out

    def view(self, f: int, cam: int) -> np.ndarray:
        """The cam x cam view of frame ``f`` centred on the worm."""
        h, w = self.hw
        x0 = int(np.clip(round(self.traj[f][0]) - cam // 2, 0, w - cam))
        y0 = int(np.clip(round(self.traj[f][1]) - cam // 2, 0, h - cam))
        return self.data[f, y0 : y0 + cam, x0 : x0 + cam]


def run_loop(params, config, recording, num_frames, detector, predictor, device, **kw):
    """One ``run_video_live`` over the recording (``kw``: its ROI arguments);
    returns the logs and the wall seconds."""
    from wtracker_tpu_torch.sim.engine_video import run_video_live

    init = tuple(int(round(v)) for v in recording.traj[0])
    t0 = time.perf_counter()
    logs = run_video_live(
        params, config, recording.frames, num_frames, detector, predictor, init,
        cycles_per_chunk=CYCLES_PER_CHUNK, device=device, **kw,
    )
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return logs, time.perf_counter() - t0


def log_diffs(a, b) -> tuple[int, float]:
    """Largest position difference (px) and box difference (px) of two runs;
    a box found in one run and missed in the other fails."""
    pos = int(np.abs(a.positions.cpu().numpy() - b.positions.cpu().numpy()).max())
    ba, bb = a.worm_bboxes.cpu().numpy(), b.worm_bboxes.cpu().numpy()
    if not np.array_equal(np.isnan(ba), np.isnan(bb)):
        raise AssertionError("the two runs detected the worm in different frames")
    return pos, float(np.nanmax(np.abs(ba - bb))) if np.isfinite(ba).any() else 0.0


def tracking_quality(params, logs, recording) -> dict:
    """Detection rate and centre error of the logged worm boxes against the
    true track, and how far the platform strayed from the worm."""
    pos = logs.positions.numpy().reshape(-1, 2).astype(np.float64)
    boxes = logs.worm_bboxes.numpy().reshape(-1, 4)
    gt = recording.traj[: len(pos)]
    ok = np.isfinite(boxes).all(axis=1)
    err = np.hypot(*(boxes[ok, :2] + boxes[ok, 2:] / 2 - gt[ok]).T)
    stray = np.hypot(*(pos - gt).T)[params.cycle_n * 3 :]
    return {
        "detection_rate": float(ok.mean()),
        "median_center_err_px": float(np.median(err)) if ok.any() else float("nan"),
        "max_platform_stray_px": float(stray.max()),
    }


def check_tracking(quality: dict, cam: int) -> None:
    """The trained-tracking bar: >= 95 % detected, median centre error
    <= 4 px, the worm never outside the camera view."""
    if not (quality["detection_rate"] >= 0.95 and quality["median_center_err_px"] <= 4.0):
        raise AssertionError(f"the loop lost the worm: {quality}")
    if not quality["max_platform_stray_px"] < cam / 2:
        raise AssertionError(f"the worm left the camera view: {quality}")


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of (N, 4) xywh boxes, row by row."""
    lo = np.maximum(a[:, :2], b[:, :2])
    hi = np.minimum(a[:, :2] + a[:, 2:], b[:, :2] + b[:, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    return inter / (a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter)


# ---------------------------------------------------------------------------
# the folded stem
# ---------------------------------------------------------------------------


def check_folded_detect(model, model32, cpu_model, recording, cam: int, imgsz: int) -> dict:
    """The folded-stem detector against the standard letterbox -> conv
    detector on the card: in float32 on 12 views of the recording, boxes
    within 1e-3 px (the JAX package's bar); in bfloat16 against the float32
    detector on the CPU, IoU >= 0.9.  Then times the stem and the whole
    detector both ways, bfloat16, at one sub-batch of the synthetic loop
    (rendered float32 views)."""
    from wtracker_tpu_torch.models.yolov8 import (
        detect_top1,
        fold_stem_matrices,
        make_folded_detect,
        preprocess_batch,
        stem_apply,
    )
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    size = (imgsz, imgsz)
    frames = np.linspace(0, len(recording.traj) - 1, FOLD_CHECK_VIEWS).round().astype(int)
    views = torch.from_numpy(np.stack([recording.view(f, cam) for f in frames])).cuda()
    fold32 = make_folded_detect(model32, (cam, cam), size)
    fold16 = make_folded_detect(model, (cam, cam), size)
    with torch.inference_mode():
        got = fold32(model32, views, size, 0.1).cpu().numpy()
        want = detect_top1(model32, views, size, 0.1).cpu().numpy()
        got16 = fold16(model, views[:4], size, 0.1).cpu().numpy()
        ref = detect_top1(cpu_model, views[:4].cpu(), size, 0.1).numpy()
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError("a detector missed the worm in the folded-stem check")
    f32_err = float(np.abs(got - want).max())
    if not f32_err <= 1e-3:
        raise AssertionError(f"float32 folded and standard detectors differ by {f32_err} px")
    iou16 = iou(ref, got16)
    if not (np.isfinite(iou16).all() and (iou16 >= 0.9).all()):
        raise AssertionError(f"bf16 folded detector disagrees with the CPU float32 detector: IoU {iou16}")

    n = SYNTH_STREAMS * 15 // SYNTH_CHUNKS
    rng = np.random.default_rng(SEED)
    tls = torch.from_numpy(rng.uniform(0, 1000, (n, 2)).round().astype(np.float32)).cuda()
    worm = tls + cam / 2 + torch.from_numpy(rng.uniform(-30, 30, (n, 2)).astype(np.float32)).cuda()
    rendered = SyntheticScene().render_views(worm, tls, (cam, cam), torch.arange(n, device="cuda"))
    mats = fold_stem_matrices((cam, cam), size, dtype=model.compute_dtype, device=rendered.device)

    def standard_stem():
        x, _ = preprocess_batch(rendered, size, dtype=model.compute_dtype)
        return model.b0(x.permute(0, 3, 1, 2))

    with torch.inference_mode():
        times = {
            "standard_stem_ms": time_ms(standard_stem, reps=10, flush_bytes=0),
            "folded_stem_ms": time_ms(lambda: stem_apply(mats, model.stem_float32(), rendered), reps=10, flush_bytes=0),
            "standard_detect_ms": time_ms(lambda: detect_top1(model, rendered, size, 0.1), reps=10, flush_bytes=0),
            "folded_detect_ms": time_ms(lambda: fold16(model, rendered, size, 0.1), reps=10, flush_bytes=0),
        }
    return {
        "f32_max_abs_err_px": f32_err,
        "bf16_iou_vs_cpu_f32": iou16.tolist(),
        "views_checked": len(frames),
        "timed_views": n,
        **times,
    }


# ---------------------------------------------------------------------------
# the synthetic flagship loop and the decision step
# ---------------------------------------------------------------------------


def bench_params():
    """The bench's geometry (``tools/gates.py::deployment_params``, which
    ``tools/bench.py::build_flagship`` builds on): 60 fps, 1400x1600 px
    arena, 90 px/mm, 4 mm camera (360 px), timing 200/40/50 ms (12 + 3
    frames a cycle), headless frame bounds."""
    from wtracker_tpu_torch.tools.gates import deployment_params

    params = deployment_params()
    if not (params.cam_w == params.cam_h == 360 and params.cycle_n == 15):
        raise AssertionError(f"bench geometry changed: {params}")
    return params


def synthetic_loop(model32):
    """The flagship path at the bench's configuration, built by
    ``tools/bench.py::build_flagship``: ``make_stream_batch_fused`` +
    ``run_engine_streams(delayed_log=True)``, S=96 streams, YOLOv8s@416
    bf16 with the folded stem (the default for the BN-fused detector), the
    seeded ResMLP, 12 cycles.  Returns the phase's numbers, a function that
    runs the loop once more and returns its wall seconds, and the bench's
    context (phase 10 times its decision)."""
    from dataclasses import replace

    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import _resolve_detect, make_stream_batch_fused
    from wtracker_tpu_torch.tools.bench import build_flagship
    from wtracker_tpu_torch.tools.gates import tracking_quality as closed_loop_quality

    S = SYNTH_STREAMS
    ctx = build_flagship(S=S, n_cycles=SYNTH_CYCLES)
    params, cfg, trajs = ctx.params, ctx.cfg, ctx.trajs
    if params != bench_params():
        raise AssertionError(f"the bench's geometry {params} is not the deployment geometry")
    if cfg.detect_chunks != SYNTH_CHUNKS:
        raise AssertionError(f"the bench picked {cfg.detect_chunks} detect sub-batches, not {SYNTH_CHUNKS}")
    if not getattr(_resolve_detect(None, cfg, ctx.det_model, (params.cam_h, params.cam_w)), "folds_preproc", False):
        raise AssertionError("the bench configuration did not select the folded stem")
    ctl = ctx.make_ctl("bf16")

    def run(ctl=ctl, n_streams=S, n_cycles=SYNTH_CYCLES):
        t0 = time.perf_counter()
        logs = run_engine_streams(params, ctl, ctx.init_pos[:n_streams], n_cycles, delayed_log=True, device="cuda")
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    crop_letterbox_views.launches = 0
    with k4_per_forward("the synthetic loop's warm-up", need=("folded",)) as k4:
        logs, warm_s = run()
    secs = [run()[1] for _ in range(SYNTH_TIMED_RUNS)]
    launches = crop_letterbox_views.launches
    if launches != 0:
        raise AssertionError(f"the synthetic loop launched crop_letterbox {launches} times")
    if logs.positions.shape != (SYNTH_CYCLES, S, params.cycle_n, 2) or logs.worm_bboxes.shape != (SYNTH_CYCLES, S, params.cycle_n, 4):
        raise AssertionError(f"synthetic log shapes {tuple(logs.positions.shape)} {tuple(logs.worm_bboxes.shape)}")
    quality = closed_loop_quality(params, logs, trajs)
    log(f"synthetic loop S={S}: {quality}, runs {warm_s:.3f} (warm-up) {secs}")
    if not (quality["detection_rate"] >= 0.95 and quality["median_center_err_px"] <= 4.0):
        raise AssertionError(f"the synthetic loop lost the worm: {quality}")
    if not quality["in_camera_share_after_cycle_3"] >= 0.95:
        raise AssertionError(f"the worm left the camera in the synthetic loop: {quality}")

    # float32, S=4, 4 cycles: the folded and the standard stem give one track
    logs32 = {}
    for fold in (True, False):
        c = replace(cfg, fold_stem=fold, detect_chunks=1)
        ctl32 = make_stream_batch_fused(params, c, ctx.scene, trajs[:4], model32, ctx.predictor, device="cuda")
        logs32[fold] = run(ctl32, 4, 4)[0]
    pos32, box32 = log_diffs(logs32[True], logs32[False])
    if not (pos32 == 0 and box32 <= 1e-2):
        raise AssertionError(f"float32 folded and standard synthetic loops differ: {pos32} px, {box32} px")

    wall = float(np.median(secs))
    out = {
        "streams": S,
        "cycles": SYNTH_CYCLES,
        "detect_chunks": cfg.detect_chunks,
        "views_per_sub_batch": S * params.cycle_n // cfg.detect_chunks,
        "steps_per_s": S * SYNTH_CYCLES * params.cycle_n / wall,
        "cycles_per_s": SYNTH_CYCLES / wall,
        "warmup_s": warm_s,
        "run_s": secs,
        "crop_letterbox_launches": launches,
        "warmup_k4": k4,
        "f32_fold_vs_standard_pos_max_abs_diff": pos32,
        "f32_fold_vs_standard_box_max_abs_diff": box32,
        **quality,
    }
    return out, lambda: run()[1], ctx


def decision_latency(ctx, S: int) -> dict:
    """``tools/bench.py::measure_decision_latency`` of the bf16 decision
    (``make_decision_step``) at S streams, on the bench's inputs (k = 5
    rendered views a stream around the worm): 10 warm-ups, then
    DECISION_REPS decisions, each timed on the host from the call until its
    move is on the host, then as many more traced, each one's card busy
    time.  Every move
    must be the same, and within reach."""
    from wtracker_tpu_torch.tools.bench import BUDGET_MS, measure_decision_latency

    moves = []
    out = measure_decision_latency(ctx, "bf16", S, DECISION_REPS, moves=moves)
    if len(moves) != DECISION_REPS or "device" not in out:
        raise AssertionError(f"decision latency at S={S}: {len(moves)} moves, {out}")
    move = moves[-1].numpy()
    # every decision the same; the move is the clipped MLP step plus the
    # newest detection's offset from the camera centre (<= 8 px + error)
    if move.shape != (S, 2) or move.dtype != np.int32 or any(not np.array_equal(m.numpy(), move) for m in moves):
        raise AssertionError(f"decision moves: {[m.tolist() for m in moves[:3]]}")
    if not np.abs(move).max() <= ctx.cfg.max_dist_per_pred + 16:
        raise AssertionError(f"decision move {move.tolist()} is out of reach")
    k = len(ctx.predictor.io_config.input_frames)
    return {"streams": S, "views": S * k, "budget_ms": BUDGET_MS, **out, "move": move.tolist()}


# ---------------------------------------------------------------------------
# ROI streaming, the track_video command, the multi-recording loop
# ---------------------------------------------------------------------------


def assert_same_logs(a, b, what: str) -> None:
    """Bit-identical positions and boxes (NaN where the other has NaN)."""
    if a.positions.shape != b.positions.shape or a.worm_bboxes.shape != b.worm_bboxes.shape:
        raise AssertionError(f"{what}: log shapes differ")
    if not np.array_equal(a.positions.numpy(), b.positions.numpy()):
        raise AssertionError(f"{what}: positions differ by up to {log_diffs(a, b)[0]} px")
    if not np.array_equal(a.worm_bboxes.numpy(), b.worm_bboxes.numpy(), equal_nan=True):
        raise AssertionError(f"{what}: boxes differ by up to {log_diffs(a, b)[1]} px")


def roi_loop(params, base, recording, num_frames, models, predictor, refs) -> dict:
    """ROI streaming at 480 px and at 364 px (4 px of slack: the speculation
    misses and chunks replay), through K1 in bfloat16 and float32, then at
    the default ``fold_stem=None``: each run bit-identical to the whole-frame
    loop of the same detector (``refs``); K1 launched 2 times a cycle plus 2
    per replayed cycle.  Then ROI and whole-frame cycles/s in turns."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig

    n_cycles = params.n_logged_cycles(num_frames)
    if n_cycles % ROI_CHUNK_CYCLES:
        raise AssertionError("the launch count below assumes whole ROI chunks")
    H, W = recording.hw
    cfg_k = LiveLoopConfig(**base, use_fused_preproc=True)
    cfg_auto = LiveLoopConfig(**{**base, "fold_stem": None}, use_fused_preproc=True)

    def roi_run(cfg, model, window):
        stats = {}
        crop_letterbox_views.launches = 0
        logs, secs = run_loop(
            params, cfg, recording, num_frames, model, predictor, "cuda", window_source=recording.windows,
            roi_window=window, roi_chunk_cycles=ROI_CHUNK_CYCLES, roi_stats=stats,
        )
        return logs, secs, stats, crop_letterbox_views.launches

    runs = {}
    for dtype, model in models.items():
        for window in ROI_WINDOWS:
            logs, secs, stats, launches = roi_run(cfg_k, model, window)
            name = f"{dtype}_k1_roi{window[0]}"
            assert_same_logs(logs, refs[dtype], name)
            want = 2 * n_cycles + 2 * ROI_CHUNK_CYCLES * stats["replays"]
            if launches != want:
                raise AssertionError(f"{name}: K1 launched {launches} times, expected {want} ({stats})")
            runs[name] = {**stats, "crop_letterbox_launches": launches, "run_s": secs}
            log(f"ROI {name}: {runs[name]}")
        if runs[f"{dtype}_k1_roi{ROI_WINDOWS[-1][0]}"]["replays"] == 0:
            raise AssertionError(f"{dtype}: the {ROI_WINDOWS[-1]} window never missed, so no replay was checked")
    logs, secs, stats, launches = roi_run(cfg_auto, models["bf16"], ROI_WINDOWS[0])
    assert_same_logs(logs, refs["folded"], "folded ROI")
    if launches != 0:
        raise AssertionError(f"the folded ROI loop launched K1 {launches} times")
    runs[f"bf16_folded_roi{ROI_WINDOWS[0][0]}"] = {**stats, "crop_letterbox_launches": launches, "run_s": secs}

    # cycles/s, ROI at 480 px against whole frames, in turns, on both paths
    secs = {}
    for path, cfg in (("k1", cfg_k), ("folded", cfg_auto)):
        for which in ("roi", "whole", "whole", "roi"):
            kw = dict(window_source=recording.windows, roi_window=ROI_WINDOWS[0], roi_chunk_cycles=ROI_CHUNK_CYCLES)
            run = run_loop(
                params, cfg, recording, num_frames, models["bf16"], predictor, "cuda", **(kw if which == "roi" else {})
            )
            secs.setdefault(f"{path}_{which}", []).append(run[1])
    upload = {"whole_frames": params.cycle_n * H * W}
    upload.update({f"roi{h}x{w}": params.cycle_n * h * w for h, w in ROI_WINDOWS})
    return {
        "cycles": n_cycles,
        "roi_chunk_cycles": ROI_CHUNK_CYCLES,
        "runs": runs,
        "cycles_per_s": {k: n_cycles / float(np.median(v)) for k, v in secs.items()},
        "run_s": secs,
        "upload_bytes_per_cycle": upload,
    }


def logs_from_csv(path, cycle_n: int):
    """A ``bboxes.csv`` read back as logs (a 0.0 box is a missed frame)."""
    import pandas as pd

    from wtracker_tpu_torch.sim.engine import CycleLog

    df = pd.read_csv(path)
    if len(df.columns) != 17:
        raise AssertionError(f"{path} has {len(df.columns)} columns, expected 17")
    pos = df[["plt_x", "plt_y"]].to_numpy().reshape(-1, cycle_n, 2)
    boxes = df[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(dtype=np.float64).reshape(-1, cycle_n, 4)
    boxes[(boxes == 0).all(axis=-1)] = np.nan
    return CycleLog(torch.from_numpy(pos), torch.from_numpy(boxes))


def track_video_cli(params, recording, cam: int, detector: Path, timing_config: Path, tmp: Path) -> dict:
    """The first CLI_FRAMES frames of the recording as 8-bit BMPs in ``tmp``
    (kept for the int8 phases): the port's ``FrameReader`` reads them back byte for
    byte, whole and as windows, then ``python -m
    wtracker_tpu_torch.workflows.track_video`` tracks them with ``detector``
    (the trained checkpoint), once on whole frames and once with
    ``--roi 480``.  Both ``bboxes.csv`` files must be the same text and hold
    the tracking bar."""

    from wtracker_tpu_torch.tools.recording import write_frames
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    n = CLI_FRAMES
    frames = recording.data[:n]
    out = {"frames": n}
    (tmp / "frames").mkdir()
    t0 = time.perf_counter()
    out["bytes_on_disk"] = write_frames(str(tmp / "frames"), frames)
    out["write_s"] = time.perf_counter() - t0

    reader = FrameReader.create_from_directory(str(tmp / "frames"))
    if len(reader) != n or reader.frame_size != recording.hw:
        raise AssertionError(f"reader sees {len(reader)} frames of {reader.frame_size}")
    t0 = time.perf_counter()
    got = reader.read_batch()
    out["read_batch_s"] = time.perf_counter() - t0
    if not np.array_equal(got, frames):
        raise AssertionError("FrameReader.read_batch differs from the frames written")
    h, w = recording.hw
    rng = np.random.default_rng(SEED)
    win = ROI_WINDOWS[0]
    tls = np.stack([rng.integers(0, w - win[1] + 1, n), rng.integers(0, h - win[0] + 1, n)], axis=1)
    tls[-1] = (w - win[1], h - win[0])
    t0 = time.perf_counter()
    got = reader.read_window_batch(range(n), tls, win)
    out["read_window_batch_s"] = time.perf_counter() - t0
    want = np.stack([frames[i, y : y + win[0], x : x + win[1]] for i, (x, y) in enumerate(tls)])
    if not np.array_equal(got, want):
        raise AssertionError("FrameReader.read_window_batch differs from the frames written")
    del got, want

    exp = json.loads((ROOT / "configs" / "exp_config.json").read_text())
    exp.update(num_frames=n, init_position=[int(round(v)) for v in recording.traj[0]])
    (tmp / "exp.json").write_text(json.dumps(exp))
    csv = {}
    # the two commands run at once (each one's wall is taken beside the other's)
    jobs = {name: [
        "wtracker_tpu_torch.workflows.track_video", "--frames", tmp / "frames", "--timing-config", timing_config,
        "--exp-config", tmp / "exp.json", "--detector", detector, "--output", tmp / name, "--device", "cuda", *extra,
    ] for name, extra in (("whole_frames", []), ("roi", ["--roi", win[0]]))}
    with ThreadPoolExecutor(len(jobs)) as pool:
        ran = dict(zip(jobs, pool.map(run_module, jobs.values())))
    for name, (wall, proc) in ran.items():
        out[f"{name}_wall_s"] = wall
        if proc.returncode != 0:
            raise AssertionError(f"track_video {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        out[f"{name}_stdout"] = proc.stdout.strip().splitlines()
        csv[name] = (tmp / name / "bboxes.csv").read_text()
    if csv["whole_frames"] != csv["roi"]:
        raise AssertionError("track_video wrote different bboxes.csv with and without --roi")
    logs = logs_from_csv(tmp / "roi" / "bboxes.csv", params.cycle_n)
    if logs.positions.shape[0] != params.n_logged_cycles(n):
        raise AssertionError(f"bboxes.csv holds {logs.positions.shape[0]} cycles")
    quality = tracking_quality(params, logs, recording)
    check_tracking(quality, cam)
    return {**out, **quality, "csv_rows": params.n_logged_cycles(n) * params.cycle_n}


def video_streams(params, base, models, predictor) -> tuple[dict, dict]:
    """``run_video_live_sharded`` over STREAMS seeded recordings at full
    width (default ``fold_stem=None``), each stream held against its own
    ``run_video_live``: float32 positions exact and boxes within 1e-2 px,
    bfloat16 within 2 px; then stream-cycles/s of the bfloat16 loop.
    Returns the phase's numbers and, for phase 34, the recordings, their
    start positions and the bfloat16 logs."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
    from wtracker_tpu_torch.sim.engine_video import run_video_live, run_video_live_sharded

    num_frames = STREAM_CYCLES * params.cycle_n + 1
    recs = [Recording(num_frames, (params.frame_h, params.frame_w), SEED + 1 + s) for s in range(STREAMS)]
    init = np.array([[int(round(v)) for v in r.traj[0]] for r in recs])
    cfg = LiveLoopConfig(**{**base, "fold_stem": None})

    def sharded(model):
        t0 = time.perf_counter()
        logs = run_video_live_sharded(
            params, cfg, [r.frames for r in recs], num_frames, model, predictor, init,
            cycles_per_chunk=STREAM_CHUNK_CYCLES, device="cuda",
        )
        return logs, time.perf_counter() - t0

    out = {"streams": STREAMS, "cycles": STREAM_CYCLES, "cycles_per_chunk": STREAM_CHUNK_CYCLES}
    kept = {"recs": recs, "init": init, "num_frames": num_frames}
    crop_letterbox_views.launches = 0
    for dtype, model in models.items():
        logs, _ = sharded(model)
        kept[f"logs_{dtype}"] = logs
        if logs.positions.shape != (STREAM_CYCLES, STREAMS, params.cycle_n, 2):
            raise AssertionError(f"stream log shape {tuple(logs.positions.shape)}")
        diffs = []
        for s, rec in enumerate(recs):
            solo = run_video_live(
                params, cfg, rec.frames, num_frames, model, predictor, tuple(init[s]),
                cycles_per_chunk=STREAM_CHUNK_CYCLES, device="cuda",
            )
            mine = type(solo)(logs.positions[:, s], logs.worm_bboxes[:, s])
            pos, box = log_diffs(mine, solo)
            bar = (0, 1e-2) if dtype == "f32" else (2, 2.0)
            if not (pos <= bar[0] and box <= bar[1]):
                raise AssertionError(f"{dtype} stream {s} differs from its solo run: {pos} px, {box} px")
            diffs.append((pos, box))
            check_tracking(tracking_quality(params, mine, rec), params.cam_w)
        out[f"{dtype}_pos_box_max_abs_diff_vs_solo"] = diffs
    if crop_letterbox_views.launches != 0:
        raise AssertionError("the folded stream loop launched K1")
    secs = [sharded(models["bf16"])[1] for _ in range(3)]
    out["run_s"] = secs
    out["stream_cycles_per_s"] = STREAMS * STREAM_CYCLES / float(np.median(secs))
    return out, kept


# ---------------------------------------------------------------------------
# replay (simulate), sweeps, the mixed-geometry live loop
# ---------------------------------------------------------------------------

WORM_COLS = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]


def worm_boxes(num_frames: int, arena_hw: tuple[int, int], seed: int) -> np.ndarray:
    """A seeded (N, 4) xywh worm log along ``make_trajectory``'s track, box
    sizes drawn per frame, NaN rows every 37th frame (the dropouts of
    tests/synthetic.py)."""
    from wtracker_tpu_torch.sim.synthetic import make_trajectory

    rng = np.random.default_rng(seed)
    traj = make_trajectory(num_frames, arena_hw, seed=seed)
    w, h = rng.uniform(16, 24, num_frames), rng.uniform(10, 16, num_frames)
    boxes = np.stack([traj[:, 0] - w / 2, traj[:, 1] - h / 2, w, h], axis=1)
    boxes[::37] = np.nan
    return boxes


def worm_csv(path, num_frames: int, arena_hw: tuple[int, int], seed: int) -> np.ndarray:
    """Write :func:`worm_boxes` as a log with ``wrm_*`` columns; returns the
    table as pandas reads it back, which is what the commands read."""
    import pandas as pd

    pd.DataFrame(worm_boxes(num_frames, arena_hw, seed), columns=WORM_COLS).to_csv(path, index=False)
    return pd.read_csv(path)[WORM_COLS].to_numpy(dtype=float)


def exp0_4() -> tuple[list, list, list]:
    """configs/exp0-exp4: their ExperimentConfigs, their TimingConfigs as
    the sweep command builds them (each experiment's own timing file), and
    the (config, timing) paths."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig

    paths = [(ROOT / "configs" / f"exp{i}_config.json", ROOT / "configs" / f"exp{i}_timing.json") for i in range(5)]
    exps, timings = [], []
    for e, t in paths:
        exps.append(ExperimentConfig.load_json(str(e)))
        b = TimingConfig.load_json(str(t))
        timings.append(TimingConfig(
            experiment_config=exps[-1], imaging_time_ms=b.imaging_time_ms, pred_time_ms=b.pred_time_ms,
            moving_time_ms=b.moving_time_ms, camera_size_mm=b.camera_size_mm, micro_size_mm=b.micro_size_mm,
        ))
    return exps, timings, paths


def worm_in_view_share(params, logs, table: np.ndarray) -> float:
    """Share of logged frames with a worm box whose centre lies inside the
    camera view around the platform."""
    pos = logs.positions.cpu().numpy().reshape(-1, 2).astype(np.float64)
    rows = table[: len(pos)]
    ok = np.isfinite(rows).all(axis=1)
    off = np.abs(rows[ok, :2] + rows[ok, 2:] / 2 - pos[ok])
    return float(((off[:, 0] < params.cam_w / 2) & (off[:, 1] < params.cam_h / 2)).mean())


def cuda_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


REPLAY_NAMES = ("csv", "optimal", "polyfit", "mlp", "csv_step")


def replay_setup(tmp: Path, table: np.ndarray | None = None):
    """Phase 14's configuration: its configs, the worm log (``table``, or
    ``tmp/worm.csv`` read back as the commands read it), the headless
    frame shape, the logged cycles and a controller builder ``build(name,
    device, predictor)`` for :data:`REPLAY_NAMES`."""
    import pandas as pd

    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig

    exp_path, timing_path = ROOT / "configs" / "exp_config.json", ROOT / "configs" / "timing_config.json"
    exp, timing = ExperimentConfig.load_json(str(exp_path)), TimingConfig.load_json(str(timing_path))
    if table is None:
        table = pd.read_csv(tmp / "worm.csv")[WORM_COLS].to_numpy(dtype=float)
    frame_hw = te.headless_frame_shape(timing, exp.orig_resolution)
    n = te.EngineParams.from_timing(timing, frame_hw).n_logged_cycles(exp.num_frames)

    def build(name: str, dev: str, predictor=None):
        params = te.EngineParams.from_timing(timing, frame_hw, motor="step" if name == "csv_step" else "sine")
        if name in ("csv", "csv_step"):
            return params, te.csv_controller(table, params, device=dev)
        if name == "optimal":
            return params, te.optimal_controller(table, params, device=dev)
        if name == "polyfit":
            times = np.array(REPLAY_POLYFIT_TIMES)
            return params, te.polyfit_controller(table, params, times, np.ones(len(times)), 2, device=dev)
        bound = te.mlp_max_dist_per_pred(timing, predictor.io_config)
        return params, te.mlp_controller(table, params, predictor, bound, device=dev)

    return exp, table, n, build


def cpu_polyfit_replay(tmp: str, high_deg: bool = False) -> int:
    """A polyfit replay on the CPU in a child process, beside work on the
    card: phase 14's over every cycle (``chip_smoke.py --cpu-polyfit TMP``,
    into ``cpu_polyfit.csv``) or, with ``high_deg``, phase 41's at deg
    HIGH_DEG over HIGH_DEG_TIMES for HIGH_DEG_CYCLES cycles
    (``--cpu-polyfit-deg8 TMP``, into ``cpu_polyfit_deg8.csv``).  Prints
    its cycles and seconds."""
    from wtracker_tpu_torch.sim import engine as te

    torch.set_num_threads(1)  # one fit is a few hundred tiny ops: threads only contend
    tmp = Path(tmp)
    exp, table, n, build = replay_setup(tmp)
    if high_deg:
        params, _ = build("csv", "cpu")
        times = np.array(HIGH_DEG_TIMES, dtype=np.float64)
        ctl = te.polyfit_controller(table, params, times, np.ones(len(times)), HIGH_DEG, device="cpu")
        n = HIGH_DEG_CYCLES
    else:
        params, ctl = build("polyfit", "cpu")
    t0 = time.perf_counter()
    logs = te.run_engine(params, ctl, exp.init_position, n, device="cpu")
    seconds = time.perf_counter() - t0
    (tmp / CPU_POLYFIT_CSV[high_deg]).write_text(te.logs_to_frame(params, logs).to_csv(index=False))
    print(json.dumps({"cycles": n, "seconds": seconds}))
    return 0


CPU_POLYFIT_CSV = {False: "cpu_polyfit.csv", True: "cpu_polyfit_deg8.csv"}


def start_cpu_polyfit(tmp: Path, high_deg: bool = False) -> subprocess.Popen:
    """Starts :func:`cpu_polyfit_replay` in a child process."""
    flag = "--cpu-polyfit-deg8" if high_deg else "--cpu-polyfit"
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag, str(tmp)], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_cpu_polyfit(proc: subprocess.Popen, tmp: Path, high_deg: bool = False) -> tuple[dict, str]:
    """Waits for :func:`start_cpu_polyfit`'s child: its cycles and seconds,
    and the ``bboxes.csv`` text it wrote."""
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the CPU polyfit replay exited {proc.returncode}:\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1]), (tmp / CPU_POLYFIT_CSV[high_deg]).read_text()


def stop_child(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def replay(tmp: Path, device: str = "cuda") -> tuple[dict, dict, list]:
    """Phase 14: ``run_engine`` with the csv, optimal, polyfit (degree 2 at
    [-15, -10, -5, 0, 3]) and mlp (the seeded predictor) controllers and the
    csv controller on the step motor, at the deployment configuration over a
    seeded 61,200-frame worm log: cycles/s a controller over every cycle
    (after a 20-cycle warm-up), K3 launched once a polyfit cycle and never
    by the others; polyfit over the first REPLAY_CLI_CYCLES cycles through
    ``python -m wtracker_tpu_torch.workflows.simulate`` with the experiment
    cut to them (wall time; the timed run's first rows), and, beside the
    command, the same runs on the CPU over every cycle: polyfit in a child
    process (:func:`cpu_polyfit_replay`, started after the card's runs, so
    that no timed card run shares the host with it), the others in this
    one.  csv, optimal, polyfit and step give the card's ``bboxes.csv``
    text, mlp equal positions in >= 99.9 % of frames and none 2 px apart.
    Returns the phase's numbers, for ``--profile`` a function per profiled
    controller that runs PROFILE_REPLAY_CYCLES cycles, and the (x, y, w) of
    the polyfit warm-up's fits on the card (phase 41 holds K3 to them)."""
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor, save_predictor
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.sim import engine as te

    exp = json.loads((ROOT / "configs" / "exp_config.json").read_text())
    table = worm_csv(tmp / "worm.csv", exp["num_frames"], tuple(exp["orig_resolution"]), SEED)
    exp_cfg, _, n, build = replay_setup(tmp, table)
    predictors = {
        dev: make_rmlp_predictor(IOConfig([0, -3, -6, -9, -12], [3]), seed=SEED, device=dev) for dev in {device, "cpu"}
    }
    save_predictor(predictors["cpu"], str(tmp / "predictor.npz"))  # phase 23's mlp

    def run(name: str, dev: str, n_cycles: int = n):
        params, ctl = build(name, dev, predictors[dev])
        t0 = time.perf_counter()
        logs = te.run_engine(params, ctl, exp_cfg.init_position, n_cycles, device=dev)
        cuda_sync(dev)
        return params, logs, time.perf_counter() - t0

    fits, _fit = [], te.polyfit

    def recorded(x, y, deg, w=None):  # the polyfit warm-up's fits, kept for phase 41
        fits.append((x.clone(), y.clone(), w.clone()))
        return _fit(x, y, deg, w)

    out = {"cycles": n, "frames": exp_cfg.num_frames, "controllers": {}}
    texts, logs_by = {}, {}
    for name in REPLAY_NAMES:
        if name == "polyfit":
            te.polyfit = recorded
        try:
            run(name, device, 20)  # warm-up
        finally:
            te.polyfit = _fit
        zero_hand_kernel_launches()
        params, logs, wall = run(name, device)
        on_card = name == "polyfit" and device == "cuda"
        launches = check_no_hand_kernel(f"the {name} replay", expect=("polyfit",) if on_card else ())
        if on_card and launches["polyfit"] != n:
            raise AssertionError(f"the polyfit replay launched K3 {launches['polyfit']} times in {n} cycles")
        if logs.positions.shape != (n, params.cycle_n, 2):
            raise AssertionError(f"{name}: log shape {tuple(logs.positions.shape)}")
        share = worm_in_view_share(params, logs, table)
        if not share >= 0.95:
            raise AssertionError(f"{name}: the worm was in view in only {share:.4f} of the frames")
        texts[name], logs_by[name] = te.logs_to_frame(params, logs).to_csv(index=False), logs
        (tmp / f"engine_{name}.csv").write_text(texts[name])  # phase 23 holds the host backend to it
        out["controllers"][name] = {
            "cycles": n, "cycles_per_s": n / wall, "ms_per_cycle": wall / n * 1e3, "run_s": wall,
            "worm_in_view_share": share, "launches": launches,
        }
        log(f"replay {name}: {n / wall:.1f} cycles/s over {n} cycles")
    out["crop_letterbox_launches"] = 0  # asserted for every controller above
    if len(fits) != 20:
        raise AssertionError(f"the polyfit warm-up made {len(fits)} fits in 20 cycles")

    # the command, as a user runs it (the default polyfit config), over the
    # timed run's first REPLAY_CLI_CYCLES cycles: the experiment config cut
    # to them
    exp_path, timing_path = ROOT / "configs" / "exp_config.json", ROOT / "configs" / "timing_config.json"
    cut = {**json.loads(exp_path.read_text()), "num_frames": REPLAY_CLI_CYCLES * params.cycle_n + 1}
    (tmp / "exp_cli.json").write_text(json.dumps(cut))
    cmd = [
        "wtracker_tpu_torch.workflows.simulate", "--timing-config", timing_path, "--exp-config", tmp / "exp_cli.json",
        "--worm-csv", tmp / "worm.csv", "--output", tmp / "simulate", "--controller", "polyfit", "--device", device,
    ]
    # the command runs beside the CPU reruns: polyfit over every cycle in
    # its child process, the others here
    cpu_polyfit = start_cpu_polyfit(tmp)
    try:
        with ThreadPoolExecutor(1) as pool:
            simulate = pool.submit(run_module, cmd)
            cpu = {}
            for name in REPLAY_NAMES:
                if name == "polyfit":
                    continue
                params, logs, wall = run(name, "cpu")
                cpu[name] = {"cycles": n, "cycles_per_s": n / wall}
                if name == "mlp":
                    card = logs_by[name].positions.cpu().numpy()
                    diff = np.abs(logs.positions.numpy() - card).max(axis=-1).reshape(-1)
                    cpu[name].update(frames_equal_share=float((diff == 0).mean()), max_abs_pos_diff_px=int(diff.max()))
                    if not (cpu[name]["frames_equal_share"] >= 0.999 and diff.max() <= 2):
                        raise AssertionError(f"mlp on the card and on the CPU drift apart: {cpu[name]}")
                else:
                    if te.logs_to_frame(params, logs).to_csv(index=False) != texts[name]:
                        raise AssertionError(f"{name}: the card and the CPU wrote different bboxes.csv text")
                    cpu[name]["identical_text"] = True
            t0 = time.perf_counter()
            ran, text = finish_cpu_polyfit(cpu_polyfit, tmp)
            if text != texts["polyfit"]:
                raise AssertionError("polyfit: the card and the CPU wrote different bboxes.csv text over the whole log")
            cpu["polyfit"] = {"cycles": ran["cycles"], "cycles_per_s": ran["cycles"] / ran["seconds"],
                              "identical_text": True, "child_process": True, "waited_s": time.perf_counter() - t0}
            out["cpu"] = cpu
            out["cli_polyfit_wall_s"], proc = simulate.result()
    finally:
        stop_child(cpu_polyfit)
    if proc.returncode != 0:
        raise AssertionError(f"simulate exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    cli_lines = (tmp / "simulate" / "bboxes.csv").read_text().splitlines()
    if not (len(cli_lines) == 1 + REPLAY_CLI_CYCLES * params.cycle_n
            and cli_lines == texts["polyfit"].splitlines()[:len(cli_lines)]):
        raise AssertionError("the simulate command's bboxes.csv is not the in-process polyfit run's first rows")
    out["cli_polyfit_cycles"] = REPLAY_CLI_CYCLES
    out["cli_stdout"] = proc.stdout.strip().splitlines()
    profiled = {f"replay_{k}": (lambda k=k: run(k, device, PROFILE_REPLAY_CYCLES)[2]) for k in ("polyfit", "csv")}
    return out, profiled, fits


# ---------------------------------------------------------------------------
# K3, the float64 polyfit (phase 41)
# ---------------------------------------------------------------------------


def polyfit_work(p: int, n: int, k: int, m: int, sweeps: int = 12) -> tuple[int, int]:
    """Float64 operations and bytes of one K3 launch: P weightings of N
    samples, k = deg + 1 terms, M columns.  Each rounded product, sum,
    quotient or root counts 1; a rotation is 15 scalar operations and 6 a
    row or column entry (rows, columns and eigenvectors: 18k); each input
    read once, the (P, k, M) output written once."""
    per_fit = (n * (k - 1) + n * k  # Vandermonde, weights
               + 2 * n * k + k + n * k  # column sums of squares, roots, scaling
               + 2 * n * k * k  # normal matrix
               + sweeps * k * (k - 1) // 2 * (15 + 18 * k)
               + 3 * k + 1)  # clamp, cutoff, reciprocals
    per_col = n + 2 * n * k + 4 * k * k + 2 * k  # right-hand side, atb, projection, solve, scale, unscale
    return p * (per_fit + m * per_col), 8 * (n + n * m + p * n + p * k * m)


def _polyfit_cases(x5: torch.Tensor, x8: torch.Tensor, rng: np.random.Generator) -> list:
    """Seeded (name, x, y, deg, w, workspace) cases on the card: deg 1-5, y (N,)
    and (N, M), w (N,) and (100, N), zero weights, an all-masked fit
    (weights and samples zeroed, as the engine zeroes a cycle without
    detections) and a rank-deficient one, at the engine's and the swarm's
    times; the same at deg 8, 9 (11 sample times), 12 and 15 (16), in the
    general form; then the grid's edges: M just below, at and above a
    column tile and into a fifth one at P=100, P=1 over 7,993 columns,
    P=1,000 over 2, deg 0-7 with N at the 48 KB limit, and the zeroed,
    all-masked (signed zeros in y) and rank-deficient weightings at P=100
    over several tiles; N beyond the register form's rows at deg 2
    (20,000), 8 (1,000) and 12 (500); deg 2, 7 and 8 at the swarm's batch
    forced into the general form in shared memory and in its global
    workspace; the wave form below deg 7 with every edge case, deg 4-6 at
    the swarm's batch and deg 0, 2 and 3 with N just beyond the register
    form's rows.  ``workspace`` is None (the routing of ``polyfit``) or
    what ``ops/polyfit.py::_polyfit_kernel`` takes to force the general
    form."""
    from wtracker_tpu_torch.ops.polyfit import KERNEL_COL_THREADS, KERNEL_REGISTER_ROWS

    cases = []
    x11, x16 = (torch.tensor(t, dtype=torch.float64, device="cuda") for t in (HIGH_DEG_TIMES, LONG_TIMES))

    def track(x, m):
        t = x.cpu().numpy()
        return torch.from_numpy(180 + 2.5 * t[:, None] + 0.1 * t[:, None] ** 2 + rng.normal(0, 3, (len(t), m))).cuda()

    def weightings(p, n):
        return torch.from_numpy(rng.uniform(0.0, 1.0, (p, n))).cuda()

    for deg in (1, 2, 3, 4, 5, 8, 9, 12, 15):
        x = x5 if deg <= 2 else x8 if deg <= 5 else x11 if deg <= 9 else x16
        n = x.shape[0]
        y = track(x, 2)
        w = torch.from_numpy(rng.uniform(0.2, 2.0, n)).cuda()
        zeroed, masked, deficient = w.clone(), torch.zeros_like(w), w.clone()
        zeroed[[1, 3]] = 0.0
        deficient[2:] = 0.0
        cases += [
            (f"deg{deg}_y2d", x, y, deg, w), (f"deg{deg}_y1d", x, y[:, 0].contiguous(), deg, w),
            (f"deg{deg}_p100", x, y, deg, weightings(PSO_POP, n)), (f"deg{deg}_zero_weights", x, y, deg, zeroed),
            (f"deg{deg}_all_masked", x, torch.zeros_like(y), deg, masked), (f"deg{deg}_rank_deficient", x, y, deg, deficient),
        ]
    for m in (KERNEL_COL_THREADS - 1, KERNEL_COL_THREADS, KERNEL_COL_THREADS + 1, 5 * KERNEL_COL_THREADS + 1):
        cases.append((f"p100_m{m}", x8, track(x8, m), 2, weightings(PSO_POP, 8)))
    cases += [("p1_m7993", x8, track(x8, 7993), 2, weightings(1, 8)), ("p1000_m2", x8, track(x8, 2), 2, weightings(1000, 8))]
    for deg in range(8):
        n = 6144 // (deg + 1)
        x = torch.arange(n, dtype=torch.float64, device="cuda") - n // 2
        y = 180 + 0.05 * x[:, None] + torch.from_numpy(rng.normal(0, 3, (n, 3))).cuda()
        w = weightings(2, n)
        w[1, ::3] = 0.0
        cases.append((f"deg{deg}_n{n}_48kb", x, y, deg, w))
    y, w = track(x8, 2000), weightings(PSO_POP, 8)
    zeroed, deficient = w.clone(), w.clone()
    zeroed[:, [1, 3]] = 0.0
    deficient[:, 2:] = 0.0
    masked_y = torch.zeros_like(y)
    masked_y[::2] = -0.0
    cases += [("p100_m2000_zero_weights", x8, y, 2, zeroed), ("p100_m2000_rank_deficient", x8, y, 2, deficient),
              ("p100_m2000_all_masked", x8, masked_y, 2, torch.zeros_like(w))]
    for deg, n, m, p in ((2, 20_000, 3, 2), (8, 1_000, 5, 3)):  # the rows recomputed where they are read
        x = torch.arange(n, dtype=torch.float64, device="cuda") - n // 2
        y = 180 + 0.05 * x[:, None] + torch.from_numpy(rng.normal(0, 3, (n, m))).cuda()
        w = weightings(p, n)
        w[-1, ::3] = 0.0
        cases.append((f"deg{deg}_n{n}_rows_recomputed", x, y, deg, w))
    w = weightings(PSO_POP, 8)
    w[1, [1, 3]] = 0.0
    w[2] = 0.0
    w[3, 2:] = 0.0
    for deg in (2, 7, 8):
        y = masked_y.clone()
        y[:, 1:] = track(x8, 1999)
        for workspace in (False, True):
            cases.append((f"deg{deg}_p100_m2000_general_{'workspace' if workspace else 'shared'}", x8, y, deg, w,
                          workspace))
    for deg in (4, 5, 6):  # the wave form below deg 7 at the swarm's batch
        y = masked_y.clone()
        y[:, 1:] = track(x8, 1999)
        cases.append((f"deg{deg}_p100_m2000_wave", x8, y, deg, w))
    for deg in (0, 2, 3):  # and below deg 4, where plan routes it: rows beyond the register form's
        n = KERNEL_REGISTER_ROWS // (8 * (deg + 1)) + 1
        x = torch.arange(n, dtype=torch.float64, device="cuda") - n // 2
        y = 180 + 0.05 * x[:, None] + torch.from_numpy(rng.normal(0, 3, (n, 500))).cuda()
        y[::2, 0] = -0.0
        wn = weightings(4, n)
        wn[1, ::3] = 0.0
        wn[2] = 0.0
        wn[3, 2:] = 0.0
        cases.append((f"deg{deg}_n{n}_m500_wave", x, y, deg, wn))
    x = torch.arange(500, dtype=torch.float64, device="cuda") - 250  # deg 12's rows beyond 48 KB: recomputed
    y = 180 + 0.05 * x[:, None] + torch.from_numpy(rng.normal(0, 3, (500, 4))).cuda()
    cases.append(("deg12_n500_rows_recomputed", x, y, 12, weightings(3, 500)))
    return [case if len(case) == 6 else (*case, None) for case in cases]


def k3_ptxas(report: str) -> list[dict]:
    """Registers, static shared memory and spills of each K3 kernel, from
    ``nvcc -Xptxas -v``'s report of its build: the register form's and the
    wave form's instantiations (``"k"``: K = deg + 1) and the general form
    (``"k"``: None), each with its ``"form"``."""
    found = {}
    for mangled, props in ptxas_kernels(report, "polyfit_").items():
        k = re.search(r"polyfit_(kernel|wave)ILi(\d+)E", mangled)
        if k:
            found["register" if k.group(1) == "kernel" else "wave", int(k.group(2))] = props
        elif "polyfit_general" in mangled:
            found["general", None] = props
    order = {"register": 0, "wave": 1, "general": 2}
    keys = sorted(found, key=lambda key: (order[key[0]], key[1] or 0))
    return [{"form": form, "k": k, **found[form, k]} for form, k in keys]


def parent_polyfit(parent: Path, build_dir: Path):
    """The K3 of the parent commit's tree, unpacked at ``parent`` (``git
    archive``), built with K3's flags and called as its wrapper called it:
    its entry point takes the form (1 the register form, 2 the general
    form), the grid and a workspace, and its grid is this tree's ``plan``
    for the register form and ``plan(..., workspace=False)`` (its general
    form's plan, kept here as it was) for the general form, which it took
    for deg >= 7.  Returns ``fit(x, y, w, deg) -> (P, k, M)``, for timing
    beside this tree's K3 in turns."""
    import ctypes

    from wtracker_tpu_torch.ops import _build
    from wtracker_tpu_torch.ops.polyfit import plan, register_form

    lib = build_dir / "libpolyfit_f64_parent.so"
    cmd = [_build._nvcc(), *_build.flags("polyfit_f64"), "-o", str(lib),
           str(parent / "wtracker_tpu_torch" / "csrc" / "polyfit_f64.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the parent's K3 did not build:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).polyfit_f64
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 6, ctypes.c_double, *[ctypes.c_void_p] * 2]
    fn.restype = ctypes.c_int
    eps = torch.finfo(torch.float64).eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fit(x, y, w, deg=2):
        n, k, rhs = x.shape[0], deg + 1, (y if y.ndim > 1 else y[:, None]).contiguous()
        w2 = w.reshape(-1, n).contiguous()
        out = torch.empty((w2.shape[0], k, rhs.shape[1]), dtype=torch.float64, device=x.device)
        register = register_form(n, k)
        grid = plan(w2.shape[0], n, k, rhs.shape[1], sms, None if register else False)
        assert grid.form == ("register" if register else "general") and not grid.workspace
        err = fn(1 if register else 2, x.data_ptr(), rhs.data_ptr(), w2.data_ptr(), out.data_ptr(), w2.shape[0], n,
                 rhs.shape[1], k, grid.tile, grid.tiles, max((n * eps) ** 2, 16 * eps), None,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise AssertionError(f"the parent's K3 launch failed with CUDA error {err}")
        return out

    return fit


def _k3_shape_times(x, y, w, deg: int, sms: int, plain_reps: int = 50, library: bool = True,
                    plain: bool = True) -> dict:
    """K3 at one shape and degree beside the bound and (``plain``) the
    plain version (``plain_reps`` calls) and (``library``)
    ``torch.linalg.eigh`` of the same normal matrices,
    ``torch.linalg.lstsq`` of the same scaled systems and an empty kernel,
    with its launch plan and, in the wave form, its rotations, steps and
    rows; checked bit for bit first."""
    from wtracker_tpu_torch.ops.polyfit import plan, polyfit, polyfit_reference, polyvander, wave_schedule

    def fit():
        return polyfit(x, y, deg, w)

    got, want = fit(), polyfit_reference(x, y, deg, w)
    if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
        raise AssertionError(f"K3 differs from the plain version at deg {deg}, P {w.reshape(-1, x.shape[0]).shape[0]}")
    k = deg + 1
    lhs = polyvander(x, deg) * w[..., :, None]
    scl = torch.sqrt((lhs * lhs).sum(-2))
    a = lhs / torch.where(scl == 0, 1.0, scl)[..., None, :]
    normal = (a.transpose(-1, -2) @ a).reshape(-1, k, k)
    p = normal.shape[0]
    ops, moved = polyfit_work(p, x.shape[0], k, y.shape[1])
    t_ops, t_bytes = ops / PEAK_F64_OPS_PER_S, moved / PEAK_BYTES_PER_S
    grid = plan(p, x.shape[0], k, y.shape[1], sms)
    out = {
        "p": p, "n": x.shape[0], "deg": deg, "m": y.shape[1],
        "plan": {"form": grid.form, "tile": grid.tile, "tiles": grid.tiles, "blocks": grid.blocks,
                 "per_sm": grid.per_sm, "shared_bytes": grid.shared, "workspace_bytes": grid.workspace,
                 "hold": grid.hold, "sms": sms},
        "ms": time_ms(fit),
        "plain_ms": time_ms(lambda: polyfit_reference(x, y, deg, w), reps=plain_reps) if plain else None,
        "library_ms": time_ms(lambda: torch.linalg.eigh(normal)) if library else None,
        "empty_kernel_ms": time_ms(lambda: torch.cuda._sleep(0)) if library else None,
        "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "operations": ops, "bytes": moved,
    }
    if grid.form == "wave":
        sched = wave_schedule(k)
        out["wave"] = {"rotations": len(sched.rotations), "steps": len(set(sched.scalar_row)), "rows": len(sched.rows)}
    if library:
        rhs = (y if y.ndim > 1 else y[:, None]) * w[..., :, None]
        out["lstsq_ms"] = time_ms(lambda: torch.linalg.lstsq(a, rhs, driver="gels"), reps=LSTSQ_REPS)
    return {**out, "bound_share": out["bound_ms"] / out["ms"]}


def _turns(this, other) -> dict:
    """Medians of ``this`` and ``other`` timed in turns: this, other,
    other, this."""
    turns = {"this": [], "other": []}
    for who in ("this", "other", "other", "this"):
        turns[who].append(time_ms(this if who == "this" else other))
    return turns


def check_polyfit_kernel(fits: list, tmp: Path, old=None) -> dict:
    """Phase 41: K3 against its plain version on the card, 0 differing bits
    (signed zeros included) and one launch a call on the polyfit replay's
    first 20 fits (phase 14's warm-up) and on :func:`_polyfit_cases`; then
    medians of 50 calls (L2 flushed) of K3, the plain version, one batched
    ``torch.linalg.eigh`` of the same normal matrices, one
    ``torch.linalg.lstsq`` (driver ``gels``, CUDA's only one, which takes
    full-rank systems only) of the same scaled systems (both timed only; the
    port calls neither) and an empty kernel, at the replay's shape (one
    weighting of N=5 samples, deg 2, M=2) and the swarm's (WeightEvaluator
    over phase 14's log, P=100 weightings of N=8, deg 2, M its columns),
    beside each shape's bound.  The same at deg 8 (the wave form; the
    plain version over 3 calls) at the replay's shape with the 11
    HIGH_DEG_TIMES (P=1, M=2) and the swarm's (P=100 weightings of them,
    WeightEvaluator's columns at those times), and K3 alone beside its bound
    at deg 3-7 at those two shapes.  With ``old`` (:func:`parent_polyfit`'s
    fit of the parent commit's K3, ``--k3-parent DIR``) the parent's K3 is
    timed with this one in turns (this, parent, parent, this) at deg 2, 7
    and 8, its bits checked against this one's, and deg 3-7 also time
    ``eigh``, ``lstsq`` and the empty kernel."""
    from wtracker_tpu_torch.ops.polyfit import _polyfit_kernel, plan, polyfit, polyfit_reference
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.sim.controllers.polyfit import WeightEvaluator

    x5 = torch.tensor(sorted(REPLAY_POLYFIT_TIMES), dtype=torch.float64, device="cuda")
    x8 = torch.tensor(EVAL_SAMPLE_TIMES, dtype=torch.float64, device="cuda")
    rng = np.random.default_rng(SEED)
    cases = [(f"replay_fit{i}", x, y, 2, w, None) for i, (x, y, w) in enumerate(fits)] + _polyfit_cases(x5, x8, rng)
    differing, compared, max_err, by_form = 0, 0, 0.0, {}
    for name, x, y, deg, w, workspace in cases:
        before = polyfit.launches
        got = polyfit(x, y, deg, w) if workspace is None else _polyfit_kernel(x, y, deg, w, workspace)
        want = polyfit_reference(x, y, deg, w)
        torch.cuda.synchronize()
        if polyfit.launches != before + 1:
            raise AssertionError(f"K3 {name}: {polyfit.launches - before} launches for one call")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"K3 {name}: shape {tuple(got.shape)} against {tuple(want.shape)}, or not finite")
        bad = int((got.view(torch.int64) != want.view(torch.int64)).sum())
        differing, compared = differing + bad, compared + got.numel()
        max_err = max(max_err, float((got - want).abs().max()))
        key = f"forced_general_{'workspace' if workspace else 'shared'}" if workspace is not None else plan(
            w.reshape(-1, x.shape[0]).shape[0], x.shape[0], deg + 1, y.reshape(x.shape[0], -1).shape[1]).form
        by_form[key] = by_form.get(key, 0) + 1
        if bad:
            raise AssertionError(f"K3 {name}: {bad} of {got.numel()} coefficients differ from the plain version "
                                 f"(largest {float((got - want).abs().max())})")
    n_cases = len(cases)
    del cases

    timing = TimingConfig.load_json(str(ROOT / "configs" / "timing_config.json"))
    target = timing.cycle_frame_num + timing.imaging_frame_num // 2
    ev = WeightEvaluator([str(tmp / "worm.csv")], timing, np.array(EVAL_SAMPLE_TIMES), target, device="cpu")
    ev11 = WeightEvaluator([str(tmp / "worm.csv")], timing, np.array(HIGH_DEG_TIMES), target, device="cpu")
    w_pop = torch.from_numpy(rng.uniform(1e-6, 5.0, (PSO_POP, len(EVAL_SAMPLE_TIMES)))).cuda()
    swarm = tuple(torch.from_numpy(np.asarray(a, np.float64)).cuda() for a in (ev.x_input, ev.y_input))
    x11, y11 = (torch.from_numpy(np.asarray(a, np.float64)).cuda() for a in (ev11.x_input, ev11.y_input))
    w11 = torch.from_numpy(rng.uniform(1e-6, 5.0, (PSO_POP, x11.shape[0]))).cuda()
    high = {"replay": (x11, y11[:, :2].contiguous(), torch.ones(x11.shape[0], dtype=torch.float64, device="cuda")),
            "swarm": (x11, y11, w11)}
    shapes = {"replay": fits[-1], "swarm": (*swarm, w_pop)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times, times_deg8, times_deg3_7 = {}, {}, {}

    def against_parent(x, y, w, deg, into):  # the parent's K3, the same bits, in turns with this one
        got = polyfit(x, y, deg, w).reshape(into["p"], deg + 1, -1)
        if not torch.equal(old(x, y, w, deg).view(torch.int64), got.view(torch.int64)):
            raise AssertionError(f"the parent's K3 and this one differ at deg {deg}, P {into['p']}")
        into["turns_ms"] = _turns(lambda: polyfit(x, y, deg, w), lambda: old(x, y, w, deg))

    for shape, (x, y, w) in shapes.items():
        times[shape] = _k3_shape_times(x, y, w, 2, sms)
        if old is not None:
            against_parent(x, y, w, 2, times[shape])
    for shape, (x, y, w) in high.items():
        times_deg8[shape] = _k3_shape_times(x, y, w, HIGH_DEG, sms, plain_reps=3)
        if old is not None:
            against_parent(x, y, w, HIGH_DEG, times_deg8[shape])
        for deg in range(3, 8):
            row = times_deg3_7.setdefault(shape, {})[deg] = _k3_shape_times(x, y, w, deg, sms,
                                                                            library=old is not None, plain=False)
            if deg == 7 and old is not None:
                against_parent(x, y, w, deg, row)
    return {"cases": n_cases, "cases_by_form": by_form, "coefficients_compared": compared, "differing_bits": differing,
            "max_abs_err": max_err, "replay_fits_checked": len(fits), "times": times, "times_deg8": times_deg8,
            "times_deg3_7": times_deg3_7}


def polyfit_high_degree(tmp: Path, timing_path: Path, cpu_replay: subprocess.Popen, old=None) -> dict:
    """Phase 41, the wave form on the main paths: the polyfit replay at
    deg HIGH_DEG over HIGH_DEG_TIMES for the first HIGH_DEG_CYCLES cycles of
    phase 14's log on the card (K3 once a cycle), whose ``bboxes.csv`` text
    must equal the CPU's (``cpu_replay``: :func:`start_cpu_polyfit`'s child
    at that degree, started before the phase's checks), beside the
    ``polyfit_optimizer`` command at ``--degree`` HIGH_DEG on its default
    device, the card, for HIGH_DEG_EPOCHS epochs (K3 once for the baseline,
    once for the first scoring and once an epoch; the written config's
    degree).  With ``old`` (:func:`parent_polyfit`'s fit) the replay then
    runs again, once to warm up and then in turns with the engine's fit
    through this K3 and the parent's (this, parent, parent, this, this,
    parent), each run's text checked and its cycles/s kept."""
    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim.controllers.polyfit import PolyfitConfig

    exp, table, _, build = replay_setup(tmp)
    times = np.array(HIGH_DEG_TIMES, dtype=np.float64)
    args = ["--timing-config", timing_path, "--logs", tmp / "worm.csv", "--output", tmp / "polyfit_deg8.json",
            "--degree", HIGH_DEG, "--pop", PSO_POP, "--epochs", HIGH_DEG_EPOCHS]

    def replay_run():
        params, _ = build("csv", "cuda")
        ctl = te.polyfit_controller(table, params, times, np.ones(len(times)), HIGH_DEG, device="cuda")
        t0 = time.perf_counter()
        logs = te.run_engine(params, ctl, exp.init_position, HIGH_DEG_CYCLES, device="cuda")
        cuda_sync("cuda")
        return params, logs, HIGH_DEG_CYCLES / (time.perf_counter() - t0)

    with ThreadPoolExecutor(1) as pool:
        tuned = pool.submit(run_cli, "polyfit_optimizer", args)
        zero_hand_kernel_launches()
        params, logs, rate = replay_run()
        launches = check_no_hand_kernel(f"the deg {HIGH_DEG} polyfit replay on the card", expect=("polyfit",))
        if launches["polyfit"] != HIGH_DEG_CYCLES:
            raise AssertionError(f"the deg {HIGH_DEG} replay on the card launched K3 {launches['polyfit']} times")
        text = te.logs_to_frame(params, logs).to_csv(index=False)
        cmd_wall, stdout, cmd_launches = tuned.result()
    t0 = time.perf_counter()
    ran, cpu_text = finish_cpu_polyfit(cpu_replay, tmp, high_deg=True)
    waited = time.perf_counter() - t0
    if ran["cycles"] != HIGH_DEG_CYCLES or text != cpu_text:
        raise AssertionError(f"the deg {HIGH_DEG} polyfit replay: the card and the CPU wrote different bboxes.csv text")
    cfg = PolyfitConfig.load_json(str(tmp / "polyfit_deg8.json"))
    if cfg.degree != HIGH_DEG or cmd_launches["polyfit"] != HIGH_DEG_EPOCHS + 2 or not np.isfinite(cfg.weights).all():
        raise AssertionError(f"polyfit_optimizer --degree {HIGH_DEG}: degree {cfg.degree}, K3 {cmd_launches}")
    turns = None
    if old is not None:
        this_fit = te.polyfit

        def parent_fit(x, y, deg, w=None):  # the replay's one weighting
            return old(x, y, w, deg)[0]

        turns = {"this": [], "parent": []}
        try:
            replay_run()  # a warm-up: the first run after the command is the slowest
            for who in ("this", "parent", "parent", "this", "this", "parent"):
                te.polyfit = this_fit if who == "this" else parent_fit
                _, other_logs, other_rate = replay_run()
                if te.logs_to_frame(params, other_logs).to_csv(index=False) != text:
                    raise AssertionError(f"the deg {HIGH_DEG} replay through {who}'s K3 wrote other text")
                turns[who].append(other_rate)
        finally:
            te.polyfit = this_fit
    return {"deg": HIGH_DEG, "sample_times": list(HIGH_DEG_TIMES), "cycles": HIGH_DEG_CYCLES,
            "card_cycles_per_s": rate, "cpu_cycles_per_s": ran["cycles"] / ran["seconds"],
            "cpu_child_waited_s": waited, "text_equal": True, "k3_launches_replay": launches["polyfit"],
            "command_wall_s": cmd_wall, "command_epochs": HIGH_DEG_EPOCHS, "command_k3_launches": cmd_launches["polyfit"],
            "command_mae": re.search(r"MAE uniform (\S+) -> tuned (\S+)", stdout).groups(),
            "turns_cycles_per_s": turns}


def sweep(tmp: Path, device: str = "cuda") -> dict:
    """Phase 15: the ``sweep`` command in mixed-geometry mode over
    configs/exp0-exp4 (their own configs and timings; one seeded worm log
    each, at the experiment's own length), each experiment's ``bboxes.csv``
    equal to its single-stream ``csv_controller`` run; then
    ``csv_controller_streams`` in process at SWEEP_STREAMS streams over
    phase 14's configuration, two streams equal to their single-stream runs,
    and its stream-cycles/s."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine_hetero import bucket_by_cycle_shape

    out = {}
    crop_letterbox_views.launches = 0
    exps, timings, cfgs = exp0_4()
    if bucket_by_cycle_shape(timings) != [list(range(5))]:
        raise AssertionError("exp0-exp4 no longer share one cycle shape")
    tables = [
        worm_csv(tmp / f"sweep_worm{i}.csv", e.num_frames, tuple(e.orig_resolution), SEED + 10 + i)
        for i, e in enumerate(exps)
    ]
    cmd = [
        "wtracker_tpu_torch.workflows.sweep", "--worm-csvs", *[tmp / f"sweep_worm{i}.csv" for i in range(5)],
        "--exp-configs", *[e for e, _ in cfgs], "--timing-configs", *[t for _, t in cfgs], "--output", tmp / "sweep",
        "--device", device,
    ]
    # S streams of phase 14's configuration in one batch, below
    exp = ExperimentConfig.load_json(str(ROOT / "configs" / "exp_config.json"))
    timing = TimingConfig.load_json(str(ROOT / "configs" / "timing_config.json"))
    params = te.EngineParams.from_timing(timing, te.headless_frame_shape(timing, exp.orig_resolution))
    n, streams = params.n_logged_cycles(exp.num_frames), SWEEP_STREAMS
    csvs = np.stack([worm_boxes(exp.num_frames, tuple(exp.orig_resolution), SEED + 100 + s) for s in range(streams)])

    # the single-stream runs (the command's and two of the batch's streams) go beside the command
    with ThreadPoolExecutor(1) as pool:
        swept = pool.submit(run_module, cmd)
        solos = {s: te.run_engine(params, te.csv_controller(csvs[s], params, device=device), exp.init_position, n,
                                  device=device) for s in (0, streams - 1)}
        solo_s, cycles_each, texts = [], [], []
        for e, t, table in zip(exps, timings, tables):
            p = te.EngineParams.from_timing(t, te.headless_frame_shape(t, e.orig_resolution))
            cycles = p.n_logged_cycles(e.num_frames)
            t0 = time.perf_counter()
            logs = te.run_engine(p, te.csv_controller(table, p, device=device), e.init_position, cycles, device=device)
            cuda_sync(device)
            solo_s.append(time.perf_counter() - t0)
            cycles_each.append(cycles)
            texts.append(te.logs_to_frame(p, logs).to_csv(index=False))
        out["cli_mixed_wall_s"], proc = swept.result()
    if proc.returncode != 0:
        raise AssertionError(f"sweep exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    out["cli_stdout"] = proc.stdout.strip().splitlines()
    for i, text in enumerate(texts):
        if (tmp / "sweep" / f"exp{i}" / "bboxes.csv").read_text() != text:
            raise AssertionError(f"the sweep's exp{i} differs from its single-stream run")
    out.update(mixed_cycles=cycles_each, mixed_equal_to_solo=True, solo_run_s=solo_s)

    init = np.tile(exp.init_position, (streams, 1))
    ctl = te.csv_controller_streams(csvs, params, device=device)
    te.run_engine_streams(params, ctl, init, 20, batched_controller=True, device=device)  # warm-up
    t0 = time.perf_counter()
    logs = te.run_engine_streams(params, ctl, init, n, batched_controller=True, device=device)
    cuda_sync(device)
    wall = time.perf_counter() - t0
    for s, solo in solos.items():
        same_boxes = torch.equal(solo.worm_bboxes.nan_to_num(-1.0), logs.worm_bboxes[:, s].nan_to_num(-1.0))
        if not (torch.equal(solo.positions, logs.positions[:, s]) and same_boxes):
            raise AssertionError(f"stream {s} of the batch differs from its single-stream run")
    if crop_letterbox_views.launches != 0:
        raise AssertionError("the sweeps launched K1")
    out.update(
        streams=streams, stream_cycles=n, streams_run_s=wall, stream_cycles_per_s=streams * n / wall,
        streams_equal_to_solo=[0, streams - 1], crop_letterbox_launches=crop_letterbox_views.launches,
    )
    return out


def hetero_live(models: dict, predictor, device: str = "cuda", per_geometry: int = HETERO_PER_GEOMETRY,
                cycles: int = HETERO_CYCLES, timed_runs: int = HETERO_TIMED_RUNS) -> tuple[dict, callable]:
    """Phase 16: ``yolo_mlp_controller_hetero`` over exp0-exp4's geometries
    (352, 360 and 368 px cameras), ``per_geometry`` streams of each
    experiment, 400-frame tracks, ``cycles`` cycles: steps/s of the bf16
    loop (median of ``timed_runs`` after a warm-up), 0 K1 launches, every
    stream held to the tracking bar; in float32 the mixed run against each
    camera size's streams run alone on the same canvas (positions within
    2 px in >= 99.5 % of frames, boxes within 1e-3 px in >= 99.5 % of
    rows)."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_hetero import StreamGeometry, geometry_from_configs, yolo_mlp_controller_hetero
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory
    from wtracker_tpu_torch.tools.gates import tracking_quality as closed_loop_quality

    exps, timings, _ = exp0_4()
    params, g5 = geometry_from_configs(timings, exps)
    sel = np.repeat(np.arange(5), per_geometry)
    geometry = StreamGeometry(*(a[sel] for a in g5))
    S = len(sel)
    trajs = np.stack([make_trajectory(400, tuple(geometry.bounds[i][::-1]), seed=SEED + i) for i in range(S)])
    init = np.round(trajs[:, 0]).astype(np.int64)
    canvas = (int(geometry.cam_size[:, 1].max()), int(geometry.cam_size[:, 0].max()))
    cfg = LiveLoopConfig(conf=0.1, ring_size=64, log_mode=True, detect_chunks=1)
    scene = SyntheticScene()

    def run(model, rows=None, n_cycles=cycles):
        rows = np.arange(S) if rows is None else rows
        sub = StreamGeometry(*(a[rows] for a in geometry))
        ctl = yolo_mlp_controller_hetero(
            params, sub, cfg, scene, trajs[rows], model, predictor, canvas_hw=canvas, device=device
        )
        t0 = time.perf_counter()
        logs = run_engine_streams(params, ctl, init[rows], n_cycles, batched_controller=True, device=device)
        cuda_sync(device)
        return logs, time.perf_counter() - t0

    crop_letterbox_views.launches = 0
    with k4_per_forward("the mixed-geometry loop's warm-up", need=("standard",)) as k4:
        logs, warm_s = run(models["bf16"])
    secs = [run(models["bf16"])[1] for _ in range(timed_runs)]
    launches = crop_letterbox_views.launches
    if launches != 0:
        raise AssertionError(f"the mixed-geometry loop launched K1 {launches} times")
    if logs.positions.shape != (cycles, S, params.cycle_n, 2):
        raise AssertionError(f"hetero log shape {tuple(logs.positions.shape)}")
    per_stream = []
    for s in range(S):
        one = type(logs)(logs.positions[:, s : s + 1], logs.worm_bboxes[:, s : s + 1])
        q = closed_loop_quality(params, one, trajs[s : s + 1])
        if not (q["detection_rate"] >= 0.95 and q["median_center_err_px"] <= 4.0):
            raise AssertionError(f"stream {s} (camera {tuple(geometry.cam_size[s])}) lost the worm: {q}")
        per_stream.append(q)

    # float32: the mixed run against each camera size's streams alone
    mixed, _ = run(models["f32"])
    groups = {}
    for w, h in sorted({tuple(c) for c in geometry.cam_size.tolist()}):
        rows = np.flatnonzero((geometry.cam_size == (w, h)).all(axis=1))
        alone, _ = run(models["f32"], rows)
        p_m = mixed.positions[:, rows].cpu().numpy().reshape(-1, 2)
        p_a = alone.positions.cpu().numpy().reshape(-1, 2)
        b_m = mixed.worm_bboxes[:, rows].cpu().numpy().reshape(-1, 4)
        b_a = alone.worm_bboxes.cpu().numpy().reshape(-1, 4)
        pos_share = float((np.abs(p_m - p_a) <= 2).all(axis=1).mean())
        box_share = float(np.isclose(b_m, b_a, atol=1e-3, equal_nan=True).all(axis=1).mean())
        groups[f"{w}x{h}"] = {"streams": len(rows), "pos_within_2px_share": pos_share, "box_within_1e-3_share": box_share}
        if not (pos_share >= 0.995 and box_share >= 0.995):
            raise AssertionError(f"float32 mixed run differs from the {w}x{h} streams alone: {groups[f'{w}x{h}']}")

    wall = float(np.median(secs))
    out = {
        "streams": S,
        "cameras_px": sorted({int(c) for c in geometry.cam_size[:, 0]}),
        "cycles": cycles,
        "imaging_views_per_decision": S * params.imaging_n,
        "steps_per_s": S * cycles * params.cycle_n / wall,
        "cycles_per_s": cycles / wall,
        "warmup_s": warm_s,
        "run_s": secs,
        "crop_letterbox_launches": launches,
        "warmup_k4": k4,
        "worst_stream_detection_rate": min(q["detection_rate"] for q in per_stream),
        "worst_stream_median_center_err_px": max(q["median_center_err_px"] for q in per_stream),
        "f32_mixed_vs_alone": groups,
    }
    return out, lambda: run(models["bf16"])[1]


# ---------------------------------------------------------------------------
# the int8 serving form: quantize command, K2, int8 loops, drift, int8 CLI
# ---------------------------------------------------------------------------


def quantize_cli(tmp: Path, timing_config: Path) -> tuple[dict, Path]:
    """Phase 17: ``python -m wtracker_tpu_torch.workflows.quantize_detector``
    on phase 12's BMPs (initial camera window), INT8_CALIB_VIEWS views."""
    out = tmp / "det_int8.npz"
    cmd = [
        sys.executable, "-m", "wtracker_tpu_torch.workflows.quantize_detector", "--detector", str(CHECKPOINT),
        "--frames", str(tmp / "frames"), "--timing-config", str(timing_config), "--exp-config", str(tmp / "exp.json"),
        "--calib-frames", str(INT8_CALIB_VIEWS), "--output", str(out), "--device", "cuda",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"quantize_detector exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return {"wall_s": wall, "calib_views": INT8_CALIB_VIEWS, "stdout": proc.stdout.strip().splitlines()}, out


def conv_s8_work(x_shape, w_shape, stride: int, out_bytes: int) -> dict:
    """One K2 call's work and least time: int8 tensor-core operations (2 per
    multiply-add) against the bytes (input, weights, scales and bias read
    once, output written once); the bound is the larger time."""
    n, h, w, cin = x_shape
    k, _, _, cout = w_shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    m = n * ho * wo
    ops = 2 * m * cout * k * k * cin
    moved = n * h * w * cin + k * k * cin * cout + 8 * cout + m * cout * out_bytes
    t_ops, t_bytes = ops / PEAK_INT8_OPS_PER_S, moved / PEAK_BYTES_PER_S
    return {
        "m": m, "ops": ops, "bytes": moved, "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def tensor_core_sass(lib: Path) -> dict:
    """Counts of the tensor-core (and __dp4a) instructions that ``cuobjdump
    -sass`` finds in a built kernel library: ``IGMMA`` is wgmma on int8
    (``HGMMA`` its float form: ``ptxas`` adds a predicated-off one to commit
    a guarded product), ``IMMA`` mma.sync on int8, ``IDP4A`` the CUDA cores'
    4-way dot product."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, timeout=300, check=True).stdout
    ops = []
    for line in sass.splitlines():  # "/*0a70*/  [@P0] IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], ... ;"
        toks = line.split()
        if len(toks) > 1 and toks[0].startswith("/*") and toks[0].endswith("*/") and len(toks[0]) > 4:
            toks = toks[2:] if toks[1].startswith("@") else toks[1:]
            if toks:
                ops.append(toks[0].split(".")[0])
    return {op: ops.count(op) for op in ("IGMMA", "HGMMA", "IMMA", "HMMA", "IDP4A")}


def k2_design() -> dict:
    """K2's design, from the wrapper's mirror of the kernel's constants."""
    from wtracker_tpu_torch.ops import conv_s8 as k2

    return {
        "product": "wgmma.mma_async m64nNk32 .s32.s8.s8, A and B K-major in shared memory",
        "tile": [k2.TILE_H, k2.TILE_W], "block_cols": list(k2.BLOCK_COLS),
        "stages": k2.STAGES, "stage_bytes": k2.BK,
        "loads": "TMA boxes (32-byte swizzle) on an mbarrier a stage; a byte gather where Cin % 32 or the alignment forbid",
        "split_k": f"up to {k2.MAX_SPLIT} blocks of one cluster, partial sums added through distributed shared memory",
    }


CONV_CLASSES = ("3x3_s1", "3x3_s2", "1x1_silu", "head_logits")


def conv_class(row: dict) -> str:
    """K2's shape classes: the 3x3 convolutions at stride 1 and 2, the 1x1
    SiLU convolutions, and the heads' 1x1 logits."""
    if row["epilogue"] == "logits":
        return "head_logits"
    if row["w"][0] == 1:
        return "1x1_silu"
    return f"3x3_s{row['stride']}"


def class_sums(shapes: list) -> dict:
    """Per class: convolutions a forward, and the forward's sums of kernel
    ms, bound ms, library ms where there is one, with the bound share."""
    out = {}
    for cls in CONV_CLASSES:
        rows = [r for r in shapes if conv_class(r) == cls]
        ms = float(sum(r["ms"] * r["count"] for r in rows))
        bound = float(sum(r["bound_ms"] * r["count"] for r in rows))
        lib = [r for r in rows if r["library_ms"] is not None]
        out[cls] = {
            "convs": sum(r["count"] for r in rows), "ms": ms, "bound_ms": bound, "bound_share": bound / ms if ms else None,
            "split_convs": sum(r["count"] for r in rows if r["plan"]["split"] > 1),
            "library_ms": float(sum(r["library_ms"] * r["count"] for r in lib)) if lib else None,
            "kernel_ms_where_library": float(sum(r["ms"] * r["count"] for r in lib)) if lib else None,
        }
    return out


@contextlib.contextmanager
def recorded_convs():
    """Within the block, every int8 forward (``QuantizedYolo.apply`` and
    ``apply_folded``, so every detect hook over them) records its K2
    convolutions as it runs them: yields ``(classes, names)``, ``classes``
    keyed by distinct call shape ``(x, w, stride, epilogue)`` with the first
    such call's input, node, stride, epilogue and output scale and the layers
    of that shape; ``names`` every recorded convolution in order."""
    from wtracker_tpu_torch.models import yolov8_int8 as ti

    classes, names = {}, []

    class Recording(ti._ApplyOps):
        def _record(self, name, x, stride, epi, s_out):
            node = self.qw[name]
            key = (tuple(x.data.shape), tuple(node["w"].shape), stride, epi)
            classes.setdefault(key, {"layers": [], "args": (x.data, node, stride, epi, s_out)})["layers"].append(name)
            names.append(name)

        def convbn(self, name, x, stride=1):
            self._record(name, x, stride, "silu_q", self._scale_of(name))
            return super().convbn(name, x, stride)

        def plain_conv(self, name, x):
            self._record(name, x, 1, "logits", None)
            return super().plain_conv(name, x)

    apply_ops = ti.QuantizedYolo._apply_ops
    ti.QuantizedYolo._apply_ops = lambda self, qw: Recording(qw, self.absmax)
    try:
        yield classes, names
    finally:
        ti.QuantizedYolo._apply_ops = apply_ops


def compare_conv_classes(classes: dict, kernel_reps: int, plain_reps: int) -> dict:
    """K2 against its plain version at each recorded shape class (see
    :func:`recorded_convs`), with the class's own input, weights and scales,
    in all three epilogues: ``acc`` and ``logits`` bit-identical, ``silu_q``
    identical or off by 1 (counted).  Then each class timed with the L2
    flushed: the kernel, the plain version (when ``plain_reps``),
    ``torch._int_mm`` for 1x1 stride-1 shapes (the product alone: no
    epilogue), and the bound."""
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_reference, plan

    shapes, mismatched, checked, max_err = [], 0, 0, 0.0
    for (x_shape, w_shape, stride, epi), c in classes.items():
        xin, node, _, _, s_out = c["args"]
        s_q = s_out if s_out is not None else 0.05
        p = plan(*x_shape, w_shape[3], w_shape[0], stride)
        row = {"x": list(x_shape), "w": list(w_shape), "stride": stride, "epilogue": epi, "count": len(c["layers"]),
               "first_layer": c["layers"][0], "plan": {"tiles": p.tiles, "bn": p.bn, "split": p.split}}
        for e in ("acc", "logits", "silu_q"):
            got = conv_s8(xin, node["w"], stride, e, node["sw"], node["b"], s_q, wp=node["wp"])
            torch.cuda.synchronize()
            want = conv_s8_reference(xin, node["w"], stride, e, node["sw"], node["b"], s_q)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"K2 {row}: {e} output {tuple(got.shape)} {got.dtype}")
            diff = (got.float() - want.float()).abs()
            max_err = max(max_err, diff.max().item())
            if e == "silu_q":
                if not diff.max().item() <= 1:
                    raise AssertionError(f"K2 {row}: silu_q differs by {diff.max().item()}")
                row["silu_q_off_by_one"] = int((diff > 0).sum().item())
                mismatched += row["silu_q_off_by_one"]
                checked += diff.numel()
            elif not torch.equal(got, want):
                raise AssertionError(f"K2 {row}: {e} differs from the plain version by {diff.max().item()}")
            del got, want, diff
        kernel = lambda a=c["args"]: conv_s8(a[0], a[1]["w"], a[2], a[3], a[1]["sw"], a[1]["b"], a[4], wp=a[1]["wp"])
        plain = lambda a=c["args"]: conv_s8_reference(a[0], a[1]["w"], a[2], a[3], a[1]["sw"], a[1]["b"], a[4])
        row["ms"] = time_ms(kernel, reps=kernel_reps)
        row["plain_ms"] = time_ms(plain, reps=plain_reps) if plain_reps else None
        row["library_ms"] = None
        if w_shape[0] == 1 and stride == 1:
            a2 = xin.contiguous().reshape(-1, x_shape[-1])
            b2 = node["w"].reshape(w_shape[2], w_shape[3])
            try:
                acc = conv_s8(xin, node["w"], 1, "acc", wp=node["wp"]).reshape(a2.shape[0], -1)
                if not torch.equal(torch._int_mm(a2, b2), acc):
                    raise AssertionError(f"torch._int_mm differs from K2's accumulators at {row}")
                row["library_ms"] = time_ms(lambda: torch._int_mm(a2, b2), reps=kernel_reps)
            except RuntimeError as err:  # shapes _int_mm does not take (Cout = 1)
                row["library_error"] = str(err).splitlines()[0][:120]
        out_bytes = {"acc": 4, "logits": 2, "silu_q": 1}[epi]
        row.update(conv_s8_work(x_shape, w_shape, stride, out_bytes))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        shapes.append(row)
    torch.cuda.empty_cache()
    return {
        "distinct_shapes": len(shapes), "silu_q_off_by_one": mismatched, "silu_q_checked": checked,
        "max_abs_err": max_err, "shapes": shapes,
    }


def check_conv_s8(q, qw, recording, cam: int, imgsz: int, n: int) -> dict:
    """Phase 18: K2 against its plain version on the card at every distinct
    convolution of one int8 forward at N views (the unfolded forward, on
    letterboxed views of the recording: :func:`compare_conv_classes`), each
    shape timed, and the whole int8 forward timed."""
    from wtracker_tpu_torch.models.yolov8 import preprocess_batch

    frames = np.linspace(0, len(recording.traj) - 1, n).round().astype(int)
    views = torch.from_numpy(np.stack([recording.view(f, cam) for f in frames])).cuda()
    x, _ = preprocess_batch(views, (imgsz, imgsz), dtype=torch.bfloat16)
    with torch.inference_mode():
        with recorded_convs() as (classes, names):
            q.apply(qw, x)
        torch.cuda.synchronize()
        checked = compare_conv_classes(classes, kernel_reps=20, plain_reps=10)
        forward_ms = time_ms(lambda: q.apply(qw, x), reps=10, flush_bytes=0)
    shapes = checked["shapes"]

    def total(k):
        return float(sum(r[k] * r["count"] for r in shapes))

    return {
        "views": n,
        "convs_per_forward": len(names),
        **{k: checked[k] for k in ("distinct_shapes", "silu_q_off_by_one", "silu_q_checked", "max_abs_err")},
        "forward_sum_ms": total("ms"),
        "forward_sum_plain_ms": total("plain_ms"),
        "forward_sum_bound_ms": total("bound_ms"),
        "forward_ops": total("ops"),
        "forward_bytes": total("bytes"),
        "forward_ops_bound_ms": total("ops") / PEAK_INT8_OPS_PER_S * 1e3,
        "forward_bytes_bound_ms": total("bytes") / PEAK_BYTES_PER_S * 1e3,
        "int8_forward_ms": forward_ms,
        "library_1x1_sum_ms": float(sum(r["library_ms"] * r["count"] for r in shapes if r["library_ms"] is not None)),
        "kernel_1x1_sum_ms": float(sum(r["ms"] * r["count"] for r in shapes if r["library_ms"] is not None)),
        "classes": class_sums(shapes),
        "shapes": shapes,
    }


def int8_video_loops(params, base, recording, num_frames, q, qw, predictor, cam: int, imgsz: int) -> tuple[dict, dict]:
    """Phase 19: the video loop with the int8 detector over the recording,
    both routes: folded (the track_video command's: 0 K1 launches, 62 K2 a
    forward, 2 forwards a cycle) and unfolded through K1 (2 K1 launches a
    cycle, 63 K2 a forward); each held to the tracking bar; cycles/s of each
    (a warm-up run, then a timed one).  Returns the phase's numbers and the
    two loops for --profile."""
    from wtracker_tpu_torch.models.yolov8_int8 import Int8Detector, make_detect_fns
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig

    n_cycles = params.n_logged_cycles(num_frames)
    det = Int8Detector(q, qw)
    routes = {
        "folded": (make_detect_fns(q, src_hw=(cam, cam), imgsz=(imgsz, imgsz), qw=qw), 0, 62),
        "unfolded_k1": (make_detect_fns(q, qw=qw), 2, 63),
    }
    cfg = LiveLoopConfig(**base, use_fused_preproc=True)
    out, runs, logs_by = {}, {}, {}
    for name, ((detect, detect_pre), k1_per_cycle, k2_per_forward) in routes.items():
        kw = dict(detect_fn=detect, detect_preprocessed_fn=detect_pre)
        runs[name] = lambda kw=kw: run_loop(params, cfg, recording, num_frames, det, predictor, "cuda", **kw)[1]
        warm = runs[name]()
        crop_letterbox_views.launches = conv_s8.launches = bias_silu_.launches = 0
        logs, secs = run_loop(params, cfg, recording, num_frames, det, predictor, "cuda", **kw)
        k1, k2, k4 = crop_letterbox_views.launches, conv_s8.launches, bias_silu_.launches
        if k1 != k1_per_cycle * n_cycles or k2 != k2_per_forward * 2 * n_cycles or k4:
            raise AssertionError(f"int8 {name} loop: K1 {k1}, K2 {k2}, K4 {k4} launches in {n_cycles} cycles")
        quality = tracking_quality(params, logs, recording)
        check_tracking(quality, cam)
        logs_by[name] = logs
        out[name] = {
            "crop_letterbox_launches": k1, "conv_s8_launches": k2, "conv_s8_launches_per_cycle": k2 / n_cycles,
            "cycles_per_s": n_cycles / secs, "run_s": [warm, secs], **quality,
        }
        log(f"int8 video loop {name}: {out[name]}")
    pos, box = log_diffs(logs_by["folded"], logs_by["unfolded_k1"])
    out.update(cycles=n_cycles, folded_vs_unfolded_pos_max_abs_diff=pos, folded_vs_unfolded_box_max_abs_diff=box)
    return out, runs


def int8_drift(model, q, qw, recording, cam: int, imgsz: int) -> dict:
    """Phase 20: top-1 centre drift of the int8 folded detector against the
    bf16 folded detector on DRIFT_VIEWS views of frames the calibration never
    saw (after the first CLI_FRAMES), centred on the worm, conf 0: median
    <= 1 px and >= 75 % within 8 px (tests/test_yolov8_int8.py's clauses)."""
    from wtracker_tpu_torch.models.yolov8 import make_folded_detect
    from wtracker_tpu_torch.models.yolov8_int8 import make_detect_fns

    size = (imgsz, imgsz)
    frames = np.linspace(CLI_FRAMES, len(recording.traj) - 1, DRIFT_VIEWS).round().astype(int)
    views = torch.from_numpy(np.stack([recording.view(f, cam) for f in frames])).cuda()
    detect_int8, _ = make_detect_fns(q, src_hw=(cam, cam), imgsz=size, qw=qw)
    detect_bf16 = make_folded_detect(model, (cam, cam), size)
    with torch.inference_mode():
        got = detect_int8(None, views, size, 0.0).cpu().numpy()
        ref = detect_bf16(model, views, size, 0.0).cpu().numpy()
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise AssertionError("a detector gave no box at conf 0 in the drift check")
    drift = np.hypot(*((ref[:, :2] + ref[:, 2:] / 2) - (got[:, :2] + got[:, 2:] / 2)).T)
    out = {
        "views": len(frames), "median_drift_px": float(np.median(drift)), "within_8px_share": float((drift < 8.0).mean()),
        "max_drift_px": float(drift.max()), "iou_median": float(np.median(iou(ref, got))),
    }
    if not (out["median_drift_px"] <= 1.0 and out["within_8px_share"] >= 0.75):
        raise AssertionError(f"int8 drifts from bf16: {out}")
    return out


def int8_synthetic(q, qw, predictor, bf16_steps_per_s: float) -> tuple[dict, callable, dict]:
    """Phase 21: the synthetic loop of phase 9 (S=96, 4 sub-batches of 360
    views, 12 cycles) with the int8 folded detect: steps/s (a warm-up, then
    INT8_SYNTH_TIMED_RUNS runs) beside phase 9's bf16 steps/s of this call,
    0 K1 launches and 62 K2 launches a forward, held to the same bar.  The
    warm-up's convolutions are recorded, and K2 is held to its plain version
    at every shape of a 360-view forward (:func:`compare_conv_classes`; the
    kernel timed, not the plain version): returned third."""
    from wtracker_tpu_torch.models.yolov8_int8 import Int8Detector, make_detect_fns
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory
    from wtracker_tpu_torch.tools.gates import tracking_quality as closed_loop_quality

    params = bench_params()
    S = SYNTH_STREAMS
    trajs = np.stack([make_trajectory(400, (1400, 1600), seed=i) for i in range(S)])
    init = np.tile([700, 700], (S, 1))
    cfg = LiveLoopConfig(
        imgsz=(416, 416), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0, detect_chunks=SYNTH_CHUNKS
    )
    detect, _ = make_detect_fns(q, src_hw=(params.cam_h, params.cam_w), imgsz=(416, 416), qw=qw)
    ctl = make_stream_batch_fused(params, cfg, SyntheticScene(), trajs, Int8Detector(q, qw), predictor, detect_fn=detect, device="cuda")

    def run():
        t0 = time.perf_counter()
        logs = run_engine_streams(params, ctl, init, SYNTH_CYCLES, delayed_log=True, device="cuda")
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    # the warm-up run records every convolution its forwards make; K2 is
    # then held to its plain version at each shape of its first forward
    with recorded_convs() as (classes, names):
        logs, warm_s = run()
    views = S * params.cycle_n // SYNTH_CHUNKS
    if {k[0][0] for k in classes} != {views}:
        raise AssertionError(f"the int8 synthetic loop's convolutions saw batches of {sorted({k[0][0] for k in classes})}")
    with torch.inference_mode():
        check = compare_conv_classes(classes, kernel_reps=5, plain_reps=0)
    del classes
    # run_engine_streams(delayed_log=True) steps one cycle more than it logs;
    # each step detects its S x cycle_n views in SYNTH_CHUNKS forwards of 62
    forwards = SYNTH_CHUNKS * (SYNTH_CYCLES + 1)
    if len(names) != 62 * forwards:
        raise AssertionError(f"the int8 synthetic warm-up ran {len(names)} convolutions, expected 62 x {forwards}")
    crop_letterbox_views.launches = conv_s8.launches = bias_silu_.launches = 0
    secs = [run()[1] for _ in range(INT8_SYNTH_TIMED_RUNS)]
    k1, k2, k4 = crop_letterbox_views.launches, conv_s8.launches, bias_silu_.launches
    if k1 != 0 or k2 != 62 * forwards * INT8_SYNTH_TIMED_RUNS or k4:
        raise AssertionError(f"the int8 synthetic loop launched K1 {k1}, K2 {k2} and K4 {k4} times in "
                             f"{INT8_SYNTH_TIMED_RUNS} runs")
    quality = closed_loop_quality(params, logs, trajs)
    if not (quality["detection_rate"] >= 0.95 and quality["median_center_err_px"] <= 4.0):
        raise AssertionError(f"the int8 synthetic loop lost the worm: {quality}")
    if not quality["in_camera_share_after_cycle_3"] >= 0.95:
        raise AssertionError(f"the worm left the camera in the int8 synthetic loop: {quality}")
    wall = float(np.median(secs))
    steps = S * SYNTH_CYCLES * params.cycle_n / wall
    shapes = check["shapes"]
    for r in shapes:  # counted over the warm-up's forwards: a forward's count
        r["count"] //= forwards
    check.update(
        views=views, convs_per_forward=len(names) // forwards,
        largest_m_shapes=sorted(shapes, key=lambda r: -r["m"])[:3],
        forward_sum_ms=float(sum(r["ms"] * r["count"] for r in shapes)),
        forward_sum_bound_ms=float(sum(r["bound_ms"] * r["count"] for r in shapes)),
        classes=class_sums(shapes),
    )
    return {
        "streams": S, "cycles": SYNTH_CYCLES, "steps_per_s": steps, "bf16_steps_per_s": bf16_steps_per_s,
        "int8_over_bf16": steps / bf16_steps_per_s, "warmup_s": warm_s, "run_s": secs,
        "crop_letterbox_launches": k1, "conv_s8_launches_per_run": k2 / INT8_SYNTH_TIMED_RUNS, **quality,
    }, lambda: run()[1], check


def int8_track_video_cli(params, recording, cam: int, tmp: Path, artifact: Path, timing_config: Path) -> dict:
    """Phase 22: ``python -m wtracker_tpu_torch.workflows.track_video`` with
    the int8 artifact on phase 12's BMPs: a 17-column ``bboxes.csv`` of every
    logged cycle, held to the tracking bar."""
    wall, proc = run_module([
        "wtracker_tpu_torch.workflows.track_video", "--frames", tmp / "frames", "--timing-config", timing_config,
        "--exp-config", tmp / "exp.json", "--detector", artifact, "--output", tmp / "int8", "--device", "cuda",
    ], timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"track_video with the int8 artifact exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    logs = logs_from_csv(tmp / "int8" / "bboxes.csv", params.cycle_n)
    if logs.positions.shape[0] != params.n_logged_cycles(CLI_FRAMES):
        raise AssertionError(f"the int8 bboxes.csv holds {logs.positions.shape[0]} cycles")
    quality = tracking_quality(params, logs, recording)
    check_tracking(quality, cam)
    return {"wall_s": wall, "stdout": proc.stdout.strip().splitlines(), **quality}



# ---------------------------------------------------------------------------
# the host simulator backend and .pt detectors
# ---------------------------------------------------------------------------

HOST_CONTROLLERS = ("csv", "optimal", "polyfit", "mlp")
HOST_YOLO_RUNS = 3  # phase 24: timed runs over the recording after one warm-up run
# the polyfit_optimizer command's default sample times, for WeightEvaluator
EVAL_SAMPLE_TIMES = (-30, -25, -20, -15, -10, -5, 0, 3)


def host_replay(tmp: Path) -> dict:
    """Phase 23: ``python -m wtracker_tpu_torch.workflows.simulate --backend
    host`` at phase 14's configuration on its whole worm log, with the csv,
    optimal, polyfit (the command's default, degree 2 at [-15, -10, -5, 0,
    3]) and mlp (phase 14's predictor, on the card) controllers, the four
    commands at once (their start-ups overlap; each loop's cycles/s is taken
    beside the others').  Each ``bboxes.csv`` (``\\r\\n`` line ends, the csv
    module's) must be phase 14's engine text row for row; for mlp the rows
    that differ are counted and held to phase 14's card-against-CPU bar."""
    exp_path, timing_path = ROOT / "configs" / "exp_config.json", ROOT / "configs" / "timing_config.json"

    def command(name: str):
        cmd = [
            sys.executable, "-m", "wtracker_tpu_torch.workflows.simulate", "--backend", "host",
            "--timing-config", str(timing_path), "--worm-csv", str(tmp / "worm.csv"),
            "--exp-config", str(exp_path),
            "--output", str(tmp / f"host_{name}"), "--controller", name, "--device", "cuda",
            *(["--predictor", str(tmp / "predictor.npz")] if name == "mlp" else []),
        ]
        started = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                              capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - started

    with ThreadPoolExecutor(len(HOST_CONTROLLERS)) as pool:
        runs = list(pool.map(command, HOST_CONTROLLERS))
    out = {"controllers": {}, "concurrent_commands": len(HOST_CONTROLLERS)}
    for name, (proc, wall) in zip(HOST_CONTROLLERS, runs):
        if proc.returncode != 0:
            raise AssertionError(f"simulate --backend host {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        stdout = proc.stdout.strip().splitlines()
        m = re.search(r"\((\d+) cycles, ([\d.]+) s in the simulator loop\)", stdout[-1])
        if m is None:
            raise AssertionError(f"simulate --backend host {name} printed {stdout}")
        cycles, loop_s = int(m.group(1)), float(m.group(2))
        raw = (tmp / f"host_{name}" / "bboxes.csv").read_bytes()
        host = raw.decode().replace("\r\n", "\n").splitlines()
        engine = (tmp / f"engine_{name}.csv").read_text().splitlines()
        if len(host) != len(engine) or host[0] != engine[0]:
            raise AssertionError(f"host {name}: {len(host)} lines against the engine's {len(engine)}")
        differing = [i for i, (a, b) in enumerate(zip(host, engine)) if a != b]
        row = {
            "wall_s": wall, "loop_s": loop_s, "cycles": cycles, "cycles_per_s_loop": cycles / loop_s,
            "cycles_per_s_command": cycles / wall, "crlf_line_ends": raw.count(b"\r\n") == len(host),
            "rows_differing_from_engine": len(differing), "stdout": stdout,
        }
        if differing:
            if name != "mlp":
                raise AssertionError(f"host {name} differs from phase 14's engine text at row {differing[0]}:\n"
                                     f"{host[differing[0]]}\n{engine[differing[0]]}")
            pos = np.array([[float(v) for v in host[i].split(",")[3:5]] + [float(v) for v in engine[i].split(",")[3:5]]
                            for i in differing])
            gap = np.abs(pos[:, :2] - pos[:, 2:]).max()
            row.update(first_differing_row=differing[0], max_abs_pos_diff_px=float(gap))
            if not (len(differing) <= 0.001 * (len(host) - 1) and gap <= 2):
                raise AssertionError(f"host mlp drifts from the engine's: {row}")
        out["controllers"][name] = row
        log(f"simulate --backend host {name}: {wall:.1f} s, loop {cycles / loop_s:.0f} cycles/s, "
            f"{len(differing)} rows differ from the engine")
    return out


def host_yolo_loop(params, recording, bmp: Path, timing_path: Path) -> dict:
    """Phase 24: the live host loop, ``Simulator`` with
    ``LoggingController(YoloController)`` over phase 12's BMPs read by the
    port's ``FrameReader``, the trained YOLOv8s@416 (``.npz``, float32) on
    the card: the decisions' detection rate, the tracking bar against the
    rendered track and 0 launches of every hand kernel on every run, and
    cycles/s over ``HOST_YOLO_RUNS`` timed runs after a warm-up run."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.controllers import LogConfig, LoggingController, YoloConfig, YoloController
    from wtracker_tpu_torch.sim.simulator import Simulator
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    class Counted(YoloController):
        decisions = detected = 0

        def predict(self, frames):
            boxes = super().predict(frames)
            if len(frames) == 1:  # the decision's own detection
                Counted.decisions += 1
                Counted.detected += int(np.isfinite(boxes).all())
            return boxes

    timing = TimingConfig.load_json(str(timing_path))
    exp = ExperimentConfig.load_json(str(bmp / "exp.json"))
    cfg = YoloConfig(model_path=str(CHECKPOINT), device="cuda", pred_kwargs={"imgsz": 416, "conf": 0.1})
    ctl = Counted(timing, cfg)
    runs = []
    for i in range(1 + HOST_YOLO_RUNS):  # run 0 is the warm-up (cuDNN's set-up, first BMP reads)
        Counted.decisions = Counted.detected = 0
        reader = FrameReader.create_from_directory(str(bmp / "frames"))
        out_dir = bmp / f"host_yolo_{i}"
        zero_hand_kernel_launches()
        t0 = time.perf_counter()
        Simulator(timing, exp, LoggingController(ctl, LogConfig(root_folder=str(out_dir), save_err_view=False)),
                  reader=reader).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = hand_kernel_launches()
        if any(launches.values()):
            raise AssertionError(f"the host YOLO loop launched a hand kernel: {launches}")
        logs = logs_from_csv(out_dir / "bboxes.csv", params.cycle_n)
        n = params.n_logged_cycles(len(reader))
        if logs.positions.shape[0] != n:
            raise AssertionError(f"the host YOLO log holds {logs.positions.shape[0]} cycles, expected {n}")
        rate = Counted.detected / max(Counted.decisions, 1)
        quality = tracking_quality(params, logs, recording)
        if not rate >= 0.95:
            raise AssertionError(f"the host YOLO loop detected the worm in {rate:.3f} of its decisions")
        check_tracking(quality, params.cam_w)
        runs.append({"wall_s": wall, "cycles_per_s": n / wall})
    timed = [r["cycles_per_s"] for r in runs[1:]]
    return {
        "frames": len(reader), "cycles": n, "decisions": Counted.decisions, "decision_detection_rate": rate,
        "warm_up": runs[0], "runs": runs[1:], "cycles_per_s": float(np.median(timed)),
        "cycles_per_s_range": [min(timed), max(timed)], "launches": launches, **quality,
    }


def pt_detectors(params, recording, bmp: Path, replay_tmp: Path, timing_path: Path) -> dict:
    """Phase 25: the trained checkpoint written as an ultralytics-layout
    ``.pt`` by the port's ``save_torch_state_dict`` (unfused, BatchNorm
    kept) and loaded back: its state dict is the ``.npz`` load's bit for
    bit, a 12-view forward gives identical logits, and ``track_video
    --detector X.pt`` writes phase 12's whole-frame ``bboxes.csv``
    byte for byte; no hand kernel launches.  Then one ``WeightEvaluator.eval``
    over phase 14's log on the card (timed after a warm-up; one K3 launch
    each) equals the CPU's value exactly."""
    from wtracker_tpu_torch.models.yolo_port import save_torch_state_dict
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, preprocess_batch
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.sim.controllers import WeightEvaluator

    out = {}
    zero_hand_kernel_launches()
    npz = YoloV8Detector.load(str(CHECKPOINT), imgsz=416, device="cuda")
    pt = bmp / "yolov8s_worm416.pt"
    t0 = time.perf_counter()
    save_torch_state_dict(npz, str(pt))
    out["save_s"], out["pt_bytes"] = time.perf_counter() - t0, pt.stat().st_size
    t0 = time.perf_counter()
    back = YoloV8Detector.load(str(pt), imgsz=416, device="cuda")
    out["load_s"] = time.perf_counter() - t0
    a, b = npz.model.state_dict(), back.model.state_dict()
    if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the .pt load's state dict differs from the .npz load's")
    views = torch.from_numpy(np.stack([recording.view(f, params.cam_w) for f in range(0, 240, 20)])).cuda()
    x, _ = preprocess_batch(views, (416, 416))
    with torch.inference_mode():
        la, lb = npz.model(x), back.model(x)
    if not all(torch.equal(p, q) for p, q in zip([*la[0], *la[1]], [*lb[0], *lb[1]])):
        raise AssertionError("the .pt and .npz detectors give different logits")
    out["views"] = len(views)

    cmd = [
        sys.executable, "-m", "wtracker_tpu_torch.workflows.track_video", "--frames", str(bmp / "frames"),
        "--timing-config", str(timing_path), "--exp-config", str(bmp / "exp.json"), "--detector", str(pt),
        "--output", str(bmp / "whole_frames_pt"), "--device", "cuda",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=600)
    out["track_video_wall_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"track_video --detector .pt exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    if (bmp / "whole_frames_pt" / "bboxes.csv").read_text() != (bmp / "whole_frames" / "bboxes.csv").read_text():
        raise AssertionError("track_video with the .pt detector wrote another bboxes.csv than phase 12's")
    out["track_video_identical_to_phase_12"] = True

    out["launches"] = hand_kernel_launches()
    if any(out["launches"].values()):
        raise AssertionError(f"the .pt phase launched a hand kernel: {out['launches']}")

    # the weight evaluator: one K3 launch a call on the card
    timing = TimingConfig.load_json(str(timing_path))
    times, target = np.array(EVAL_SAMPLE_TIMES), params.cycle_n + params.imaging_n // 2
    evals = {dev: WeightEvaluator([str(replay_tmp / "worm.csv")], timing, times, target, device=dev) for dev in ("cuda", "cpu")}
    weights = np.ones(len(times))
    zero_hand_kernel_launches()
    evals["cuda"].eval(weights)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = evals["cuda"].eval(weights)
    out["weight_eval_ms"] = (time.perf_counter() - t0) * 1e3
    cpu = evals["cpu"].eval(weights)
    if card != cpu:
        raise AssertionError(f"WeightEvaluator.eval on the card {card!r} differs from the CPU's {cpu!r}")
    out.update(weight_eval_columns=int(evals["cpu"].y_input.shape[1]), weight_eval_mae=card, weight_eval_card_equals_cpu=True)
    out["weight_eval_launches"] = check_no_hand_kernel("WeightEvaluator.eval", expect=("polyfit",))
    if out["weight_eval_launches"]["polyfit"] != 2:
        raise AssertionError(f"two WeightEvaluator.eval calls launched K3 {out['weight_eval_launches']['polyfit']} times")
    return out


# ---------------------------------------------------------------------------
# dataset and evaluation tools (phases 26-29)
# ---------------------------------------------------------------------------

DATASET_FRAMES = 1024  # phase 26's recording: the box calculator's frames
BG_PROBES = 1000  # the deployment's background probes (initialize_experiment's default)
BOX_CHUNK = 256  # BoxCalculator's default chunk
BOX_CPU_FRAMES = 16  # frames whose boxes the card machine's CPU computes too
MEDIAN_CHECK_ROWS = 8  # rows of each of three bands held against numpy's median
YOLO_INIT_IMGSZ = 1920  # initialize_experiment --detector yolo on whole frames: the trained scale
YOLO_INIT_BATCH = 16
SAMPLE_COUNT, SAMPLE_SIZE = 64, 384
VIS_FRAMES = 30


# a workflow command run as ``python -m`` runs it, whose last line of output
# is that process's launch counts of the four hand kernels
COUNTED_COMMAND = """
import json, runpy, sys
from wtracker_tpu_torch.ops.bias_silu import bias_silu_
from wtracker_tpu_torch.ops.conv_s8 import conv_s8
from wtracker_tpu_torch.ops.polyfit import polyfit
from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({"crop_letterbox": crop_letterbox_views.launches, "conv_s8": conv_s8.launches,
                      "polyfit": polyfit.launches, "bias_silu": bias_silu_.launches}))
"""


def run_module(args: list, timeout: int = 900) -> tuple[float, subprocess.CompletedProcess]:
    """``python -m ARGS`` from the checkout's root: its wall seconds and the
    finished process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                          capture_output=True, text=True, timeout=timeout)
    return time.perf_counter() - t0, proc


def run_cli(name: str, args: list, timeout: int = 600, env: dict | None = None) -> tuple[float, str, dict]:
    """``python -m wtracker_tpu_torch.workflows.<name> ARGS`` in a child
    process: wall seconds, stdout, and the K1-K4 launches counted in that
    process; raises on failure."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", COUNTED_COMMAND, f"wtracker_tpu_torch.workflows.{name}", *map(str, args)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})}, capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name} {args} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    stdout, _, counts = proc.stdout.rstrip("\n").rpartition("\n")
    return wall, stdout, json.loads(counts)


def run_clis(jobs: list[tuple[str, list]]) -> list[tuple[float, str, dict]]:
    """``run_cli`` over several commands at once (their start-ups overlap;
    each one's wall seconds are taken beside the others'), in order."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: run_cli(*job), jobs))


def zero_hand_kernel_launches() -> None:
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.polyfit import polyfit
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views

    crop_letterbox_views.launches = conv_s8.launches = polyfit.launches = bias_silu_.launches = 0


def check_no_hand_kernel(phase: str, commands: list[dict] = (), expect: tuple = ()) -> dict:
    """The launch counts of K1-K4 in this process since the last zeroing
    plus those each of ``commands`` (``run_cli``'s counts) reported; raises
    unless the kernels named in ``expect`` launched and the others did
    not."""
    launches = hand_kernel_launches()
    for counts in commands:
        launches = {k: v + counts[k] for k, v in launches.items()}
    if any(bool(v) != (k in expect) for k, v in launches.items()):
        raise AssertionError(f"{phase} launched {launches}, expected only {list(expect)}")
    return {**launches, "commands_counted": len(commands)}


K4_PER_FORWARD = {"standard": 57, "folded": 56}  # every BN-fused ConvBN; a folded forward starts at b1


@contextlib.contextmanager
def k4_per_forward(phase: str, need: tuple = ()):
    """K4 on the main path: zeroes ``bias_silu_.launches``, counts the
    forwards of every YOLOv8 model in this process while open (by wrapping
    ``YoloV8.forward``) that run ``ConvBN``'s route to K4 (BN-fused, on the
    card, bfloat16 or float32, autograd off), standard and folded, and
    raises unless K4 launched exactly 57 times a standard forward and 56 a
    folded one, with at least one forward of each kind in ``need`` and at
    least one in all.  Yields the counts, which take ``"bias_silu"``."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8
    from wtracker_tpu_torch.ops.bias_silu import DTYPES, bias_silu_

    counts = {"standard": 0, "folded": 0, "without_k4": 0}
    forward = YoloV8.forward

    def counted(self, x, external_stem=False):
        k4 = self.b1.bn is None and x.is_cuda and self.compute_dtype in DTYPES and not torch.is_grad_enabled()
        counts[("folded" if external_stem else "standard") if k4 else "without_k4"] += 1
        return forward(self, x, external_stem)

    bias_silu_.launches = 0
    YoloV8.forward = counted
    try:
        yield counts
    finally:
        YoloV8.forward = forward
    counts["bias_silu"] = bias_silu_.launches
    want = sum(K4_PER_FORWARD[k] * counts[k] for k in K4_PER_FORWARD)
    if not (want and all(counts[k] for k in need) and bias_silu_.launches == want):
        raise AssertionError(f"{phase}: K4 launched {bias_silu_.launches} times, expected {want} "
                             f"(57 a standard forward, 56 a folded one; forwards of {list(need)} needed): {counts}")


def dataset_tools(hw: tuple[int, int], device: str = "cuda") -> dict:
    """Phase 26: ``BGExtractor`` (median over BG_PROBES probes of a seeded
    DATASET_FRAMES-frame recording at full size, 2.4 GB of probes) equal to
    numpy's median on three bands of rows and to the recording's static
    background at >= 99.9 % of pixels; then ``BoxCalculator`` over all
    DATASET_FRAMES frames in chunks of BOX_CHUNK (frames/s after a warm-up
    chunk, floods a chunk), the card's boxes equal to the CPU's on
    BOX_CPU_FRAMES frames, every box around the worm's track point; then
    one chunk taken apart into its stages (``chunk_split``)."""
    from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator
    from wtracker_tpu_torch.ops.morphology import largest_component_bbox
    from wtracker_tpu_torch.utils.frame_reader import ArrayReader

    zero_hand_kernel_launches()
    t0 = time.perf_counter()
    rec = Recording(DATASET_FRAMES, hw, SEED + 26)
    out = {"frames": DATASET_FRAMES, "hw": list(hw), "probes": BG_PROBES, "recording_s": time.perf_counter() - t0}
    reader = ArrayReader(rec.data)
    t0 = time.perf_counter()
    bg = BGExtractor(reader).calc_background(BG_PROBES, device=device)
    out["background_s"] = time.perf_counter() - t0
    ids = np.unique(np.linspace(0, DATASET_FRAMES - 1, num=BG_PROBES).astype(int))
    for y0 in (0, hw[0] // 2, hw[0] - MEDIAN_CHECK_ROWS):
        rows = slice(y0, y0 + MEDIAN_CHECK_ROWS)
        want = np.median(rec.data[ids, rows], axis=0).astype(np.uint8)
        if not np.array_equal(bg[rows], want):
            raise AssertionError(f"the card's median differs from numpy's in rows {y0}-{y0 + MEDIAN_CHECK_ROWS}")
    out["median_equals_numpy_rows"] = 3 * MEDIAN_CHECK_ROWS
    out["static_background_share"] = float((bg == rec.background).mean())
    if not out["static_background_share"] >= 0.999:
        raise AssertionError(f"the median is the static background at only {out['static_background_share']:.5f}")

    BoxCalculator(reader, bg, device=device).calc_specified_boxes(range(BOX_CHUNK), chunk_size=BOX_CHUNK)  # warm-up
    cuda_sync(device)
    calc = BoxCalculator(reader, bg, device=device)
    largest_component_bbox.floods = 0
    t0 = time.perf_counter()
    boxes = calc.calc_all_boxes(chunk_size=BOX_CHUNK)
    out["boxes_s"] = time.perf_counter() - t0
    out["frames_per_s"] = DATASET_FRAMES / out["boxes_s"]
    out["floods_per_chunk"] = largest_component_bbox.floods / -(-DATASET_FRAMES // BOX_CHUNK)
    picks = np.random.default_rng(SEED).choice(DATASET_FRAMES, BOX_CPU_FRAMES, replace=False)
    t0 = time.perf_counter()
    cpu = BoxCalculator(reader, bg, device="cpu").calc_specified_boxes(picks, chunk_size=BOX_CPU_FRAMES)
    out["cpu_boxes_s"] = time.perf_counter() - t0
    if not np.array_equal(cpu, boxes[picks]):
        raise AssertionError(f"the card's boxes differ from the CPU's:\n{boxes[picks]}\n{cpu}")
    out["card_equals_cpu_frames"] = BOX_CPU_FRAMES
    cx, cy = rec.traj[:, 0], rec.traj[:, 1]
    inside = (boxes[:, 0] <= cx) & (cx < boxes[:, 0] + boxes[:, 2]) & (boxes[:, 1] <= cy) & (cy < boxes[:, 1] + boxes[:, 3])
    if not inside.all():
        raise AssertionError(f"{int((~inside).sum())} boxes miss the worm's track point, first at frame {np.argmin(inside)}")
    out["box_wh_median"] = np.median(boxes[:, 2:], axis=0).tolist()
    out["chunk_ms_in_run"] = out["boxes_s"] * 1e3 / -(-DATASET_FRAMES // BOX_CHUNK)
    out["chunk_split"] = chunk_split(reader, bg, boxes, device)
    out["launches"] = check_no_hand_kernel("phase 26")
    return out


def chunk_split(reader, background: np.ndarray, boxes: np.ndarray, device: str = "cuda") -> dict:
    """Phase 26's split of one BOX_CHUNK-frame chunk of ``BoxCalculator``
    into the stages ``worm_bboxes_batch`` runs (its default threshold and
    window sizes): the host gather (``read_batch``), the pageable upload,
    the threshold with opening and dilation, the whole largest-blob step,
    its floods replayed alone (as many as the step ran: without the step's
    host reads of convergence, every 8 floods), and the boxes' download.
    Device stages by CUDA events, ms; the gather by the host clock.  The
    chunk's boxes must be ``boxes``' first rows."""
    from wtracker_tpu_torch.ops import morphology as mo

    dev = torch.device(device)

    def stamp():
        if dev.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(a, b) -> float:
        return a.elapsed_time(b) if dev.type == "cuda" else (b - a) * 1e3

    bg = torch.from_numpy(np.ascontiguousarray(background)).to(dev)
    cuda_sync(dev)
    t0 = time.perf_counter()
    frames = reader.read_batch(np.arange(BOX_CHUNK))
    gather_ms = (time.perf_counter() - t0) * 1e3
    mo.largest_component_bbox.floods = 0
    marks = [stamp()]
    x = torch.from_numpy(frames).to(dev)
    marks.append(stamp())
    mask = mo.dilate(mo.opening((x.to(torch.int32) - bg.to(torch.int32)).abs() > 20, 5), 11)
    marks.append(stamp())
    box, found = mo.largest_component_bbox(mask)
    marks.append(stamp())
    box, found = box.cpu().numpy(), found.cpu().numpy()
    marks.append(stamp())
    cuda_sync(dev)
    floods = mo.largest_component_bbox.floods
    box[~found] = 0
    if not np.array_equal(box, boxes[:BOX_CHUNK]):
        raise AssertionError("the split chunk's boxes differ from BoxCalculator's")
    h, w = mask.shape[-2:]
    neg = torch.where(mask, -torch.arange(h * w, dtype=torch.float32, device=dev).reshape(h, w), -float("inf"))
    cuda_sync(dev)
    f0 = stamp()
    for _ in range(floods):
        neg = mo._propagate_negated(neg, mask)
    f1 = stamp()
    cuda_sync(dev)
    stages = ("upload_ms", "threshold_morphology_ms", "largest_blob_ms", "download_ms")
    out = {"frames": BOX_CHUNK, "gather_ms": gather_ms,
           **{k: ms(a, b) for k, a, b in zip(stages, marks, marks[1:])}, "floods": floods, "floods_alone_ms": ms(f0, f1)}
    out["total_ms"] = gather_ms + sum(out[k] for k in stages)
    return out


def initialize_experiment_cli(recording, bmp: Path, device: str = "cuda") -> dict:
    """Phase 27: ``initialize_experiment`` on phase 12's BMPs, ``--detector
    classical`` (its background and boxes equal to ``BGExtractor`` and
    ``BoxCalculator`` in this process on the same frames), then ``--detector
    yolo`` with the trained checkpoint at YOLO_INIT_IMGSZ: whole frames at
    1920 px keep the worm at the scale the detector was trained on (a 360
    px view at 416; at 416 px a whole frame shrinks it fourfold), and the
    boxes are held to the tracking bar (>= 95 % detected, median centre
    error <= 4 px).  The two commands run at once.  Each command's K1/K2
    launches are counted in its own process."""
    import pandas as pd

    from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    zero_hand_kernel_launches()
    frames, out, imgsz = bmp / "frames", {}, YOLO_INIT_IMGSZ
    (out["classical_wall_s"], stdout, classical_launches), (wall, _, yolo_launches) = run_clis([
        ("initialize_experiment", ["--frames", frames, "--output", bmp / "init_classical", "--device", device]),
        ("initialize_experiment", [
            "--frames", frames, "--output", bmp / f"init_yolo{imgsz}", "--detector", "yolo", "--yolo-weights",
            CHECKPOINT, "--imgsz", imgsz, "--batch", YOLO_INIT_BATCH, "--device", device,
            "--init-position", *(int(round(v)) for v in recording.traj[0])]),  # a run without a box needs it
    ])
    out["classical_stdout"] = stdout.strip().splitlines()
    reader = FrameReader.create_from_directory(str(frames))
    bg = BGExtractor(reader).calc_background(BG_PROBES, device=device)
    if not np.array_equal(np.load(bmp / "init_classical" / "background.npy"), bg):
        raise AssertionError("initialize_experiment's background differs from BGExtractor's in this process")
    boxes = BoxCalculator(reader, bg, device=device).calc_all_boxes().astype(float)
    boxes[boxes[:, 2] <= 0] = np.nan
    got = pd.read_csv(bmp / "init_classical" / "init_bboxes.csv").to_numpy()
    if not np.array_equal(got, boxes, equal_nan=True):
        raise AssertionError("initialize_experiment's classical boxes differ from BoxCalculator's in this process")
    out["classical_detected_share"] = float(np.isfinite(got).all(axis=1).mean())

    n = len(reader)
    got = pd.read_csv(bmp / f"init_yolo{imgsz}" / "init_bboxes.csv").to_numpy()
    found = np.isfinite(got).all(axis=1)
    err = np.hypot(*(got[found, :2] + got[found, 2:] / 2 - recording.traj[:n][found]).T)
    held = out[f"yolo{imgsz}"] = {"wall_s": wall, "detected_share": float(found.mean()),
                                  "median_center_err_px": float(np.median(err)) if found.any() else None}
    if not (held["detected_share"] >= 0.95 and held["median_center_err_px"] <= 4.0):
        raise AssertionError(f"initialize_experiment --detector yolo misses the tracking bar: {held}")
    out["launches"] = check_no_hand_kernel("phase 27", [classical_launches, yolo_launches])
    return out


def create_yolo_images_args(bmp: Path, device: str = "cuda") -> list:
    """Phase 28's command line (seed 0), run beside phase 27's commands."""
    return ["--frames", bmp / "frames", "--output", bmp / "samples", "--count", SAMPLE_COUNT, "--size", SAMPLE_SIZE,
            SAMPLE_SIZE, "--seed", 0, "--device", device]


def create_yolo_images_cli(recording, bmp: Path, ran: tuple, device: str = "cuda") -> dict:
    """Phase 28: ``create_yolo_images --count SAMPLE_COUNT --size SAMPLE_SIZE
    SAMPLE_SIZE`` on phase 12's BMPs (``ran``: ``run_cli``'s result of
    :func:`create_yolo_images_args`); every PNG, decoded by the port's codec,
    is the recording at the window the seed gives (frames, boxes and jitter
    recomputed in this process)."""
    from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator, SampleExtractor
    from wtracker_tpu_torch.utils.frame_reader import FrameReader
    from wtracker_tpu_torch.utils.image_codec import imread

    zero_hand_kernel_launches()
    out_dir, seed = bmp / "samples", 0
    wall, _, launches = ran
    reader = FrameReader.create_from_directory(str(bmp / "frames"))
    calc = BoxCalculator(reader, BGExtractor(reader).calc_background(500, device=device), device=device)
    picks = np.random.default_rng(seed).choice(len(reader), size=SAMPLE_COUNT, replace=False)
    windows = SampleExtractor(calc)._jittered_windows(calc.calc_specified_boxes(picks), (SAMPLE_SIZE, SAMPLE_SIZE),
                                                      np.random.default_rng(seed))
    for i, (f, (x, y, w, h)) in enumerate(zip(picks, windows)):
        got = imread(str(out_dir / f"img_{i:09d}.png"), -1)
        if got is None or not np.array_equal(got, recording.data[f, y : y + h, x : x + w]):
            raise AssertionError(f"sample {i} is not frame {f} at window {(x, y, w, h)}")
    return {"wall_s": wall, "samples": SAMPLE_COUNT, "size": SAMPLE_SIZE,
            "png_bytes": sum(p.stat().st_size for p in out_dir.iterdir()),
            "launches": check_no_hand_kernel("phase 28", [launches])}


def evaluation(recording, bmp: Path, replay_tmp: Path, timing_path: Path, device: str = "cuda") -> dict:
    """Phase 29: ``analysis`` on phase 12's ``bboxes.csv`` with worm crops as
    BMPs and phase 27's background, on the card and on the CPU (the same
    ``analyzed.csv`` bytes; plots written or skipped, and why); then
    ``DataAnalyzer.calc_precise_error(batched=True)`` over phase 14's whole
    log with seeded crops (rows/s; the card's errors equal the CPU's); then
    ``visualize --save-frames`` for VIS_FRAMES frames, the pixels of
    ``VLC.render_frame`` in this process.  The three commands run at once,
    before the in-process timing."""
    import importlib.util

    import pandas as pd

    from wtracker_tpu_torch.eval import VLC, DataAnalyzer
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.utils import bbox as bb
    from wtracker_tpu_torch.utils.frame_reader import ArrayReader, FrameReader
    from wtracker_tpu_torch.utils.image_codec import imread, imwrite

    zero_hand_kernel_launches()
    out = {"plotting_packages": {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "seaborn")}}
    log_path = bmp / "whole_frames" / "bboxes.csv"
    log = pd.read_csv(log_path)
    boxes, legal = bb.discretize(log[WORM_COLS].to_numpy(), recording.hw, bb.BoxFormat.XYWH)
    (bmp / "crops").mkdir()
    for f, (x, y, w, h) in zip(log["frame"], boxes):
        imwrite(str(bmp / "crops" / f"crop_{f:06d}.bmp"), recording.data[f, y : y + max(h, 1), x : x + max(w, 1)])
    args = ["--timing-config", timing_path, "--log", log_path, "--worm-crops", bmp / "crops", "--background",
            bmp / "init_classical" / "background.npy"]
    vis = bmp / "visualize"
    ran = run_clis([
        *(("analysis", [*args, "--output", bmp / f"analysis_{dev}", "--device", dev]) for dev in (device, "cpu")),
        ("visualize", ["--timing-config", timing_path, "--log", log_path, "--frames", bmp / "frames", "--save-frames",
                       vis, "--stop", VIS_FRAMES, "--device", device]),
    ])
    csv, stdout, commands = {}, {}, [launches for _, _, launches in ran]
    for dev, (wall, printed, _) in zip((device, "cpu"), ran):
        out[f"analysis_{dev}_wall_s"], stdout[dev] = wall, printed
        csv[dev] = (bmp / f"analysis_{dev}" / "analyzed.csv").read_bytes()
    out["visualize_wall_s"] = ran[2][0]
    if csv[device] != csv["cpu"]:
        raise AssertionError("analysis wrote another analyzed.csv on the card than on the CPU")
    errs = pd.read_csv(bmp / f"analysis_{device}" / "analyzed.csv")["precise_error"]
    out.update(analysis_rows=len(errs), analysis_precise_finite=int(errs.notna().sum()), analysis_card_equals_cpu=True,
               analysis_legal_boxes=int(legal.sum()))
    skipped = [line for line in stdout[device].splitlines() if line.startswith("plots ")]
    out["plots"] = skipped or sorted(p.name for p in (bmp / f"analysis_{device}").glob("*.png"))

    timing = TimingConfig.load_json(str(timing_path))
    engine_log = replay_tmp / "engine_csv.csv"
    table = pd.read_csv(engine_log)
    wrm, _ = bb.discretize(table[WORM_COLS].to_numpy(), recording.hw, bb.BoxFormat.XYWH)
    rng = np.random.default_rng(SEED + 29)
    crops = rng.integers(0, 256, (len(table), int(wrm[:, 3].max()), int(wrm[:, 2].max())), dtype=np.uint8)
    background = rng.integers(0, 256, recording.hw, dtype=np.uint8)
    errors, secs = {}, {}
    for dev in (device, device, "cpu"):  # the first run on the device warms up
        an = DataAnalyzer.load(timing, str(engine_log))
        an.initialize()
        t0 = time.perf_counter()
        an.calc_precise_error(ArrayReader(crops), background, diff_thresh=90, batched=True, device=dev)
        secs[dev] = time.perf_counter() - t0
        errors[dev] = an._orig_data["precise_error"].to_numpy()
    if not np.array_equal(errors[device], errors["cpu"], equal_nan=True):
        raise AssertionError("calc_precise_error on the card differs from the CPU's")
    out.update(precise_rows=len(table), precise_rows_per_s=len(table) / secs[device], precise_s=secs[device],
               precise_cpu_rows_per_s=len(table) / secs["cpu"], precise_card_equals_cpu=True,
               precise_finite=int(np.isfinite(errors[device]).sum()))

    reader = FrameReader.create_from_directory(str(bmp / "frames"))
    vlc = VLC(files=[f"{reader.root_folder}/{f}" for f in reader.files], config=timing, log_path=str(log_path),
              cam_type="plt", show_cam=True)
    for i in range(VIS_FRAMES):
        if not np.array_equal(imread(str(vis / f"frame_{i:09d}.png"), -1), vlc.render_frame(i)):
            raise AssertionError(f"visualize frame {i} differs from VLC.render_frame")
    out["visualize_frames"] = VIS_FRAMES
    out["launches"] = check_no_hand_kernel("phase 29", commands)
    return out



# ---------------------------------------------------------------------------
# training (phases 30-33)
# ---------------------------------------------------------------------------

# predictor_training's defaults (16 input frames, 4 predicted, batch 128,
# Adam 1e-3, wd 1e-5) over phase 14's log; epochs cut from 100 to 2 (each
# epoch runs the same code; two exercise the command's best-checkpoint choice)
PRED_INPUT_FRAMES = [0, -3, -6, -9, -12, -15, -18, -21, -24, -27, -30, -33, -36, -39, -42, -45]
PRED_PRED_FRAMES = [3, 6, 9, 12]
PRED_BATCH = 128
PRED_EPOCHS = 2
PRED_TIMED_EPOCHS = 1  # in-process epochs timed after the first
# the first epoch's per-batch losses, card against CPU.  Training is chaotic:
# on one CPU a one-ulp nudge of the float64 weights grows from 1e-16 to 1e-9
# of the loss by batch 57 and to 0.14-0.18 by the epoch's end, and a float32
# run leaves rtol 1e-4 from batch 10 to 17 (measured over this log on a CPU;
# on the H100 the card's float64 epoch leaves the CPU's 1e-9 at batch 60).
# So float32 is held for PRED_EQUAL_BATCHES batches at rtol 1e-4, float64
# for PRED_F64_BATCHES at PRED_F64_RTOL, and the whole epoch by its mean
# loss at PRED_MEAN_RTOL (the nudge moves it by 9e-5 to 4e-4)
PRED_EQUAL_BATCHES = 3
PRED_F64_BATCHES, PRED_F64_RTOL = 40, 1e-9
PRED_MEAN_RTOL = 5e-3
# polyfit_optimizer's defaults (pop 100, 300 epochs) in the command; in
# process, the card and the CPU run the first 20 (the card's timed)
PSO_POP, PSO_EPOCHS, PSO_CPU_EPOCHS = 100, 300, 20
PSO_SAMPLE_TIMES = (-30, -25, -20, -15, -10, -5, 0, 3)
# yolo_training at the reference recipe's width: YOLOv8s, 384 px, batch 72,
# augmentation on; 432 rendered worm images, 72 held out (5 steps an epoch);
# epochs cut from 100 to 3, with mosaic closed only for the last one (the
# default close_mosaic=10 would close it for all three) and a 1-epoch warmup
YOLO_IMAGES, YOLO_VAL = 432, 72
YOLO_SCALE, YOLO_IMGSZ, YOLO_BATCH, YOLO_EPOCHS, YOLO_CLOSE_MOSAIC = "s", 384, 72, 3, 1
YOLO_WARMUP_EPOCHS = 1  # the reference's 3 would make the cut run all warmup
YOLO_STEP_CHECK_BATCH = 8  # the card-and-CPU step from the same weights
# that step's gradients, per tensor by ‖g − g_ref‖/‖g_ref‖.  A BatchNorm
# parameter's gradient is a sum over every pixel that cancels, so rounding
# shows in it magnified.  In float64 (the loss itself stays float32, as in
# the JAX package) the card's and the CPU's part by the loss's float32
# rounding so magnified: 3e-7 to 1.6e-5 over seven batches on the H100,
# the loss by up to 2e-7.  Held at YOLO_GRAD_RTOL_F64, which a backward off
# by a factor of 1.001 fails.  In float32 they part by 3e-4 to 1.3e-2, and
# for most tensors the CPU's float32 gradients lie ~10-30x further from the
# float64 ones than the card's; so each device's float32 gradient is held
# against the CPU's float64 one: the card's error at most
# YOLO_GRAD_F32_FACTOR times the CPU's own, plus YOLO_GRAD_F32_FLOOR
YOLO_GRAD_RTOL_F64, YOLO_LOSS_RTOL_F64 = 1e-3, 1e-5
YOLO_GRAD_F32_FACTOR, YOLO_GRAD_F32_FLOOR = 10.0, 1e-4
YOLO_DETECT_CPU_IMAGES = 16  # checkpoint detect_multi, card against CPU
# YOLOv8s's published 28.6 GFLOPs at 640 px (ultralytics), scaled by pixels,
# counted as multiply-adds (2 operations each); a training step is ~3 forwards
YOLO_FORWARD_OPS_640 = 28.6e9
PEAK_TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core operations (not used: TF32 is off)


def first_epoch_losses(train, device, dtype=torch.float32, nudge: float = 0.0) -> tuple[np.ndarray, "MLPTrainer", float]:
    """Phase 30's first epoch from the seeded predictor, in ``dtype`` (the
    weights scaled by ``1 + nudge``): its per-batch losses, the trainer and
    its seconds."""
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.neural.training import MLPTrainer

    pred = make_rmlp_predictor(IOConfig(PRED_INPUT_FRAMES, PRED_PRED_FRAMES), seed=42, device=device)
    pred.model.to(dtype)
    with torch.no_grad():
        for p in pred.model.parameters():
            p.mul_(1 + nudge)
    trainer = MLPTrainer(pred, optimizer="adam", learning_rate=1e-3, weight_decay=1e-5, seed=42)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    t0 = time.perf_counter()
    losses = trainer.train_epoch((train.X.astype(np_dtype), train.y.astype(np_dtype)), batch_size=PRED_BATCH).losses
    return np.asarray(losses), trainer, time.perf_counter() - t0


def loss_gap(a: np.ndarray, b: np.ndarray, rtol: float) -> dict:
    """Two runs' per-batch losses: the largest relative gap, the first batch
    past ``rtol`` and the gap of the epoch's mean loss."""
    rel = np.abs(a - b) / np.abs(b)
    over = np.nonzero(rel > rtol)[0]
    return {"max_rel": float(rel.max()), f"first_batch_over_{rtol:g}": int(over[0]) if len(over) else None,
            "mean_loss_rel": float(abs(a.mean() - b.mean()) / abs(b.mean())), "rel": rel}


def predictor_training_phase(replay_tmp: Path, device: str = "cuda") -> dict:
    """Phase 30: the ResMLP trainer at ``predictor_training``'s defaults over
    phase 14's 61,200-frame log.  In process: a first epoch on the card and
    on the CPU from the same seed, in float32 and in float64, and a float64
    CPU epoch from weights nudged by one ulp, the measure of how fast the
    training itself parts two runs (the constants' comment).  The card's
    per-batch losses equal the CPU's, in float32 the first at rtol 1e-5 and
    the first PRED_EQUAL_BATCHES at rtol 1e-4, in float64 the first
    PRED_F64_BATCHES at PRED_F64_RTOL, and each epoch's mean loss at
    PRED_MEAN_RTOL; where the runs part is reported beside the nudge's.
    Then PRED_TIMED_EPOCHS timed epochs (train and test) on the card.  The
    command itself, PRED_EPOCHS epochs, runs beside the CPU's epochs (whose
    seconds are taken beside it); its ``.npz`` loads in ``load_predictor``
    and predicts finite centres."""
    from wtracker_tpu_torch.models.resmlp import load_predictor
    from wtracker_tpu_torch.neural.config import DatasetConfig
    from wtracker_tpu_torch.neural.dataset import NumpyDataset

    zero_hand_kernel_launches()
    log_path = replay_tmp / "worm.csv"
    t0 = time.perf_counter()
    ds = NumpyDataset.create_from_config(DatasetConfig(PRED_INPUT_FRAMES, PRED_PRED_FRAMES, str(log_path)))
    train, test = ds.split(0.8, seed=42)
    out = {"samples": len(ds), "train_samples": len(train), "dataset_s": time.perf_counter() - t0}

    # the command runs beside the CPU's epochs; the card's come after it
    npz = replay_tmp / "predictor_trained.npz"
    args = ["--logs", log_path, "--output", npz, "--epochs", PRED_EPOCHS, "--device", device]
    runs = {}
    with ThreadPoolExecutor(1) as pool:
        command = pool.submit(run_cli, "predictor_training", args)
        for dtype in (torch.float32, torch.float64):
            runs[dtype, "cpu"] = first_epoch_losses(train, "cpu", dtype)
        nudged = first_epoch_losses(train, "cpu", torch.float64, nudge=2.0**-52)[0]
        wall, stdout, launches = command.result()
    for dtype in (torch.float32, torch.float64):
        runs[dtype, device] = first_epoch_losses(train, device, dtype)
    for (dtype, dev), run in runs.items():
        out[f"first_epoch_s_{torch.device(dev).type}_{str(dtype)[6:]}"] = run[2]
    f32 = loss_gap(runs[torch.float32, device][0], runs[torch.float32, "cpu"][0], 1e-4)
    f64 = loss_gap(runs[torch.float64, device][0], runs[torch.float64, "cpu"][0], PRED_F64_RTOL)
    nudge = loss_gap(nudged, runs[torch.float64, "cpu"][0], PRED_F64_RTOL)
    out["first_epoch_batches"] = len(f32["rel"])
    out["first_epoch_float32"] = {k: v for k, v in f32.items() if k != "rel"}
    out["first_epoch_float64"] = {k: v for k, v in f64.items() if k != "rel"}
    out["first_epoch_float64_cpu_nudged"] = {k: v for k, v in nudge.items() if k != "rel"}
    out["first_epoch_loss_rel_diff_float32"] = [float(v) for v in f32["rel"]]
    out["first_epoch_loss_rel_diff_float64"] = [float(v) for v in f64["rel"]]
    if not (f32["rel"][0] <= 1e-5 and f32["rel"][:PRED_EQUAL_BATCHES].max() <= 1e-4):
        raise AssertionError(f"the card's first float32 losses leave the CPU's: {f32['rel'][:PRED_EQUAL_BATCHES]}")
    if not f64["rel"][:PRED_F64_BATCHES].max() <= PRED_F64_RTOL:
        raise AssertionError(f"the card's first {PRED_F64_BATCHES} float64 losses leave the CPU's: "
                             f"{f64['rel'][:PRED_F64_BATCHES]}")
    if not max(f32["mean_loss_rel"], f64["mean_loss_rel"]) <= PRED_MEAN_RTOL:
        raise AssertionError(f"the card's first-epoch mean loss leaves the CPU's: float32 {f32['mean_loss_rel']}, "
                             f"float64 {f64['mean_loss_rel']}")

    trainer = runs[torch.float32, device][1]
    epoch_s = []
    for _ in range(PRED_TIMED_EPOCHS):
        t0 = time.perf_counter()
        trainer.train_epoch(train, batch_size=PRED_BATCH)
        trainer.test_epoch(test, batch_size=PRED_BATCH)
        epoch_s.append(time.perf_counter() - t0)
    n_batches = len(train) // PRED_BATCH
    out["epoch_s"] = epoch_s
    out["samples_per_s"] = n_batches * PRED_BATCH / float(np.median(epoch_s))
    out["epochs_per_s"] = 1.0 / float(np.median(epoch_s))

    pred = load_predictor(str(npz), device=device)
    y = pred(torch.from_numpy(ds.X[:256]).to(device)).cpu().numpy()
    if y.shape != (256, 2 * len(PRED_PRED_FRAMES)) or not np.isfinite(y).all():
        raise AssertionError(f"the trained predictor gives {y.shape} outputs, finite: {np.isfinite(y).all()}")
    out.update(command_wall_s=wall, command_epochs=PRED_EPOCHS, command_tail=stdout.splitlines()[-1],
               launches=check_no_hand_kernel("phase 30", [launches]))
    return out


def polyfit_optimizer_args(replay_tmp: Path, timing_path: Path, device: str = "cuda") -> list:
    """Phase 31's command line, run beside phase 30's commands and CPU epochs."""
    return ["--timing-config", timing_path, "--logs", replay_tmp / "worm.csv", "--output",
            replay_tmp / "polyfit_tuned.json", "--pop", PSO_POP, "--epochs", PSO_EPOCHS, "--device", device]


def polyfit_optimizer_phase(replay_tmp: Path, timing_path: Path, ran: tuple, device: str = "cuda") -> dict:
    """Phase 31: the particle swarm over phase 14's log: its first
    PSO_CPU_EPOCHS epochs at pop PSO_POP in process on the card (ms an
    epoch, after a 2-epoch warm-up) and on the CPU (the same history bit for
    bit); and the ``polyfit_optimizer`` command at its defaults (pop
    PSO_POP, PSO_EPOCHS epochs; ``ran``: ``run_cli``'s result of
    :func:`polyfit_optimizer_args`), whose tuned error is at most the first
    epochs' best.  K3 launches once an epoch on the card (and once for the
    swarm's first scoring), in process and in the command, and never on the
    CPU."""
    from wtracker_tpu_torch.neural.optimize import optimize_polyfit_weights
    from wtracker_tpu_torch.ops.polyfit import polyfit
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.sim.controllers.polyfit import PolyfitConfig, WeightEvaluator

    zero_hand_kernel_launches()
    log_path = replay_tmp / "worm.csv"
    timing = TimingConfig.load_json(str(timing_path))
    pred_offset = timing.cycle_frame_num + timing.imaging_frame_num // 2
    evaluators = {
        dev: WeightEvaluator([str(log_path)], timing, np.asarray(PSO_SAMPLE_TIMES), pred_offset, device=dev)
        for dev in (device, "cpu")
    }
    optimize_polyfit_weights(evaluators[device], pop_size=PSO_POP, epochs=2, seed=0)  # warm-up
    runs, secs, k3 = {}, {}, {}
    for dev in (device, "cpu"):
        before = polyfit.launches
        t0 = time.perf_counter()
        runs[dev] = optimize_polyfit_weights(evaluators[dev], pop_size=PSO_POP, epochs=PSO_CPU_EPOCHS, seed=0)
        secs[dev] = time.perf_counter() - t0
        k3[dev] = polyfit.launches - before
    if not np.array_equal(runs[device].history, runs["cpu"].history):
        raise AssertionError(f"the card's swarm history leaves the CPU's: {runs[device].history} {runs['cpu'].history}")
    # one batched fit of the whole population an epoch, plus the first scoring
    if k3["cpu"] != 0 or (device == "cuda" and k3[device] != PSO_CPU_EPOCHS + 1):
        raise AssertionError(f"the swarm launched K3 {k3} times in {PSO_CPU_EPOCHS} epochs")

    cmd_wall, stdout, launches = ran
    tuned = PolyfitConfig.load_json(str(replay_tmp / "polyfit_tuned.json"))
    mae = [float(v) for v in re.search(r"MAE uniform (\S+) -> tuned (\S+)", stdout).groups()]
    if not (mae[1] <= runs[device].best_value + 5e-5 and mae[1] < mae[0] and len(tuned.weights) == len(PSO_SAMPLE_TIMES)):
        raise AssertionError(f"the command's MAE {mae} is not at most the first {PSO_CPU_EPOCHS} epochs' "
                             f"{runs[device].best_value}")
    return {
        "pop": PSO_POP, "epochs": PSO_EPOCHS, "cycles": int(evaluators[device].y_target.shape[0] // 2),
        "timed_epochs": PSO_CPU_EPOCHS, "ms_per_epoch": secs[device] / PSO_CPU_EPOCHS * 1e3,
        "cpu_ms_per_epoch": secs["cpu"] / PSO_CPU_EPOCHS * 1e3, "mae_uniform_tuned": mae,
        "command_wall_s": cmd_wall, "k3_launches_in_process": k3[device],
        "launches": check_no_hand_kernel("phase 31", [launches], expect=("polyfit",) if device == "cuda" else ()),
        "command_k3_launches": launches["polyfit"],
    }


def worm_images(root: Path, device: str = "cuda") -> dict:
    """YOLO_IMAGES seeded 384 px views of the synthetic scene (the worm at a
    random place in each, the agar texture at a random arena offset), as
    8-bit PNGs with the renderer's exact boxes as YOLO labels."""
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene
    from wtracker_tpu_torch.utils.image_codec import imwrite

    rng = np.random.default_rng(SEED + 32)
    scene = SyntheticScene()
    size = YOLO_IMGSZ
    pos = rng.uniform(0.1 * size, 0.9 * size, (YOLO_IMAGES, 2)).astype(np.float32)
    cam_tl = rng.integers(0, 4000, (YOLO_IMAGES, 2)).astype(np.float32)
    frame_idx = rng.integers(0, 10_000, YOLO_IMAGES)
    worm = torch.from_numpy(pos + cam_tl).to(device)
    views = scene.render_views(worm, torch.from_numpy(cam_tl).to(device), (size, size), torch.from_numpy(frame_idx).to(device))
    views = torch.round(views).to(torch.uint8).cpu().numpy()
    boxes = scene.gt_bboxes(torch.from_numpy(pos)).numpy().astype(np.float64)  # xywh in view pixels
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(YOLO_IMAGES):
        imwrite(str(root / "images" / f"worm_{i:04d}.png"), views[i])
        x, y, w, h = (float(v) for v in boxes[i] / size)
        (root / "labels" / f"worm_{i:04d}.txt").write_text(f"0 {x + w / 2!r} {y + h / 2!r} {w!r} {h!r}\n")
    return {"images": YOLO_IMAGES, "size": size, "png_bytes": sum(p.stat().st_size for p in (root / "images").iterdir())}


EPOCH_LINE = re.compile(r"epoch (\d+): loss (\S+)  val mAP50 (\S+)  lr (\S+)  train (\S+) s  val (\S+) s")


def yolo_step_bound() -> dict:
    """The least time of one training step: YOLO_FORWARD_OPS_640 scaled to
    the step's pixels, three forwards' work (forward, and backward to inputs
    and to weights), over the card's float32 peak (TF32 is off), and, for a
    later change, over its TF32 tensor-core peak."""
    ops = 3 * YOLO_FORWARD_OPS_640 * (YOLO_IMGSZ / 640) ** 2 * YOLO_BATCH
    return {"step_ops": ops, "bound_ms_f32": ops / PEAK_F32_OPS_PER_S * 1e3, "bound_ms_tf32": ops / PEAK_TF32_OPS_PER_S * 1e3}


def yolo_training_phase(tmp: Path, profile: bool, device: str = "cuda") -> tuple[dict, dict]:
    """Phase 32: ``yolo_training`` at full width (YOLOv8s, 384 px, batch 72,
    the full recipe with augmentation on) over :func:`worm_images`, 3
    epochs: the loss is finite and falls, ``best.npz`` loads, and
    ``detect_multi`` over the held-out images with the last epoch's weights
    gives the run's last validation mAP50 (0 after so few steps from random
    weights, so :func:`check_detect_multi` holds ``detect_multi`` on the
    trained checkpoint); steps/s, images/s, s an epoch, s a validation and
    the peak device memory from the command.  Then one step from
    ``last.npz``'s weights on a batch of YOLO_STEP_CHECK_BATCH held-out
    images, on the card and on the CPU (augmentation off), in float32 and
    in float64, held together by :func:`compare_steps`.  And one profiled
    step of the recipe on the card (top device operators, busy share)."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural.yolo_recipe import (
        RecipeConfig, YoloTrainingRun, average_precision_50, expand_gray, load_yolo_dataset,
    )
    from wtracker_tpu_torch.neural.yolo_training import YoloTrainer
    from wtracker_tpu_torch.tools.trace_profile import profile_run

    zero_hand_kernel_launches()
    t0 = time.perf_counter()
    data = worm_images(tmp, device)
    data["write_s"] = time.perf_counter() - t0
    run_dir = tmp / "run"
    args = ["--images", tmp / "images", "--labels", tmp / "labels", "--output", run_dir / "det.npz", "--scale", YOLO_SCALE,
            "--imgsz", YOLO_IMGSZ, "--batch", YOLO_BATCH, "--epochs", YOLO_EPOCHS, "--close-mosaic", YOLO_CLOSE_MOSAIC,
            "--warmup-epochs", YOLO_WARMUP_EPOCHS, "--val-fraction", repr(YOLO_VAL / YOLO_IMAGES), "--seed", SEED,
            "--device", device]
    wall, stdout, launches = run_cli("yolo_training", args, timeout=900)
    epochs = [dict(zip(("epoch", "loss", "map50", "lr", "train_s", "val_s"), (int(m[1]), *map(float, m.groups()[1:]))))
              for m in EPOCH_LINE.finditer(stdout)]
    peak = re.search(r"peak device memory (\d+) bytes", stdout)  # printed on a card
    peak = int(peak.group(1)) if peak else None
    if len(epochs) != YOLO_EPOCHS or not all(np.isfinite(e["loss"]) for e in epochs):
        raise AssertionError(f"yolo_training ran {epochs}")
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError(f"the training loss did not fall: {[e['loss'] for e in epochs]}")
    steps = -(-(YOLO_IMAGES - YOLO_VAL) // YOLO_BATCH)
    steady = [e["train_s"] for e in epochs[1:]]
    out = {
        **data, "epochs": epochs, "steps_per_epoch": steps, "command_wall_s": wall, "peak_memory_bytes": peak,
        "steps_per_s": steps / float(np.mean(steady)), "images_per_s": steps * YOLO_BATCH / float(np.mean(steady)),
        "epoch_s": float(np.mean(steady)), "first_epoch_s": epochs[0]["train_s"],
        "validation_s": float(np.mean([e["val_s"] for e in epochs])), **yolo_step_bound(),
    }
    out["step_ms"] = 1e3 / out["steps_per_s"]
    out["bound_share_f32"] = out["bound_ms_f32"] / out["step_ms"]
    best = YoloV8Detector.load(str(run_dir / "best.npz"), imgsz=YOLO_IMGSZ, device=device)
    if (best.model.scale, best.model.nc) != (YOLO_SCALE, 1):
        raise AssertionError(f"best.npz holds YOLOv8{best.model.scale} nc={best.model.nc}")

    # the last epoch's validation, again, through detect_multi
    images, gt, cls, mask = load_yolo_dataset(str(tmp / "images"), str(tmp / "labels"), YOLO_IMGSZ, gray_uint8=True)
    val_idx = np.random.default_rng(SEED).permutation(YOLO_IMAGES)[:YOLO_VAL]
    last = YoloV8Detector.load(str(run_dir / "last.npz"), imgsz=YOLO_IMGSZ, conf=RecipeConfig.val_conf, device=device)
    boxes, scores, valid = (t.cpu().numpy() for t in last.detect_multi(
        torch.from_numpy(images[val_idx]).to(device), max_det=RecipeConfig.val_max_det, iou=RecipeConfig.val_iou))
    out["detect_multi_map50"] = average_precision_50(xywh_to_xyxy(boxes), scores, valid, gt[val_idx], mask[val_idx])
    out["detect_multi_map50_diff"] = abs(out["detect_multi_map50"] - epochs[-1]["map50"])
    if not out["detect_multi_map50_diff"] <= 0.01:  # the command divides by 255, the letterbox multiplies by 1/255
        raise AssertionError(f"detect_multi gives mAP50 {out['detect_multi_map50']}, the run {epochs[-1]['map50']}")
    out["checkpoint_detect_multi"] = check_detect_multi(images[val_idx], gt[val_idx], mask[val_idx], device)

    # one step from the same weights on the card and on the CPU, in float32
    # and in float64
    pick = val_idx[:YOLO_STEP_CHECK_BATCH]
    batch = (expand_gray(torch.from_numpy(images[pick])).expand(-1, -1, -1, 3).contiguous(), *(
        torch.from_numpy(a[pick]) for a in (gt, cls, mask)))
    stepped = {}
    for dtype in (torch.float32, torch.float64):
        for role, dev in (("card", device), ("cpu", "cpu")):
            model = YoloV8Detector.load(str(run_dir / "last.npz"), imgsz=YOLO_IMGSZ, device=dev).model.to(dtype)
            trainer = YoloTrainer(model, (YOLO_IMGSZ, YOLO_IMGSZ))
            t0 = time.perf_counter()
            loss, _ = trainer.step(batch[0].to(dtype).numpy(), *(a.numpy() for a in batch[1:]))
            stepped[dtype, role] = (loss, trainer, time.perf_counter() - t0)
    out["step_check"] = compare_steps(stepped)

    # one profiled step of the recipe, augmentation on (after a warm-up step)
    model = YoloV8Detector.load(str(run_dir / "last.npz"), imgsz=YOLO_IMGSZ, device=device).model
    run = YoloTrainingRun(model, (YOLO_IMGSZ, YOLO_IMGSZ), RecipeConfig(
        epochs=YOLO_EPOCHS, batch=YOLO_BATCH, close_mosaic=YOLO_CLOSE_MOSAIC), steps_per_epoch=1)
    d = [torch.from_numpy(a).to(device) for a in (images, gt, cls, mask)]
    rng = np.random.default_rng(SEED)
    run.run_epoch(0, *d, rng)

    def one_step() -> float:
        t0 = time.perf_counter()
        run.run_epoch(1, *d, rng)
        cuda_sync(device)
        return time.perf_counter() - t0

    out["profiled_step"] = profile_run(one_step, top=15)
    out["launches"] = check_no_hand_kernel("phase 32", [launches])
    return out, {"yolo_training_step": one_step} if profile else {}


def xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    return np.concatenate([b[..., :2], b[..., :2] + b[..., 2:]], axis=-1)


def same_detections(a, b, what: str, score_rtol: float = 1e-3) -> dict:
    """Two (boxes xywh, scores, valid) results, slot by slot: the same
    validity, and where valid boxes at IoU >= 0.99 (BASELINE.md's bar) and
    scores at ``score_rtol``."""
    (box_a, score_a, valid_a), (box_b, score_b, valid_b) = a, b
    if not np.array_equal(valid_a, valid_b):
        raise AssertionError(f"{what}: validity differs in {int((valid_a != valid_b).sum())} of {valid_a.size} slots")
    v = valid_a
    ious = iou(box_a[v], box_b[v])
    score_rel = np.abs(score_a[v] - score_b[v]) / np.abs(score_b[v])
    if not (ious.min() >= 0.99 and score_rel.max() <= score_rtol):
        raise AssertionError(f"{what}: boxes at IoU down to {ious.min()}, scores apart by {score_rel.max()} (relative)")
    return {"valid": int(v.sum()), "slots": int(v.size), "min_iou": float(ious.min()), "max_score_rel": float(score_rel.max())}


def check_detect_multi(images: np.ndarray, gt: np.ndarray, mask: np.ndarray, device: str = "cuda") -> dict:
    """Phase 32's check of ``detect_multi`` and ``batched_nms`` where their
    answer means something: the trained YOLOv8s checkpoint at 384 px on the
    held-out rendered views, at its default score floor with the
    validation's IoU and max_det.  The card's detections over all views
    against the CPU's over the first YOLO_DETECT_CPU_IMAGES, and against
    the validation's own pipeline on the card (``detections_for_map``: no
    letterbox, the same NMS), slot by slot (:func:`same_detections`).  Both
    valid and empty slots must occur, so a wrong suppression or validity
    shows.  The checkpoint's mAP50 over the views is reported from both."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural.yolo_recipe import RecipeConfig, average_precision_50, detections_for_map

    max_det, nms_iou = RecipeConfig.val_max_det, RecipeConfig.val_iou
    dets, detectors = {}, {}
    for role, dev, n in (("card", device, len(images)), ("cpu", "cpu", YOLO_DETECT_CPU_IMAGES)):
        detectors[role] = YoloV8Detector.load(str(CHECKPOINT), imgsz=YOLO_IMGSZ, device=dev)
        dets[role] = [t.cpu().numpy() for t in detectors[role].detect_multi(
            torch.from_numpy(images[:n]).to(dev), max_det=max_det, iou=nms_iou)]
    card_detector = detectors["card"]
    valid = dets["card"][2]
    if not 0 < valid.sum() < valid.size:
        raise AssertionError(f"the checkpoint keeps {int(valid.sum())} of {valid.size} slots: the check could not fail")
    val_xyxy, val_scores, val_valid = detections_for_map(
        card_detector.model, images, (YOLO_IMGSZ, YOLO_IMGSZ), card_detector.conf, nms_iou, max_det)
    val_xywh = np.concatenate([val_xyxy[..., :2], val_xyxy[..., 2:] - val_xyxy[..., :2]], axis=-1)
    return {
        "conf": card_detector.conf, "images": len(images), "per_image_valid": [int(n) for n in valid.sum(axis=1)],
        "card_vs_cpu": same_detections([a[:YOLO_DETECT_CPU_IMAGES] for a in dets["card"]], dets["cpu"],
                                       "detect_multi card vs CPU"),
        "card_vs_validation": same_detections(dets["card"], (val_xywh, val_scores, val_valid),
                                              "detect_multi vs detections_for_map"),
        "map50": average_precision_50(xywh_to_xyxy(dets["card"][0]), dets["card"][1], valid, gt, mask),
        "map50_validation": average_precision_50(val_xyxy, val_scores, val_valid, gt, mask),
    }


def grad_gaps(a: torch.nn.Module, b: torch.nn.Module) -> dict:
    """Per parameter tensor, ``‖g_a − g_b‖ / ‖g_b‖`` of two models' gradients."""
    grads_b = dict(b.named_parameters())
    gaps = {}
    for name, p in a.named_parameters():
        ga, gb = p.grad.cpu().double(), grads_b[name].grad.cpu().double()
        gaps[name] = float((ga - gb).norm() / gb.norm().clamp_min(1e-300))
    return gaps


def compare_steps(stepped: dict) -> dict:
    """Phase 32's card-and-CPU step from the same weights on the same batch,
    ``stepped[dtype, "card" | "cpu"] = (loss, trainer, seconds)`` for a
    float32 and a float64 model (TF32 is off).

    The gradients are held per tensor: in float64 the card's against the
    CPU's, ``‖g_card − g_cpu‖/‖g_cpu‖ <= YOLO_GRAD_RTOL_F64``; in float32
    each device's against the CPU's float64 gradient, the card's error at
    most YOLO_GRAD_F32_FACTOR times the CPU's own plus YOLO_GRAD_F32_FLOOR
    (the constants' comment); the tensors of the largest float32 gaps are
    listed by name.  In float32 also the loss at rtol 1e-4, the BatchNorm
    statistics (the batch's, no optimizer in between) at rtol 1e-4 / atol
    1e-5, and the weights: Adam's first step is ``lr·g/(|g| + ε)``, about
    ``lr·sign(g)``, so an entry whose gradient is near zero and takes
    another sign on the two devices parts by up to 2·lr; every entry is
    held to that bound and at least 99 % of them to rtol 1e-4 / atol 1e-4.
    In float64 the loss at YOLO_LOSS_RTOL_F64 (the loss is float32)."""
    f32, f64 = torch.float32, torch.float64
    (loss_g, tr_g, s_g), (loss_c, tr_c, s_c) = stepped[f32, "card"], stepped[f32, "cpu"]
    (loss_g64, tr_g64, s_g64), (loss_c64, tr_c64, s_c64) = stepped[f64, "card"], stepped[f64, "cpu"]
    out = {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_diff": abs(loss_g - loss_c) / abs(loss_c),
           "loss_rel_diff_float64": abs(loss_g64 - loss_c64) / abs(loss_c64),
           "card_step_s": s_g, "cpu_step_s": s_c, "card_step_s_float64": s_g64, "cpu_step_s_float64": s_c64}
    gaps = {
        "float32": grad_gaps(tr_g.model, tr_c.model),
        "float64": grad_gaps(tr_g64.model, tr_c64.model),
        "card_float32_vs_cpu_float64": grad_gaps(tr_g.model, tr_c64.model),
        "cpu_float32_vs_cpu_float64": grad_gaps(tr_c.model, tr_c64.model),
    }
    for key, gap in gaps.items():
        worst = max(gap, key=gap.get)
        out[f"grad_gap_{key}"] = {"max": gap[worst], "tensor": worst, "median": float(np.median(list(gap.values())))}
    card_err, cpu_err = gaps["card_float32_vs_cpu_float64"], gaps["cpu_float32_vs_cpu_float64"]
    share = {name: card_err[name] / (YOLO_GRAD_F32_FACTOR * cpu_err[name] + YOLO_GRAD_F32_FLOOR) for name in card_err}
    out["grad_float32_largest"] = [
        {"tensor": name, "card_vs_cpu": gaps["float32"][name], "card_vs_float64": card_err[name],
         "cpu_vs_float64": cpu_err[name]} for name in sorted(card_err, key=lambda n: -gaps["float32"][n])[:5]]
    worst = max(share, key=share.get)
    out["grad_float32_card_error_share_of_bound"] = {
        "tensor": worst, "share": share[worst], "card_vs_float64": card_err[worst], "cpu_vs_float64": cpu_err[worst]}
    if not out["loss_rel_diff"] <= 1e-4:
        raise AssertionError(f"the card's step loss {loss_g} leaves the CPU's {loss_c}")
    if not out["loss_rel_diff_float64"] <= YOLO_LOSS_RTOL_F64:
        raise AssertionError(f"the card's float64 step loss {loss_g64} leaves the CPU's {loss_c64}")
    if not out["grad_gap_float64"]["max"] <= YOLO_GRAD_RTOL_F64:
        raise AssertionError(f"card and CPU float64 gradients part by {out['grad_gap_float64']}")
    if not share[worst] <= 1:
        raise AssertionError(f"the card's float32 gradient of {worst} is {card_err[worst]:.3g} from the float64 one, "
                             f"the CPU's {cpu_err[worst]:.3g}: {out}")

    lr = tr_c.optimizer.param_groups[0]["lr"]
    params_c = dict(tr_c.model.named_parameters())
    state_c = tr_c.model.state_dict()
    within, total, stats_worst = 0, 0, 0.0
    for name, t in tr_g.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g, c = t.float().cpu(), state_c[name].float()
        if name not in params_c:  # running mean and variance
            stats_worst = max(stats_worst, float(((g - c).abs() - 1e-4 * c.abs()).max()))
            continue
        diff = (g - c).abs()
        if not diff.max() <= 2 * lr * 1.001:
            raise AssertionError(f"{name}: card and CPU weights part by {float(diff.max()):.3g}, more than one Adam step can")
        within += int((diff <= 1e-4 * c.abs() + 1e-4).sum())
        total += g.numel()
    out.update(weights_within_tolerance_share=within / total, weights=total, stats_max_excess=stats_worst)
    if not stats_worst <= 1e-5:
        raise AssertionError(f"card and CPU BatchNorm statistics differ by {stats_worst:.3g} beyond rtol 1e-4")
    if not within >= 0.99 * total:
        raise AssertionError(f"only {within / total:.4f} of the weights agree at rtol 1e-4 / atol 1e-4")
    return out


# ---------------------------------------------------------------------------
# scale-out: the stream mesh (two slots on the card) and data parallelism
# ---------------------------------------------------------------------------

MESH_SLOTS = ("cuda:0", "cuda:0")  # two slots on the one card
INT8_MESH_STREAMS, INT8_MESH_CYCLES = 16, 6  # phase 35: 8 streams a slot
DP_F64_BATCH, DP_F32_BATCH, DP_F32_STEPS = 8, 72, 3  # phase 37's steps
DP_GT = 4
DP_CLI_IMAGES = 80  # yolo_training --dp: 72 to train (one step of batch 72), 8 to validate
DP_RTOL_F64 = 1e-9


def sharded_video(params, base, model, predictor, runs: dict) -> dict:
    """Phase 34: ``run_video_live_sharded`` over phase 13's STREAMS
    recordings on a mesh of two slots on the card (YOLOv8s@416 bf16),
    through K1 (``fold_stem=False``: 2 launches a cycle a slot, asserted)
    and folded (0): each slot's logs equal ``mesh=None`` runs of its own
    streams bit for bit, and the whole is held to phase 13's run within the
    bf16 detector bar (2 px); cycles/s of the sharded loop, total and a
    slot, beside the unsharded run of all four streams."""
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.parallel.mesh import make_mesh
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
    from wtracker_tpu_torch.sim.engine_video import run_video_live_sharded

    recs, init, num_frames = runs["recs"], runs["init"], runs["num_frames"]
    mesh = make_mesh(devices=list(MESH_SLOTS))
    per = STREAMS // mesh.size
    n = params.n_logged_cycles(num_frames)

    def run(cfg, streams, mesh_=None):
        t0 = time.perf_counter()
        logs = run_video_live_sharded(
            params, cfg, [recs[s].frames for s in streams], num_frames, model, predictor, init[list(streams)],
            cycles_per_chunk=STREAM_CHUNK_CYCLES, mesh=mesh_, device="cuda",
        )
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    out = {"slots": [str(d) for d in mesh.devices], "streams": STREAMS, "cycles": n}
    for route, cfg, k1_per_slot_cycle in (
        ("k1", LiveLoopConfig(**base), 2), ("folded", LiveLoopConfig(**{**base, "fold_stem": None}), 0)
    ):
        run(cfg, range(STREAMS), mesh)  # warm-up
        crop_letterbox_views.launches = 0
        logs, secs = run(cfg, range(STREAMS), mesh)
        launches = crop_letterbox_views.launches
        if launches != k1_per_slot_cycle * mesh.size * n:
            raise AssertionError(f"the sharded {route} loop launched K1 {launches} times in {n} cycles on {mesh.size} slots")
        for k in range(mesh.size):
            solo, _ = run(cfg, range(k * per, (k + 1) * per))
            mine = type(solo)(logs.positions[:, k * per : (k + 1) * per], logs.worm_bboxes[:, k * per : (k + 1) * per])
            if not (torch.equal(mine.positions, solo.positions)
                    and torch.equal(mine.worm_bboxes.nan_to_num(-1.0), solo.worm_bboxes.nan_to_num(-1.0))):
                raise AssertionError(f"slot {k} of the sharded {route} loop differs from its streams run alone")
        pos, box = log_diffs(logs, runs["logs_bf16"])
        if not (pos <= 2 and box <= 2.0):
            raise AssertionError(f"the sharded {route} loop leaves phase 13's run: {pos} px, {box} px")
        run(cfg, range(STREAMS))  # the unsharded run's warm-up
        one_s = run(cfg, range(STREAMS))[1]
        for s, rec in enumerate(recs):
            check_tracking(tracking_quality(params, type(logs)(logs.positions[:, s], logs.worm_bboxes[:, s]), rec),
                           params.cam_w)
        out[route] = {
            "crop_letterbox_launches": launches, "crop_letterbox_launches_per_slot": launches // mesh.size,
            "run_s": secs, "cycles_per_s": n / secs, "stream_cycles_per_s": STREAMS * n / secs,
            "stream_cycles_per_s_per_slot": per * n / secs, "unsharded_run_s": one_s,
            "unsharded_stream_cycles_per_s": STREAMS * n / one_s, "slots_equal_to_alone": True,
            "vs_phase13_pos_box_max_abs_diff": [pos, box],
        }
    return out


def sharded_int8(q, qw, predictor) -> dict:
    """Phase 35: the int8 serving loop (phase 21's folded int8 detect in
    ``make_stream_batch_fused``, ``delayed_log``) through
    ``run_engine_sharded`` on two slots of the card, one controller a slot
    from a factory: INT8_MESH_STREAMS streams, INT8_MESH_CYCLES cycles; each
    slot's logs equal ``run_engine_streams`` over its streams alone bit for
    bit; K2 62 launches a forward (asserted), K1 none."""
    from wtracker_tpu_torch.models.yolov8_int8 import Int8Detector, make_detect_fns
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.parallel.mesh import make_mesh, run_engine_sharded
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory
    from wtracker_tpu_torch.tools.gates import tracking_quality as closed_loop_quality

    params = bench_params()
    S, cycles = INT8_MESH_STREAMS, INT8_MESH_CYCLES
    trajs = np.stack([make_trajectory(400, (1400, 1600), seed=200 + i) for i in range(S)])
    init = np.tile([700, 700], (S, 1))
    cfg = LiveLoopConfig(imgsz=(416, 416), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0)
    detect, _ = make_detect_fns(q, src_hw=(params.cam_h, params.cam_w), imgsz=(416, 416), qw=qw)
    det = Int8Detector(q, qw)

    def factory(dev, lo, hi):
        return make_stream_batch_fused(params, cfg, SyntheticScene(), trajs[lo:hi], det, predictor, detect_fn=detect, device=dev)

    mesh = make_mesh(devices=list(MESH_SLOTS))

    def sharded():
        t0 = time.perf_counter()
        logs = run_engine_sharded(params, factory, init, cycles, mesh, batched_controller=True, delayed_log=True)
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    sharded()  # warm-up
    crop_letterbox_views.launches = conv_s8.launches = bias_silu_.launches = 0
    logs, secs = sharded()
    k1, k2, k4 = crop_letterbox_views.launches, conv_s8.launches, bias_silu_.launches
    forwards = mesh.size * (cycles + 1)  # a forward a slot a step; delayed_log steps once more
    if k1 != 0 or k2 != 62 * forwards or k4:
        raise AssertionError(f"the sharded int8 loop launched K1 {k1}, K2 {k2} and K4 {k4} times, expected 0, "
                             f"{62 * forwards} and 0")
    per = S // mesh.size
    for k in range(mesh.size):
        alone = run_engine_streams(params, factory(mesh.devices[k], k * per, (k + 1) * per), init[k * per : (k + 1) * per],
                                   cycles, delayed_log=True, device="cuda")
        part = slice(k * per, (k + 1) * per)
        if not (torch.equal(logs.positions[:, part], alone.positions)
                and torch.equal(logs.worm_bboxes[:, part].nan_to_num(-1.0), alone.worm_bboxes.nan_to_num(-1.0))):
            raise AssertionError(f"slot {k} of the sharded int8 loop differs from its streams run alone")
    quality = closed_loop_quality(params, logs, trajs)
    if not (quality["detection_rate"] >= 0.95 and quality["median_center_err_px"] <= 4.0):
        raise AssertionError(f"the sharded int8 loop lost the worm: {quality}")
    return {
        "slots": [str(d) for d in mesh.devices], "streams": S, "cycles": cycles, "run_s": secs,
        "steps_per_s": S * cycles * params.cycle_n / secs, "crop_letterbox_launches": k1, "conv_s8_launches": k2,
        "conv_s8_launches_per_forward": k2 / forwards, "slots_equal_to_alone": True, **quality,
    }


def sweep_mesh(tmp: Path, device: str = "cuda") -> dict:
    """Phase 36: phase 15's ``sweep`` command over exp0-exp4 again with
    ``--mesh 2`` (two slots on the card, the five experiments padded to
    six), its ``main()`` run in this process (phase 15 timed the command's
    start-up): every ``bboxes.csv`` byte for byte phase 15's."""
    import contextlib
    import io

    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.workflows import sweep as sweep_cli

    exps, _, cfgs = exp0_4()
    out_dir = tmp / "sweep_mesh"
    args = [
        "--worm-csvs", *[str(tmp / f"sweep_worm{i}.csv") for i in range(5)], "--exp-configs", *[str(e) for e, _ in cfgs],
        "--timing-configs", *[str(t) for _, t in cfgs], "--output", str(out_dir), "--device", device, "--mesh", "2",
    ]
    crop_letterbox_views.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        sweep_cli.main(args)
    cuda_sync(device)
    wall = time.perf_counter() - t0
    for i in range(len(exps)):
        if (out_dir / f"exp{i}" / "bboxes.csv").read_bytes() != (tmp / "sweep" / f"exp{i}" / "bboxes.csv").read_bytes():
            raise AssertionError(f"sweep --mesh wrote another exp{i}/bboxes.csv than the run without it")
    if (out_dir / "exp5").exists():
        raise AssertionError("sweep --mesh wrote its padded stream's log")
    if crop_letterbox_views.launches:
        raise AssertionError("sweep --mesh launched K1")
    return {"experiments": len(exps), "slots": 2, "main_s": wall, "equal_to_unsharded": True,
            "stdout": stdout.getvalue().strip().splitlines()}


def dp_batches(n: int, batch: int, seed: int) -> list:
    """``n`` seeded (images, gt, cls, mask) batches at YOLO_IMGSZ: noise
    images, DP_GT box slots, the first half of each batch holding boxes in
    every slot and the second half in one (so each rank's target-score sum
    differs)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.random((batch, YOLO_IMGSZ, YOLO_IMGSZ, 3), dtype=np.float32)
        c = rng.uniform(40, YOLO_IMGSZ - 40, (batch, DP_GT, 2))
        wh = rng.uniform(12, 60, (batch, DP_GT, 2))
        gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        mask = np.zeros((batch, DP_GT), bool)
        mask[: batch // 2] = True
        mask[batch // 2 :, 0] = True
        out.append((images, gt, np.zeros((batch, DP_GT), np.int32), mask))
    return out


def dp_model(dtype=torch.float32):
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    model = YoloV8Detector.init_random(nc=1, scale=YOLO_SCALE, imgsz=YOLO_IMGSZ, seed=SEED, device="cuda").model
    return model.to(dtype)


def one_device_grads(model, batch, dtype) -> tuple[float, dict]:
    """The loss and gradients of one device's step on the whole ``batch``
    from ``model``'s weights (a copy in ``dtype``; no update)."""
    import copy

    from wtracker_tpu_torch.neural.yolo_training import detection_loss

    ref = copy.deepcopy(model).to(dtype).train()
    images, gt, cls, mask = (torch.from_numpy(a).cuda() for a in batch)
    box_l, cls_l = ref(images)
    loss, _ = detection_loss(box_l, cls_l, gt, cls, mask, (YOLO_IMGSZ, YOLO_IMGSZ), ref.reg_max)
    loss.backward()
    return float(loss), {n: p.grad.detach() for n, p in ref.named_parameters()}


def grad_gap(a: dict, b: dict) -> dict:
    """Per tensor ``‖a − b‖/‖b‖`` in float64."""
    return {n: float((a[n].double() - b[n].double()).norm() / b[n].double().norm().clamp_min(1e-300)) for n in b}


def dp_command_args(tmp: Path) -> list[str]:
    """The arguments of phase 37's ``yolo_training --dp --dp-ranks 2``: one
    epoch over the first DP_CLI_IMAGES of phase 32's images (linked into
    ``tmp/dp_data``) at batch 72, one step, 8 images held out."""
    sub = tmp / "dp_data"
    if not sub.exists():
        names = sorted(p.stem for p in (tmp / "images").iterdir())[:DP_CLI_IMAGES]
        for kind, ext in (("images", ".png"), ("labels", ".txt")):
            (sub / kind).mkdir(parents=True)
            for name in names:
                (sub / kind / f"{name}{ext}").symlink_to(tmp / kind / f"{name}{ext}")
    args = ["--images", sub / "images", "--labels", sub / "labels", "--output", tmp / "dp_run" / "det.npz", "--scale",
            YOLO_SCALE, "--imgsz", YOLO_IMGSZ, "--batch", YOLO_BATCH, "--epochs", 1, "--warmup-epochs", 1, "--val-fraction",
            repr((DP_CLI_IMAGES - YOLO_BATCH) / DP_CLI_IMAGES), "--seed", SEED, "--device", "cuda", "--dp", "--dp-ranks", 2]
    return [str(a) for a in args]


def hand_kernel_launches() -> dict:
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.polyfit import polyfit
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views

    return {"crop_letterbox": crop_letterbox_views.launches, "conv_s8": conv_s8.launches, "polyfit": polyfit.launches,
            "bias_silu": bias_silu_.launches}


def dp_worker(rank: int, init_method: str, out: str) -> int:
    """One of phase 37's two gloo ranks on the card (``chip_smoke.py
    --dp-worker RANK INIT OUT``): the float64 step at DP_F64_BATCH and
    DP_F32_STEPS float32 steps at DP_F32_BATCH, each on its half of the
    batches of :func:`dp_batches`.  Before each step rank 0 also takes one
    device's loss and gradients on the whole batch from the same weights
    (float32 and float64; the other rank waits in the step's first
    collective), and after it compares them with the step's all-reduced
    ones; the step alone is timed.  Then the rank runs the ``yolo_training
    --dp`` command as that command's launcher runs each rank (``python -m``
    with the rank's environment, a new group).  The K1/K2 launches of this
    process are counted from its start, over the steps and over the
    command.  Writes ``OUT/rank{RANK}.json``."""
    import copy
    import io
    import runpy

    from wtracker_tpu_torch.neural.yolo_training import YoloTrainer, make_dp_yolo_train_step
    from wtracker_tpu_torch.parallel import mesh as pm

    t_rank = time.perf_counter()
    mesh = pm.make_mesh(axis="data", devices=list(MESH_SLOTS))
    pm.init_data_parallel(mesh, rank, init_method)
    zero_hand_kernel_launches()
    imgsz = (YOLO_IMGSZ, YOLO_IMGSZ)
    res = {"rank": rank}

    # float64: the step equals one device's (loss, gradients, statistics)
    t0 = time.perf_counter()
    model32 = dp_model()
    trainer = YoloTrainer(copy.deepcopy(model32).to(torch.float64), imgsz)
    batch = dp_batches(1, DP_F64_BATCH, SEED + 37)[0]
    if rank == 0:
        one = YoloTrainer(copy.deepcopy(trainer.model), imgsz)
        one_loss, _ = one.step(*batch)
    loss, _ = make_dp_yolo_train_step(trainer, mesh)(*batch)
    res["f64_loss"] = float(loss)
    if rank == 0:
        gaps = grad_gap({n: p.grad for n, p in trainer.model.named_parameters()},
                        {n: p.grad for n, p in one.model.named_parameters()})
        worst = max(gaps, key=gaps.get)
        ours, theirs = trainer.model.state_dict(), one.model.state_dict()
        stats = max(float((ours[k] - v).abs().max() / v.abs().max().clamp_min(1e-300))
                    for k, v in theirs.items() if k.endswith(("running_mean", "running_var")))
        res["f64"] = {"loss": float(loss), "loss_one_device": one_loss, "loss_rel_diff": abs(float(loss) - one_loss) / abs(one_loss),
                      "grad_gap_max": gaps[worst], "grad_gap_tensor": worst, "grad_gap_median": float(np.median(list(gaps.values()))),
                      "stats_rel_max": stats}
        del one
    del trainer
    res["f64_s"] = time.perf_counter() - t0

    # float32: each step against one device's from the same weights
    t0 = time.perf_counter()
    trainer = YoloTrainer(model32, imgsz)
    step = make_dp_yolo_train_step(trainer, mesh)
    res["f32"], res["f32_losses"] = [], []
    for batch in dp_batches(DP_F32_STEPS, DP_F32_BATCH, SEED + 38):
        if rank == 0:
            loss32, g32 = one_device_grads(trainer.model, batch, torch.float32)
            _, g64 = one_device_grads(trainer.model, batch, torch.float64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        res["f32_losses"].append(float(loss))
        if rank == 0:
            dp = {n: p.grad for n, p in trainer.model.named_parameters()}
            dp_err, own_err = grad_gap(dp, g64), grad_gap(g32, g64)
            share = {n: dp_err[n] / (YOLO_GRAD_F32_FACTOR * own_err[n] + YOLO_GRAD_F32_FLOOR) for n in dp_err}
            worst = max(share, key=share.get)
            vs32 = grad_gap(dp, g32)
            res["f32"].append({
                "loss": float(loss), "loss_one_device": loss32, "loss_rel_diff": abs(float(loss) - loss32) / abs(loss32),
                "ms": 1e3 * seconds, "grad_share_of_bound": share[worst], "grad_tensor": worst,
                "dp_vs_float64": dp_err[worst], "one_device_vs_float64": own_err[worst],
                "dp_vs_one_device_max": max(vs32.values()), "dp_vs_one_device_median": float(np.median(list(vs32.values()))),
            })
            del g32, g64
    del trainer, step, model32
    res["f32_s"] = time.perf_counter() - t0
    res["launches"] = hand_kernel_launches()
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # the command's rank: the environment its launcher gives each rank
    zero_hand_kernel_launches()
    os.environ.update(pm.spawn_env(rank, list(MESH_SLOTS), f"file://{Path(out) / 'dp_cli_store'}"))
    module = "wtracker_tpu_torch.workflows.yolo_training"
    saved_argv, sys.argv = sys.argv, [module, *dp_command_args(Path(out))]
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved_argv
    res["command"] = {"rank_s": time.perf_counter() - t0, "stdout": printed.getvalue(), "launches": hand_kernel_launches()}
    res["rank_s"] = time.perf_counter() - t_rank
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def dp_steps(tmp: Path) -> dict:
    """Phase 37, the data-parallel detector step and ``yolo_training --dp``:
    YOLOv8s at YOLO_IMGSZ, two gloo ranks on the card (:func:`dp_worker`,
    child processes; rank 0 takes one device's step on the whole batch from
    the same weights).  float64 at DP_F64_BATCH: the loss, the all-reduced
    gradients (per tensor, ``‖g_dp − g‖/‖g‖``) and the BatchNorm running
    statistics at DP_RTOL_F64.  float32 at DP_F32_BATCH, DP_F32_STEPS AdamW
    steps, each against one device from the same weights: the loss at rtol
    1e-4, the gradients with phase 32's float32 bound (the ranks' distance
    from the float64 gradient at most YOLO_GRAD_F32_FACTOR times one
    device's, plus YOLO_GRAD_F32_FLOOR).  (Two float32 runs do not stay
    together over steps: Adam's first step moves an entry whose gradient is
    rounding noise by ``lr`` either way.)  Both ranks report the same
    losses.  The data-parallel step's ms.  Then the same two processes run
    the command's ranks (:func:`dp_command_args`): one epoch line (rank 0
    alone prints), a finite loss, ``det.npz`` loads.  Neither hand kernel
    launches in either rank (counted in each rank from its start)."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    zero_hand_kernel_launches()
    dp_command_args(tmp)  # the command's images, linked before the ranks start
    t0 = time.perf_counter()
    store = tmp / "dp_store"
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(r), f"file://{store}", str(tmp)],
                              cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"a data-parallel rank exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    r0, r1 = ranks
    if [r0["f64_loss"], *r0["f32_losses"]] != [r1["f64_loss"], *r1["f32_losses"]]:
        raise AssertionError("the two ranks report different losses")
    out = {"ranks": 2, "slots": list(MESH_SLOTS), "backend": "gloo", "f64_batch": DP_F64_BATCH, "f32_batch": DP_F32_BATCH,
           "ranks_wall_s": time.perf_counter() - t0, "rank_s": [r["rank_s"] for r in ranks],
           "rank0_f64_s": r0["f64_s"], "rank0_f32_s": r0["f32_s"], "f64": r0["f64"], "f32_steps": r0["f32"]}
    f64 = r0["f64"]
    if not (f64["loss_rel_diff"] <= DP_RTOL_F64 and f64["grad_gap_max"] <= DP_RTOL_F64 and f64["stats_rel_max"] <= DP_RTOL_F64):
        raise AssertionError(f"the float64 data-parallel step leaves one device's: {f64}")
    for i, st in enumerate(r0["f32"]):
        if not (st["loss_rel_diff"] <= 1e-4 and st["grad_share_of_bound"] <= 1):
            raise AssertionError(f"float32 data-parallel step {i} leaves one device's from the same weights: {st}")
    out["dp_step_ms"] = [st["ms"] for st in r0["f32"]]
    out["launches"] = check_no_hand_kernel("phase 37's steps", [r["launches"] for r in ranks])

    if r1["command"]["stdout"].strip():
        raise AssertionError(f"rank 1 of yolo_training --dp printed: {r1['command']['stdout'][:400]}")
    epochs = [m.groups() for m in EPOCH_LINE.finditer(r0["command"]["stdout"])]
    if len(epochs) != 1 or not np.isfinite(float(epochs[0][1])):
        raise AssertionError(f"yolo_training --dp printed {r0['command']['stdout'][-2000:]}")
    YoloV8Detector.load(str(tmp / "dp_run" / "det.npz"), imgsz=YOLO_IMGSZ, device="cuda")
    out["command"] = {
        "rank_s": [r["command"]["rank_s"] for r in ranks], "loss": float(epochs[0][1]), "train_s": float(epochs[0][4]),
        "val_s": float(epochs[0][5]),
        "launches": check_no_hand_kernel("yolo_training --dp's ranks", [r["command"]["launches"] for r in ranks]),
    }
    return out


# ---------------------------------------------------------------------------
# the detector recipe's resume on the card (phase 42)
# ---------------------------------------------------------------------------

RESUME_IMGSZ, RESUME_IMAGES = 64, 8  # tests/test_torch_yolo_recipe.py's kill-and-resume size


def resume_images(rng: np.random.Generator, count: int = RESUME_IMAGES, size: int = RESUME_IMGSZ, boxes: int = 2):
    """Seeded gray uint8 images of bright rectangles on a dark ground with
    their exact boxes (xyxy), one box in even images and two in odd ones."""
    images = rng.uniform(0, 0.2, size=(count, size, size)).astype(np.float32)
    gt = np.zeros((count, boxes, 4), np.float32)
    cls = np.zeros((count, boxes), np.int32)
    mask = np.zeros((count, boxes), bool)
    for i in range(count):
        for j in range(boxes if i % 2 else 1):
            cx, cy = rng.integers(12, size - 12, size=2)
            w, h = rng.integers(8, 16, size=2)
            images[i, cy - h // 2: cy + h // 2, cx - w // 2: cx + w // 2] = rng.uniform(0.7, 1.0)
            gt[i, j] = (cx - w // 2, cy - h // 2, cx + w // 2, cy + h // 2)
            mask[i, j] = True
    return (images * 255).astype(np.uint8), gt, cls, mask


def resume_runs(device: str = "cuda", resume: bool = True) -> dict:
    """The detector recipe at the CPU test's size (YOLOv8n at 64 px, 8
    images of which 2 held out, 3 epochs of batch 4 with augmentation,
    mosaic closed for the last), as ``yolo_training`` runs it
    (``YoloTrainingRun.fit``), run twice uninterrupted; with ``resume``
    also killed after epoch 2 and resumed from its checkpoint with other
    initial weights.  Returns the second uninterrupted run's and the resumed
    run's gaps from the first (weights, EMA weights, last loss, mAP50), and
    whether their checkpoints are the same bytes."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural import yolo_recipe as rec

    data = resume_images(np.random.default_rng(3))
    cfg = rec.RecipeConfig(epochs=3, batch=4, lr0=2e-3, warmup_epochs=1.0, val_fraction=0.25, val_max_det=4,
                           patience=10, close_mosaic=1, seed=1)

    def run(ckpt: str, seed: int = 5, **kw):
        model = YoloV8Detector.init_random(nc=1, scale="n", imgsz=RESUME_IMGSZ, seed=seed, device=device).model
        trainer = rec.YoloTrainingRun(model, (RESUME_IMGSZ, RESUME_IMGSZ), cfg, n_train=6)
        hist = trainer.fit(*data, ckpt_dir=ckpt, log=lambda s: None, **kw)
        tensors = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
        tensors.update({f"ema.{k}": v for k, v in trainer.ema_model.state_dict().items()})
        return hist, {"tensors": tensors, "loss": hist[-1].train_loss, "map50": hist[-1].val_map50}

    def gap(a: dict, b: dict) -> dict:
        """The largest absolute difference of any weight, the relative L2
        distance of all of them, and the scalars' differences."""
        floats = [k for k, v in a["tensors"].items() if v.is_floating_point()]
        diff = torch.cat([(a["tensors"][k].double() - b["tensors"][k].double()).flatten() for k in floats])
        norm = torch.cat([b["tensors"][k].double().flatten() for k in floats]).norm()
        exact = all(torch.equal(v, b["tensors"][k]) for k, v in a["tensors"].items())
        return {"bit_equal": exact and a["loss"] == b["loss"] and a["map50"] == b["map50"],
                "weights_max_abs": float(diff.abs().max()), "weights_rel_l2": float(diff.norm() / norm),
                "loss": abs(a["loss"] - b["loss"]), "map50": abs(a["map50"] - b["map50"])}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        (_, a), (_, a2) = (run(f"{tmp}/{name}") for name in ("a", "a2"))
        out = {"uninterrupted": gap(a2, a), "loss": a["loss"], "map50": a["map50"]}
        if resume:
            first, _ = run(f"{tmp}/b", stop_after=2)
            resumed_hist, resumed = run(f"{tmp}/b", seed=9, resume=True)  # other weights: all must come back
            if [h.epoch for h in first] != [0, 1] or [h.epoch for h in resumed_hist] != [2]:
                raise AssertionError(f"epochs {[h.epoch for h in first]} then {[h.epoch for h in resumed_hist]}")
            out["resumed"] = gap(resumed, a)
            out["checkpoints_equal"] = all(Path(f"{tmp}/a/{f}").read_bytes() == Path(f"{tmp}/b/{f}").read_bytes()
                                           for f in ("best.npz", "last.npz"))
    out["seconds"] = time.perf_counter() - t0
    return out


def resume_worker(out: str) -> int:
    """Phase 42's child (``chip_smoke.py --resume-worker OUT``, started with
    ``CUBLAS_WORKSPACE_CONFIG`` set): :func:`resume_runs` with the card's
    default kernels, then with torch's deterministic algorithms; their
    results and the launch counts to ``OUT``."""
    default = resume_runs(resume=False)
    torch.use_deterministic_algorithms(True, warn_only=True)  # warn_only: the nearest-upsample backward has none
    det = resume_runs()
    Path(out).write_text(json.dumps({"default_kernels": default, "deterministic": det, "launches": hand_kernel_launches()}))
    return 0


def start_resume(tmp: Path) -> subprocess.Popen:
    """Phase 42 in a child process (:func:`resume_worker`), run beside
    phases 27-29's commands; :func:`finish_resume` collects it."""
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--resume-worker", str(tmp / "resume.json")],
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_resume(child: subprocess.Popen, tmp: Path, started: float) -> dict:
    """Phase 42: ``yolo_training --resume`` on the card.  The card's default
    kernels are not bit-reproducible (cuDNN's weight gradients, atomics):
    two uninterrupted runs of :func:`resume_runs` part, and their spread is
    recorded.  With torch's deterministic algorithms the two uninterrupted
    runs must be bit-equal, and the run killed after epoch 2 and resumed
    must equal them bit for bit (weights, EMA weights, loss, mAP50,
    ``best.npz`` and ``last.npz``).  No hand kernel launches."""
    try:
        _, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"phase 42's runs exited {child.returncode}:\n{err[-4000:]}")
    out = json.loads((tmp / "resume.json").read_text())
    out["launches"] = check_no_hand_kernel("phase 42's runs", [out["launches"]])
    det = out["deterministic"]
    if not (det["uninterrupted"]["bit_equal"] and det["resumed"]["bit_equal"] and det["checkpoints_equal"]):
        raise AssertionError(f"with deterministic algorithms the resumed run is not the uninterrupted one: {det}")
    return {**out, "wall_s": time.perf_counter() - started}


# ---------------------------------------------------------------------------
# the detector's gates and the trace tool (phases 38-39)
# ---------------------------------------------------------------------------

TRACE_STREAMS, TRACE_CYCLES = 8, 2  # phase 39's profiled synthetic loop


def detector_gates() -> dict:
    """Phase 38: ``tools/run_gates.py``'s gates on the card at the JAX gates'
    sizes: held-out AP@0.5 of the trained checkpoint on 24 rendered images,
    its int8 drift on 16 views after 32 calibration views, the closed loop
    at S=1 x 6 cycles, the int8 drift of random s weights and the s/416
    parity against the CPU in float32.  Every gate must pass, the two int8
    gates launch K2 (the gates raise on the card otherwise) and no gate
    launches K1."""
    from wtracker_tpu_torch.tools import run_gates

    zero_hand_kernel_launches()
    with k4_per_forward("phase 38") as k4:
        out = run_gates.run_all(run_gates.parse_args([]))
    failed = {k: r["failed"] for k, r in out.items() if r["status"] != "pass"}
    if len(out) != 5 or failed:
        raise AssertionError(f"detector gates failed: {failed}: {out}")
    launches = hand_kernel_launches()
    if (launches["crop_letterbox"] or launches["polyfit"]
            or not all(out[k]["launches"]["conv_s8"] for k in ("trained_int8_drift", "int8_drift_s416"))):
        raise AssertionError(f"the gates launched K1 or K3, or an int8 gate ran without K2: {launches}")
    return {"gates": out, "launches": launches, "k4": k4}


def trace_tool() -> dict:
    """Phase 39: ``tools/trace_profile.py`` in this process on the bf16
    synthetic loop at S=TRACE_STREAMS x TRACE_CYCLES cycles: a busy share in
    (0, 1] and kernels listed."""
    from wtracker_tpu_torch.tools.trace_profile import trace

    out = trace("bf16", streams=TRACE_STREAMS, cycles=TRACE_CYCLES, top=10)
    if not (0 < out["device_busy_share"] <= 1 and out["top_kernels"]):
        raise AssertionError(f"trace_profile saw no device work: {out}")
    return out


# phase 40: the bench's measurement in process at S=8 x 2 cycles, and the
# video bench over a 240-frame exp0 recording in chunks of 4 cycles
BENCH_ENV = {"BENCH_STREAMS": "8", "BENCH_CYCLES": "2", "BENCH_REPEATS": "1", "BENCH_INT8": "1",
             "BENCH_LATENCY": "1", "BENCH_VIDEO": "0", "BENCH_WEIGHTS": "trained"}
BENCH_LATENCY_N, BENCH_CADENCE_N = 20, 8
BENCH_VIDEO_FRAMES, BENCH_VIDEO_CHUNK_CYCLES, BENCH_VIDEO_ROI = 240, 4, 512


def bench_tools() -> dict:
    """Phase 40: ``tools/bench.py``'s measurement (``_measure``, its JSON
    line) in this process at S=8 x 2 cycles, one timed window, 20 decisions
    a latency and 8 at the 250 ms cadence, bf16 and int8: K1 and K3 never
    launch, K2 launches 62 times a forward of every int8 window and decision
    (the traced ones included, and nowhere else), and each of the four
    latencies reads 20 traced calls, each with a card busy time above 0 and
    at most its own host time.  Then ``tools/bench_video.py::run`` over a
    240-frame recording of the exp0 geometry (written by
    ``tools/recording.py``), whole frames and ROI 512 px, in chunks of 4
    cycles: no hand kernel launches (the folded stem)."""
    from wtracker_tpu_torch.tools import bench, bench_video, recording

    measure_latency, traced = bench.measure_decision_latency, []

    def sampled(*args, **kwargs):  # each latency's per-call seconds, for the checks below
        samples = {}
        traced.append(samples)
        return measure_latency(*args, **kwargs, samples=samples)

    saved = {k: os.environ.get(k) for k in BENCH_ENV}
    os.environ.update(BENCH_ENV)
    bench.measure_decision_latency = sampled
    zero_hand_kernel_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr), k4_per_forward("the bench") as k4:
            line = bench._measure(latency_n=BENCH_LATENCY_N, cadence_n=BENCH_CADENCE_N)  # its line printed at the end
    finally:
        bench.measure_decision_latency = measure_latency
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    measure_s = time.perf_counter() - t0
    launches = hand_kernel_launches()
    # int8 forwards: the warm-up and the timed window, each (cycles + 1)
    # steps of chunks_int8 sub-batches (delayed logging steps once more);
    # a decision per warm-up, timed and traced call at S=1 and S=4, and the
    # cadence's warm-up and calls
    S, cycles = int(BENCH_ENV["BENCH_STREAMS"]), int(BENCH_ENV["BENCH_CYCLES"])
    chunks8 = line["chunks"]["int8"]
    forwards = ((1 + int(BENCH_ENV["BENCH_REPEATS"])) * (cycles + 1) * chunks8
                + 2 * (bench.DECISION_WARMUP + 2 * BENCH_LATENCY_N) + 1 + BENCH_CADENCE_N)
    if launches != {"crop_letterbox": 0, "conv_s8": 62 * forwards, "polyfit": 0, "bias_silu": k4["bias_silu"]}:
        raise AssertionError(f"the bench launched {launches}, expected K1 0, K2 62 x {forwards}, K3 0 and K4 {k4}")
    lat = line["latency_ms"]
    for key in ("bf16_s1", "bf16_s4", "int8_s1", "int8_s4"):
        if lat[key]["n"] != BENCH_LATENCY_N or "device" not in lat[key]:
            raise AssertionError(f"bench latency {key}: {lat[key]}")
    calls = [len(t["device"]) for t in traced]
    if calls != [BENCH_LATENCY_N] * 4:
        raise AssertionError(f"the bench traced {calls} calls for 4 x {BENCH_LATENCY_N} decisions")
    for t in traced:
        if not all(0 < dev <= host for dev, host in zip(t["device"], t["traced_e2e"])):
            raise AssertionError(f"a decision's card busy time is not in (0, its host time]: {t}")
    busy_share = [float(np.mean(np.divide(t["device"], t["traced_e2e"]))) for t in traced]
    if not (line["value"] > 0 and line["int8"]["value"] > 0 and line["card"] and "vs_baseline" not in line):
        raise AssertionError(f"bench line: {line}")
    if line["chunks"]["views_per_chunk_bf16"] * line["chunks"]["bf16"] != S * 15:
        raise AssertionError(f"bench chunks: {line['chunks']}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_video_") as tmp:
        frames = os.path.join(tmp, "frames")
        made = recording.generate(frames, BENCH_VIDEO_FRAMES, seed=0)
        zero_hand_kernel_launches()
        t1 = time.perf_counter()
        with k4_per_forward("the video bench", need=("folded",)) as video_k4:
            video = {
                "whole": bench_video.run(frames, "bf16", chunk_cycles=BENCH_VIDEO_CHUNK_CYCLES),
                "roi": bench_video.run(frames, "bf16", chunk_cycles=BENCH_VIDEO_CHUNK_CYCLES, roi=BENCH_VIDEO_ROI),
            }
        video_s = time.perf_counter() - t1
    video_launches = hand_kernel_launches()
    cycles_video = (BENCH_VIDEO_FRAMES - 1) // 15
    for name, r in video.items():
        if not (r["frames"] == BENCH_VIDEO_FRAMES and r["cycles"] == cycles_video and 0 <= r["decode_share"] <= 1
                and r["value"] > 0):
            raise AssertionError(f"video bench {name}: {r}")
    if video["roi"]["roi"]["window_px"] != BENCH_VIDEO_ROI or any(v for k, v in video_launches.items() if k != "bias_silu"):
        raise AssertionError(f"video bench ROI {video['roi']}, launches {video_launches}")
    return {
        "bench": line, "launches": launches, "expected_conv_s8_forwards": forwards, "k4": k4, "traced_calls": calls,
        "busy_share_of_traced_host_time": busy_share, "measure_s": measure_s,
        "video": video, "video_launches": video_launches, "video_k4": video_k4, "recording": {k: made[k] for k in ("frames", "bytes", "seconds")},
        "video_s": video_s,
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA card is visible; this script measures the port on the card only")
        return 2
    if not (ROOT / "wtracker_tpu_torch" / "__init__.py").is_file() or not CHECKPOINT.is_file():
        log(f"chip_smoke: {ROOT} is not a checkout of the repository (package or checkpoint missing)")
        return 2

    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, detect_top1, detect_top1_preprocessed
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.ops import _build
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    # one nvcc a source, all started together; K3's (the longest) is first
    # needed in phase 14, so phases 3-13 run while it builds
    t0 = time.perf_counter()
    k3_build = ThreadPoolExecutor(1)
    k3_report = k3_build.submit(lambda: (_build.build_all(("polyfit_f64",)), time.perf_counter() - t0))
    reports = _build.build_all(("crop_letterbox", "conv_s8", "bias_silu"))
    build_s = time.perf_counter() - t0
    log_nvcc(reports)
    log(f"built K1, K2 and K4 in {build_s:.1f} s")
    k2_sass = tensor_core_sass(_build.library_path("conv_s8"))
    log(f"conv_s8 SASS: {k2_sass}")
    if k2_sass["IGMMA"] == 0 or k2_sass["IDP4A"] != 0:
        raise AssertionError(f"K2 must compute on the int8 tensor cores (IGMMA) and not with __dp4a: {k2_sass}")

    # -- 3. kernels against their plain versions, and their times -----------
    exp = ExperimentConfig.load_json(str(ROOT / "configs" / "exp_config.json"))
    timing = TimingConfig.load_json(str(ROOT / "configs" / "timing_config.json"))
    H, W = (int(v) for v in exp.orig_resolution)
    params = EngineParams.from_timing(timing, (H, W))
    cam, imgsz = params.cam_w, 416
    if not (params.cam_w == params.cam_h == 360 and (params.imaging_n, params.moving_n) == (12, 3)):
        raise AssertionError(f"the deployment config changed: {params}")

    rng = np.random.default_rng(SEED)
    chunk_frames = CYCLES_PER_CHUNK * params.cycle_n
    frames = torch.from_numpy(rng.integers(0, 256, (chunk_frames, H, W), dtype=np.uint8)).cuda()
    errs = check_crop_letterbox(frames, rng)
    log(f"crop_letterbox vs plain, largest error: {({str(d)[6:]: e for d, e in errs.items()})}")
    times = {n: time_crop_letterbox(frames, cam, imgsz, n, rng) for n in (params.imaging_n, params.moving_n)}
    del frames
    torch.cuda.synchronize()
    for n, t in times.items():
        log(f"crop_letterbox N={n}: {t}")

    # -- 43. K4, the bf16 detector's bias + SiLU pass -----------------------
    k4 = time_bias_silu(reports.get("bias_silu", ""))
    log(f"bias_silu: {k4}")

    # -- 4. models ----------------------------------------------------------
    detector = YoloV8Detector.load(str(CHECKPOINT), imgsz=imgsz, device="cuda").fuse().to(torch.bfloat16)
    model = detector.model
    predictor = make_rmlp_predictor(IOConfig([0, -3, -6, -9, -12], [3]), seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"detector YOLOv8{model.scale} nc={model.nc} {n_params} parameters, {model.compute_dtype}")
    # warm the detector's convolutions at both batch sizes outside the timed loop
    with torch.inference_mode():
        for n in (params.imaging_n, params.moving_n):
            detect_top1_preprocessed(
                model, torch.zeros((n, imgsz, imgsz, 3), dtype=torch.bfloat16, device="cuda"),
                (imgsz / cam, 0, 0), (imgsz, imgsz), 0.1,
            )
    torch.cuda.synchronize()

    # -- 5. the main path through the kernel --------------------------------
    num_frames = N_CYCLES * params.cycle_n + 1
    recording = Recording(num_frames, (H, W), SEED)
    base = dict(imgsz=(imgsz, imgsz), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=40.0, fold_stem=False)
    crop_letterbox_views.launches = 0
    with k4_per_forward("phase 5", need=("standard",)) as k4_video:
        logs_k, secs_k = run_loop(
            params, LiveLoopConfig(**base, use_fused_preproc=True), recording, num_frames, model, predictor, "cuda"
        )
    launches = crop_letterbox_views.launches
    n_cycles = params.n_logged_cycles(num_frames)
    if launches != 2 * n_cycles:
        raise AssertionError(f"crop_letterbox launched {launches} times in {n_cycles} cycles, expected 2 per cycle")

    # -- 6. the plain branch, in bfloat16 and in float32 -------------------
    crop_letterbox_views.launches = 0
    logs_p, secs_p = run_loop(
        params, LiveLoopConfig(**base, use_fused_preproc=False), recording, num_frames, model, predictor, "cuda"
    )
    if crop_letterbox_views.launches != 0:
        raise AssertionError("the plain branch launched the kernel")
    # in bfloat16 the two branches round at different places (the plain
    # letterbox rounds between its two passes, the kernel once at the store),
    # so a rounded move may differ by a pixel and the tracks by a few
    pos_bf16, box_bf16 = log_diffs(logs_k, logs_p)
    log(f"bf16 kernel vs plain loop: positions differ by <= {pos_bf16} px, boxes by <= {box_bf16} px")
    if not (pos_bf16 <= 2 and box_bf16 <= 2.0):
        raise AssertionError(f"bf16 kernel and plain loops drifted apart: {pos_bf16} px, {box_bf16} px")

    # in float32 both branches compute the same numbers up to summation order:
    # the tracks must be identical and the boxes agree to 1e-2 px
    model32 = YoloV8Detector.load(str(CHECKPOINT), imgsz=imgsz, device="cuda").fuse().model
    crop_letterbox_views.launches = 0
    logs_k32, _ = run_loop(
        params, LiveLoopConfig(**base, use_fused_preproc=True), recording, num_frames, model32, predictor, "cuda"
    )
    if crop_letterbox_views.launches != 2 * n_cycles:
        raise AssertionError(f"the float32 kernel loop launched {crop_letterbox_views.launches} kernels")
    logs_p32, _ = run_loop(
        params, LiveLoopConfig(**base, use_fused_preproc=False), recording, num_frames, model32, predictor, "cuda"
    )
    for logs in (logs_k, logs_p, logs_k32, logs_p32):
        if logs.positions.shape != (n_cycles, params.cycle_n, 2) or logs.worm_bboxes.shape != (n_cycles, params.cycle_n, 4):
            raise AssertionError(f"log shapes {tuple(logs.positions.shape)} {tuple(logs.worm_bboxes.shape)}")
    np.testing.assert_array_equal(logs_k32.positions.numpy(), logs_p32.positions.numpy())
    np.testing.assert_allclose(logs_k32.worm_bboxes.numpy(), logs_p32.worm_bboxes.numpy(), atol=1e-2, equal_nan=True)
    _, box_f32 = log_diffs(logs_k32, logs_p32)
    log(f"f32 kernel vs plain loop: positions identical, boxes differ by <= {box_f32} px")

    # more bf16 runs in turns (plain, kernel, kernel, plain) for the loop's
    # throughput: the host's clock varies from run to run
    cfg_k, cfg_p = LiveLoopConfig(**base, use_fused_preproc=True), LiveLoopConfig(**base, use_fused_preproc=False)
    secs = {"kernel": [secs_k], "plain": [secs_p]}
    for branch in ("plain", "kernel", "kernel", "plain"):
        cfg = cfg_k if branch == "kernel" else cfg_p
        secs[branch].append(run_loop(params, cfg, recording, num_frames, model, predictor, "cuda")[1])
    # loops run once more under torch.profiler with --profile, after every
    # timed phase, so that no timed phase runs beside the profiler's state
    to_profile = {
        b: (lambda c=c: run_loop(params, c, recording, num_frames, model, predictor, "cuda")[1])
        for b, c in (("kernel", cfg_k), ("plain", cfg_p))
    }

    quality = tracking_quality(params, logs_k, recording)
    log(f"tracking: {quality}")
    check_tracking(quality, cam)

    # the card's bfloat16 detector against the float32 detector on the CPU,
    # on four views centred on the worm
    cpu_model = YoloV8Detector.load(str(CHECKPOINT), imgsz=imgsz, device="cpu").fuse().model
    views = np.stack([recording.view(f, cam) for f in (0, 150, 300, 450)])
    with torch.inference_mode():
        ref = detect_top1(cpu_model, torch.from_numpy(views), (imgsz, imgsz), 0.1).numpy()
        got = detect_top1(model, torch.from_numpy(views).cuda(), (imgsz, imgsz), 0.1).cpu().numpy()
    iou_cpu = iou(ref, got)
    log(f"bf16 card vs f32 CPU detector, IoU per view: {iou_cpu.tolist()}")
    if not (np.isfinite(iou_cpu).all() and (iou_cpu >= 0.9).all()):
        raise AssertionError(f"card detector disagrees with the CPU float32 detector: IoU {iou_cpu}")

    # -- 7. the folded stem against the standard detector --------------------
    folded = check_folded_detect(model, model32, cpu_model, recording, cam, imgsz)
    log(f"folded stem: {folded}")

    # -- 8. the video loop at the default fold_stem=None: it folds ----------
    cfg_auto = LiveLoopConfig(**{**base, "fold_stem": None}, use_fused_preproc=True)
    crop_letterbox_views.launches = 0
    with k4_per_forward("phase 8", need=("folded",)) as k4_folded:
        logs_f, secs_f = run_loop(params, cfg_auto, recording, num_frames, model, predictor, "cuda")
    launches_f = crop_letterbox_views.launches
    if launches_f != 0:
        raise AssertionError(f"the folded video loop launched crop_letterbox {launches_f} times")
    secs_f = [secs_f] + [run_loop(params, cfg_auto, recording, num_frames, model, predictor, "cuda")[1] for _ in range(2)]
    quality_f = tracking_quality(params, logs_f, recording)
    log(f"folded video loop tracking: {quality_f}")
    check_tracking(quality_f, cam)
    pos_fk, box_fk = log_diffs(logs_f, logs_k)
    to_profile["folded"] = lambda: run_loop(params, cfg_auto, recording, num_frames, model, predictor, "cuda")[1]
    del model32, cpu_model

    # -- 9. the synthetic flagship loop --------------------------------------
    model32 = YoloV8Detector.load(str(CHECKPOINT), imgsz=imgsz, device="cuda").fuse().model
    synthetic, to_profile["synthetic"], flagship = synthetic_loop(model32)
    del model32
    torch.cuda.empty_cache()

    # -- 10. the 40 ms decision ----------------------------------------------
    with k4_per_forward("phase 10") as k4_decisions:
        decisions = [decision_latency(flagship, s) for s in (1, 4)]
    del flagship
    for d in decisions:
        log(f"decision S={d['streams']}: host {d['e2e']} device {d['device']} (budget {d['budget_ms']} ms)")

    # -- 11. ROI streaming ---------------------------------------------------
    model32 = YoloV8Detector.load(str(CHECKPOINT), imgsz=imgsz, device="cuda").fuse().model
    roi = roi_loop(
        params, base, recording, num_frames, {"bf16": model, "f32": model32}, predictor,
        {"bf16": logs_k, "f32": logs_k32, "folded": logs_f},
    )
    log(f"ROI streaming: {roi['cycles_per_s']}")
    to_profile["roi"] = lambda: run_loop(
        params, cfg_k, recording, num_frames, model, predictor, "cuda", window_source=recording.windows,
        roi_window=ROI_WINDOWS[0], roi_chunk_cycles=ROI_CHUNK_CYCLES,
    )[1]

    # -- 12. the track_video command over BMP frames ---------------------------
    # the BMPs stay for the int8 phases; the directory goes at the end (or
    # when the interpreter exits after a failed phase)
    bmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_bmp_")
    bmp = Path(bmp_dir.name)
    timing_path = ROOT / "configs" / "timing_config.json"
    cli = track_video_cli(params, recording, cam, CHECKPOINT, timing_path, bmp)
    log(f"track_video: whole frames {cli['whole_frames_wall_s']:.1f} s, ROI {cli['roi_wall_s']:.1f} s")

    # -- 13. the multi-recording loop --------------------------------------------
    streams, stream_runs = video_streams(params, base, {"f32": model32, "bf16": model}, predictor)
    log(f"video streams: {streams['stream_cycles_per_s']:.2f} stream-cycles/s")

    # -- 14. replay through the four controllers, and the simulate command ------
    # (its worm log, engine texts and predictor stay for phases 23 and 25)
    replay_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_replay_")
    replay_tmp = Path(replay_dir.name)
    k3_log, k3_build_s = k3_report.result()
    k3_build.shutdown()
    log_nvcc(k3_log)
    k3_regs = k3_ptxas(k3_log.get("polyfit_f64", ""))
    log(f"built K3 in {k3_build_s:.1f} s, beside phases 3-13; ptxas: {k3_regs}")
    k3_spills = [r for r in k3_regs if r["form"] != "general" and (r["spill_stores"] or r["spill_loads"])]
    if k3_spills:  # the register and the wave form's instantiations spill nothing (the general form is not held to it)
        raise AssertionError(f"K3 instantiations spill: {k3_spills}")
    k3_before_replay = hand_kernel_launches()["polyfit"]
    if k3_before_replay:
        raise AssertionError(f"phases 1-13 launched K3 {k3_before_replay} times")
    replayed, profiled, fits = replay(replay_tmp)
    to_profile.update(profiled)
    log(f"replay: {({k: round(v['cycles_per_s'], 1) for k, v in replayed['controllers'].items()})} cycles/s")

    # -- 41. K3 against its plain version, and its times -------------------------
    k3_parent = Path(sys.argv[sys.argv.index("--k3-parent") + 1]) if "--k3-parent" in sys.argv else None
    cpu_deg8 = start_cpu_polyfit(replay_tmp, high_deg=True)  # the deg 8 replay's CPU side, beside the checks
    parent_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_k3_parent_")
    try:
        old_k3 = parent_polyfit(k3_parent, Path(parent_dir.name)) if k3_parent is not None else None
        k3 = check_polyfit_kernel(fits, replay_tmp, old_k3)
        del fits
        log(f"K3: {k3['cases']} cases {k3['cases_by_form']}, {k3['differing_bits']} differing of "
            f"{k3['coefficients_compared']}; " + str({
                f"{k}{deg}": {m: v.get(m) for m in ('ms', 'plain_ms', 'library_ms', 'lstsq_ms', 'bound_ms', 'turns_ms',
                                                    'wave')}
                for deg, t in ((2, k3['times']), (HIGH_DEG, k3['times_deg8'])) for k, v in t.items()}
                | {f"{k}{deg}": {m: v.get(m) for m in ('ms', 'library_ms', 'lstsq_ms', 'bound_ms', 'turns_ms')}
                   for k, t in k3['times_deg3_7'].items() for deg, v in t.items()}))
        k3_high = polyfit_high_degree(replay_tmp, ROOT / "configs" / "timing_config.json", cpu_deg8, old_k3)
    finally:
        stop_child(cpu_deg8)
        parent_dir.cleanup()
    log(f"deg {HIGH_DEG}: {k3_high}")
    zero_hand_kernel_launches()

    # -- 15. sweeps: the sweep command over exp0-exp4, S streams in process ------
    swept = sweep(replay_tmp)
    log(f"sweep: {swept['stream_cycles_per_s']:.0f} stream-cycles/s at S={swept['streams']}")

    # -- 36. the sweep command with --mesh 2 (two slots on the card) ------------
    t0 = time.perf_counter()
    swept_mesh = sweep_mesh(replay_tmp)
    scale_out_s = time.perf_counter() - t0
    log(f"sweep --mesh 2: {swept_mesh['main_s']:.1f} s, files equal to phase 15's")

    # -- 16. the live loop over mixed camera geometries --------------------------
    hetero, to_profile["hetero_live"] = hetero_live({"bf16": model, "f32": model32}, predictor)
    log(f"mixed-geometry live loop: {hetero['steps_per_s']:.0f} steps/s")
    del model32
    torch.cuda.empty_cache()

    # -- 17. the quantize_detector command on phase 12's BMPs --------------------
    from wtracker_tpu_torch.models.yolov8_int8 import QuantizedYolo

    quantized, artifact = quantize_cli(bmp, timing_path)
    q = QuantizedYolo.load(artifact)
    qw = q.device_weights("cuda")
    log(f"quantize_detector: {quantized['wall_s']:.1f} s, {len(q.qweights)} convs")

    # -- 18. K2 against its plain version at every conv shape of a forward -------
    k2 = check_conv_s8(q, qw, recording, cam, imgsz, params.imaging_n)
    log(f"K2: {k2['distinct_shapes']} shapes, forward sum {k2['forward_sum_ms']:.3f} ms "
        f"(plain {k2['forward_sum_plain_ms']:.3f}, bound {k2['forward_sum_bound_ms']:.4f}), "
        f"silu_q off by one {k2['silu_q_off_by_one']} of {k2['silu_q_checked']}")

    # -- 19. the int8 video loop, folded and through K1 ---------------------------
    int8_loops, int8_runs = int8_video_loops(params, base, recording, num_frames, q, qw, predictor, cam, imgsz)
    to_profile.update({f"int8_{k}": v for k, v in int8_runs.items()})
    k2_launches = int8_loops["folded"]["conv_s8_launches"]

    # -- 20. int8 against bf16 top-1 drift on held-out views ---------------------
    drift = int8_drift(model, q, qw, recording, cam, imgsz)
    log(f"int8 vs bf16 drift: {drift}")

    # -- 21. the synthetic loop with the int8 folded detect -----------------------
    int8_synth, to_profile["int8_synthetic"], k2_360 = int8_synthetic(q, qw, predictor, synthetic["steps_per_s"])
    log(f"int8 synthetic loop: {int8_synth['steps_per_s']:.0f} steps/s (bf16 {synthetic['steps_per_s']:.0f})")
    log(f"K2 at {k2_360['views']} views: {k2_360['distinct_shapes']} shapes, forward sum {k2_360['forward_sum_ms']:.3f} ms "
        f"(bound {k2_360['forward_sum_bound_ms']:.4f}), silu_q off by one {k2_360['silu_q_off_by_one']} "
        f"of {k2_360['silu_q_checked']}")
    k2["n360"] = k2_360

    k3_phases_15_21 = hand_kernel_launches()["polyfit"]  # in this process; the commands count their own
    if k3_phases_15_21:
        raise AssertionError(f"phases 15-21 launched K3 {k3_phases_15_21} times")

    # -- 22. track_video with the int8 artifact, beside phase 23's commands ----------
    # -- 23. the host simulator backend: simulate --backend host -------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        int8_run = pool.submit(int8_track_video_cli, params, recording, cam, bmp, artifact, timing_path)
        host = host_replay(replay_tmp)
        int8_cli = int8_run.result()
    log(f"track_video int8: {int8_cli['wall_s']:.1f} s")

    # -- 24. the live host loop with YOLO at full width -----------------------------
    host_yolo = host_yolo_loop(params, recording, bmp, timing_path)
    log(f"host YOLO loop: {host_yolo['cycles_per_s']:.2f} cycles/s (median of {HOST_YOLO_RUNS}, "
        f"{host_yolo['cycles_per_s_range'][0]:.2f}-{host_yolo['cycles_per_s_range'][1]:.2f}; warm-up run "
        f"{host_yolo['warm_up']['cycles_per_s']:.2f}), decisions detected "
        f"{host_yolo['decision_detection_rate']:.3f}, median centre error {host_yolo['median_center_err_px']:.2f} px")

    # -- 25. .pt detectors and the weight evaluator on the card ----------------------
    pt = pt_detectors(params, recording, bmp, replay_tmp, timing_path)
    log(f".pt detector: track_video {pt['track_video_wall_s']:.1f} s, WeightEvaluator.eval {pt['weight_eval_ms']:.1f} ms")
    host_phases_s = time.perf_counter() - t0

    # -- 26. dataset tools at the deployment size -------------------------------------
    t0 = time.perf_counter()
    dataset = dataset_tools((H, W))
    log(f"dataset tools: background {dataset['background_s']:.2f} s over {dataset['probes']} probes, boxes "
        f"{dataset['frames_per_s']:.1f} frames/s ({dataset['floods_per_chunk']:.1f} floods a chunk), one chunk's "
        f"stages {dataset['chunk_split']}")

    # -- 42. the recipe killed and resumed on the card, beside phases 27-29 ------------
    resume_started = time.perf_counter()
    resume_child = start_resume(bmp)

    # -- 27. initialize_experiment, classical and yolo (phase 28's command beside) ------
    with ThreadPoolExecutor(1) as pool:
        sampled = pool.submit(run_cli, "create_yolo_images", create_yolo_images_args(bmp))
        init_cli = initialize_experiment_cli(recording, bmp)
        log(f"initialize_experiment: classical {init_cli['classical_wall_s']:.1f} s, "
            f"yolo@{YOLO_INIT_IMGSZ} {init_cli[f'yolo{YOLO_INIT_IMGSZ}']}")

        # -- 28. create_yolo_images ---------------------------------------------------------
        samples = create_yolo_images_cli(recording, bmp, sampled.result())
    log(f"create_yolo_images: {samples['wall_s']:.1f} s")

    # -- 29. evaluation: analysis, the batched precise error, visualize -----------------
    evaluated = evaluation(recording, bmp, replay_tmp, timing_path)
    log(f"evaluation: analysis {evaluated['analysis_cuda_wall_s']:.1f} s, precise error "
        f"{evaluated['precise_rows_per_s']:.0f} rows/s, visualize {evaluated['visualize_wall_s']:.1f} s, "
        f"plots {evaluated['plots']}")
    dataset_phases_s = time.perf_counter() - t0
    new_launches = [p["launches"] for p in (dataset, init_cli, samples, evaluated)]
    resumed = finish_resume(resume_child, bmp, resume_started)
    log(f"yolo_training resume: {resumed}")
    bmp_dir.cleanup()

    # -- 30. predictor_training over phase 14's log ------------------------------------
    profile = "--profile" in sys.argv
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # phase 31's command beside phase 30's
        tuned = pool.submit(run_cli, "polyfit_optimizer", polyfit_optimizer_args(replay_tmp, timing_path))
        pred_train = predictor_training_phase(replay_tmp)
        log(f"predictor_training: {pred_train['samples_per_s']:.0f} samples/s, {np.median(pred_train['epoch_s']):.2f} s "
            f"an epoch, first-epoch losses card vs CPU: float32 {pred_train['first_epoch_float32']}, float64 "
            f"{pred_train['first_epoch_float64']}, float64 CPU nudged by an ulp "
            f"{pred_train['first_epoch_float64_cpu_nudged']}, command {pred_train['command_wall_s']:.1f} s")

        # -- 31. polyfit_optimizer over phase 14's log ---------------------------------------
        pso = polyfit_optimizer_phase(replay_tmp, timing_path, tuned.result())
    log(f"polyfit_optimizer: {pso['ms_per_epoch']:.2f} ms an epoch (CPU {pso['cpu_ms_per_epoch']:.1f}), "
        f"command {pso['command_wall_s']:.1f} s, MAE {pso['mae_uniform_tuned']}")
    replay_dir.cleanup()

    # -- 32. yolo_training at full width --------------------------------------------------
    yolo_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_yolo_")
    yolo, profiled = yolo_training_phase(Path(yolo_dir.name), profile)
    to_profile.update(profiled)

    # -- 37. the data-parallel detector step, and yolo_training --dp --------------
    t1 = time.perf_counter()
    dp = dp_steps(Path(yolo_dir.name))
    dp_s = time.perf_counter() - t1
    yolo_dir.cleanup()
    log(f"data-parallel step: float64 {dp['f64']}, float32 steps {dp['f32_steps']}, "
        f"command ranks {dp['command']['rank_s']} s")
    log(f"yolo_training: {yolo['steps_per_s']:.2f} steps/s, {yolo['images_per_s']:.0f} images/s, "
        f"epoch {yolo['epoch_s']:.2f} s, validation {yolo['validation_s']:.2f} s, peak memory "
        f"{yolo['peak_memory_bytes'] / 2**30:.1f} GiB, losses {[e['loss'] for e in yolo['epochs']]}, "
        f"step card vs CPU {yolo['step_check']}")

    # -- 33. neither hand kernel on the training paths but K3 in the swarm (asserted) --------
    training_phases_s = time.perf_counter() - t0 - dp_s
    training_launches = [p["launches"] for p in (pred_train, pso, yolo)]

    # -- 34. the multi-recording loop sharded over two slots of the card ----------
    t0 = time.perf_counter()
    sharded = sharded_video(params, base, model, predictor, stream_runs)
    log(f"sharded video: {({r: sharded[r]['stream_cycles_per_s'] for r in ('k1', 'folded')})} stream-cycles/s")

    # -- 35. the int8 serving loop through run_engine_sharded ---------------------
    sharded8 = sharded_int8(q, qw, predictor)
    log(f"sharded int8 loop: {sharded8['steps_per_s']:.0f} steps/s, K2 {sharded8['conv_s8_launches']}")
    scale_out_s += time.perf_counter() - t0 + dp_s

    # -- 38. the detector's gates ---------------------------------------------------
    t0 = time.perf_counter()
    gated = detector_gates()
    log(f"gates: {({k: (r['status'], r['seconds']) for k, r in gated['gates'].items()})}, launches {gated['launches']}")

    # -- 39. the trace tool on the synthetic loop -------------------------------------
    traced = trace_tool()
    tools_s = time.perf_counter() - t0
    log(f"trace_profile: busy share {traced['device_busy_share']:.3f}, {traced['busy_ms_per_cycle']:.2f} ms a cycle; "
        f"phases 38-39 {tools_s:.1f} s")

    # -- 40. the bench and the video bench ----------------------------------------
    t0 = time.perf_counter()
    benched = bench_tools()
    bench_s = time.perf_counter() - t0
    log(f"bench: bf16 {benched['bench']['value']} steps/s, int8 {benched['bench']['int8']['value']}, "
        f"launches {benched['launches']}; video {benched['video']['whole']['value']} steps/s, ROI "
        f"{benched['video']['roi']['value']}; phase 40 {bench_s:.1f} s")

    if profile:
        from wtracker_tpu_torch.tools.trace_profile import profile_run

        profiles = {name: profile_run(run) for name, run in to_profile.items()}
    else:
        profiles = {}

    # -- results ---------------------------------------------------------------
    t12, t3 = times[params.imaging_n], times[params.moving_n]
    k3r, k3s = k3["times"]["replay"], k3["times"]["swarm"]
    k3r8, k3s8 = k3["times_deg8"]["replay"], k3["times_deg8"]["swarm"]
    kernels = {
        "kernels": [
            {
                "name": "crop_letterbox",
                "route": "cuda",
                "source": "wtracker_tpu_torch/csrc/crop_letterbox.cu",
                "replaces": "wtracker_tpu/ops/pallas_preproc.py:198",
                "launches": launches,
                "max_abs_err": errs[torch.bfloat16],
                "ms": t12["ms"],
                "plain_ms": t12["plain_ms"],
                "bound_ms": t12["bound_ms"],
                "bound_by": t12["bound_by"],
                "library_ms": t12["library_ms"],
                "views": params.imaging_n,
                "max_abs_err_f32": errs[torch.float32],
                "bound_share": t12["bound_ms"] / t12["ms"],
                "host_ms": t12["host_ms"],
                "ms_n3": t3["ms"],
                "plain_ms_n3": t3["plain_ms"],
                "bound_ms_n3": t3["bound_ms"],
                "library_ms_n3": t3["library_ms"],
                "bound_share_n3": t3["bound_ms"] / t3["ms"],
                "host_ms_n3": t3["host_ms"],
                "empty_kernel_ms": t12["empty_kernel_ms"],
                "ms_l2_warm": t12["ms_l2_warm"],
                "ms_n3_l2_warm": t3["ms_l2_warm"],
                "launches_per_cycle": launches / n_cycles,
                "launches_roi": {k: r["crop_letterbox_launches"] for k, r in roi["runs"].items()},
                "launches_replay_sweep_hetero": [
                    replayed["crop_letterbox_launches"], swept["crop_letterbox_launches"], hetero["crop_letterbox_launches"]
                ],
                "launches_int8_unfolded_per_cycle": int8_loops["unfolded_k1"]["crop_letterbox_launches"] / n_cycles,
                "launches_int8_folded": int8_loops["folded"]["crop_letterbox_launches"],
                "launches_host_yolo_pt": [host_yolo["launches"]["crop_letterbox"], pt["launches"]["crop_letterbox"]],
                "launches_phases_26_29": [p["crop_letterbox"] for p in new_launches],
                "launches_phases_30_32": [p["crop_letterbox"] for p in training_launches],
                "launches_sharded_video_per_slot": sharded["k1"]["crop_letterbox_launches_per_slot"],
                "launches_sharded_folded_int8_sweep": [
                    sharded["folded"]["crop_letterbox_launches"], sharded8["crop_letterbox_launches"], 0
                ],
                "launches_data_parallel": [dp["launches"]["crop_letterbox"], dp["command"]["launches"]["crop_letterbox"]],
                "launches_gates": gated["launches"]["crop_letterbox"],
                "launches_bench_video": [benched["launches"]["crop_letterbox"], benched["video_launches"]["crop_letterbox"]],
            },
            {
                # one int8 forward at N=12 views: the sum over its 63 convolutions
                # of each shape's time (L2 flushed before each call)
                "name": "conv_s8",
                "route": "cuda",
                "source": "wtracker_tpu_torch/csrc/conv_s8.cu",
                "replaces": "wtracker_tpu/models/yolov8_int8.py:59",
                "launches": k2_launches,
                "max_abs_err": max(k2["max_abs_err"], k2_360["max_abs_err"]),
                "ms": k2["forward_sum_ms"],
                "plain_ms": k2["forward_sum_plain_ms"],
                "bound_ms": k2["forward_sum_bound_ms"],
                "bound_by": "operations" if k2["forward_ops_bound_ms"] >= k2["forward_bytes_bound_ms"] else "bytes",
                "library_ms": None,
                "views": params.imaging_n,
                "bound_share": k2["forward_sum_bound_ms"] / k2["forward_sum_ms"],
                "silu_q_off_by_one": k2["silu_q_off_by_one"] + k2_360["silu_q_off_by_one"],
                "silu_q_checked": k2["silu_q_checked"] + k2_360["silu_q_checked"],
                "views_checked": [params.imaging_n, k2_360["views"]],
                "ms_n360": k2_360["forward_sum_ms"],
                "bound_ms_n360": k2_360["forward_sum_bound_ms"],
                "int8_forward_ms": k2["int8_forward_ms"],
                "kernel_1x1_sum_ms": k2["kernel_1x1_sum_ms"],
                "library_1x1_sum_ms": k2["library_1x1_sum_ms"],
                "launches_per_cycle": {k: int8_loops[k]["conv_s8_launches_per_cycle"] for k in ("folded", "unfolded_k1")},
                "launches_synthetic_per_run": int8_synth["conv_s8_launches_per_run"],
                "launches_host_yolo_pt": [host_yolo["launches"]["conv_s8"], pt["launches"]["conv_s8"]],
                "launches_phases_26_29": [p["conv_s8"] for p in new_launches],
                "launches_phases_30_32": [p["conv_s8"] for p in training_launches],
                "launches_sharded_int8": sharded8["conv_s8_launches"],
                "launches_data_parallel": [dp["launches"]["conv_s8"], dp["command"]["launches"]["conv_s8"]],
                "launches_gates": {k: gated["gates"][k]["launches"]["conv_s8"] for k in ("trained_int8_drift", "int8_drift_s416")},
                "launches_bench": benched["launches"]["conv_s8"],
                "design": k2_design(),
                "sass": k2_sass,
                "classes": k2["classes"],
                "classes_n360": k2_360["classes"],
            },
            {
                # one fit of the polyfit replay's decision: one weighting of
                # N=5 samples, deg 2, M=2 (L2 flushed before each call)
                "name": "polyfit_f64",
                "route": "cuda",
                "source": "wtracker_tpu_torch/csrc/polyfit_f64.cu",
                "replaces": "wtracker_tpu/ops/polyfit.py:106",
                "launches": replayed["controllers"]["polyfit"]["launches"]["polyfit"],
                "max_abs_err": k3["max_abs_err"],
                "ms": k3r["ms"],
                "plain_ms": k3r["plain_ms"],
                "bound_ms": k3r["bound_ms"],
                "bound_by": k3r["bound_by"],
                "library_ms": k3r["library_ms"],
                "library": "torch.linalg.eigh of the same normal matrices (the eigendecomposition alone)",
                "lstsq_ms": k3r["lstsq_ms"],
                "lstsq_ms_swarm": k3s["lstsq_ms"],
                "lstsq": "torch.linalg.lstsq, driver gels, of the same scaled systems: the whole fit, full-rank inputs only",
                "turns_ms": k3r.get("turns_ms"),
                "turns_ms_swarm": k3s.get("turns_ms"),
                "ptxas": k3_regs,
                "plan_swarm": k3s["plan"],
                "differing_bits": k3["differing_bits"],
                "coefficients_compared": k3["coefficients_compared"],
                "empty_kernel_ms": k3r["empty_kernel_ms"],
                "launches_per_cycle": replayed["controllers"]["polyfit"]["launches"]["polyfit"] / replayed["cycles"],
                "ms_swarm": k3s["ms"],
                "plain_ms_swarm": k3s["plain_ms"],
                "library_ms_swarm": k3s["library_ms"],
                "bound_ms_swarm": k3s["bound_ms"],
                "swarm_shape": {k: k3s[k] for k in ("p", "n", "deg", "m")},
                # deg 8: K3's wave form at the replay's shape (11 sample times) and the swarm's
                "ms_deg8": k3r8["ms"],
                "plain_ms_deg8": k3r8["plain_ms"],
                "library_ms_deg8": k3r8["library_ms"],
                "bound_ms_deg8": k3r8["bound_ms"],
                "ms_swarm_deg8": k3s8["ms"],
                "plain_ms_swarm_deg8": k3s8["plain_ms"],
                "library_ms_swarm_deg8": k3s8["library_ms"],
                "bound_ms_swarm_deg8": k3s8["bound_ms"],
                "swarm_shape_deg8": {k: k3s8[k] for k in ("p", "n", "deg", "m")},
                "lstsq_ms_deg8": k3r8["lstsq_ms"],
                "lstsq_ms_swarm_deg8": k3s8["lstsq_ms"],
                "turns_ms_deg8": k3r8.get("turns_ms"),
                "turns_ms_swarm_deg8": k3s8.get("turns_ms"),
                "wave_deg8": k3r8.get("wave"),
                "plan_swarm_deg8": k3s8["plan"],
                "cases_by_form": k3["cases_by_form"],
                "launches_deg8_replay": k3_high["k3_launches_replay"],
                "launches_deg8_command": k3_high["command_k3_launches"],
                "launches_swarm_in_process": pso["k3_launches_in_process"],
                "launches_swarm_command": pso["command_k3_launches"],
                "launches_weight_eval": pt["weight_eval_launches"]["polyfit"],
                "launches_phases_1_13": k3_before_replay,
                "launches_other_replay_controllers": {
                    k: v["launches"]["polyfit"] for k, v in replayed["controllers"].items() if k != "polyfit"
                },
                "launches_phases_15_21": k3_phases_15_21,
                "launches_host_yolo_pt": [host_yolo["launches"]["polyfit"], pt["launches"]["polyfit"]],
                "launches_phases_26_29": [p["polyfit"] for p in new_launches],
                "launches_phases_30_32": [p["polyfit"] for p in training_launches],
                "launches_data_parallel": [dp["launches"]["polyfit"], dp["command"]["launches"]["polyfit"]],
                "launches_gates": gated["launches"]["polyfit"],
                "launches_bench_video": [benched["launches"]["polyfit"], benched["video_launches"]["polyfit"]],
            },
        ]
    }
    loop = {
        "loop": {
            "cycles": n_cycles,
            "frames": n_cycles * params.cycle_n,
            "kernel_cycles_per_s": n_cycles / float(np.median(secs["kernel"])),
            "plain_cycles_per_s": n_cycles / float(np.median(secs["plain"])),
            "kernel_s": secs["kernel"],
            "plain_s": secs["plain"],
            "bf16_pos_max_abs_diff_kernel_vs_plain": pos_bf16,
            "bf16_box_max_abs_diff_kernel_vs_plain": box_bf16,
            "f32_box_max_abs_diff_kernel_vs_plain": box_f32,
            **quality,
            "k4": k4_video,
            "build_s": build_s,
            "k3_build_s": k3_build_s,
            "card": card,
        }
    }
    video_folded = {
        "video_loop_folded": {
            "crop_letterbox_launches": launches_f,
            "k4": k4_folded,
            "cycles_per_s": n_cycles / float(np.median(secs_f)),
            "run_s": secs_f,
            "bf16_pos_max_abs_diff_vs_kernel_loop": pos_fk,
            "bf16_box_max_abs_diff_vs_kernel_loop": box_fk,
            **quality_f,
        }
    }
    print(json.dumps(kernels))
    print(json.dumps({"bias_silu": {**k4, "card": card}}))
    print(json.dumps(loop))
    print(json.dumps({"folded_detect": folded}))
    print(json.dumps(video_folded))
    print(json.dumps({"synthetic_loop": synthetic}))
    print(json.dumps({"decision_latency": decisions, "k4": k4_decisions}))
    print(json.dumps({"roi_video_loop": roi}))
    print(json.dumps({"track_video_cli": cli}))
    print(json.dumps({"video_streams": streams}))
    print(json.dumps({"replay": {**replayed, "card": card}}))
    print(json.dumps({"sweep": {**swept, "card": card}}))
    print(json.dumps({"hetero_live": {**hetero, "card": card}}))
    print(json.dumps({"quantize_cli": {**quantized, "card": card}}))
    print(json.dumps({"conv_s8": {**k2, "card": card}}))
    print(json.dumps({"int8_video_loop": {**int8_loops, "card": card}}))
    print(json.dumps({"int8_drift": {**drift, "card": card}}))
    print(json.dumps({"int8_synthetic_loop": {**int8_synth, "card": card}}))
    print(json.dumps({"int8_track_video_cli": {**int8_cli, "card": card}}))
    print(json.dumps({"host_replay": {**host, "card": card}}))
    print(json.dumps({"host_yolo_loop": {**host_yolo, "card": card}}))
    print(json.dumps({"pt_detector": {**pt, "phases_23_25_s": host_phases_s, "card": card}}))
    print(json.dumps({"dataset_tools": {**dataset, "card": card}}))
    print(json.dumps({"initialize_experiment_cli": {**init_cli, "card": card}}))
    print(json.dumps({"create_yolo_images_cli": {**samples, "card": card}}))
    print(json.dumps({"evaluation": {**evaluated, "phases_26_29_s": dataset_phases_s, "card": card}}))
    print(json.dumps({"predictor_training": {**pred_train, "card": card}}))
    print(json.dumps({"polyfit_optimizer": {**pso, "card": card}}))
    print(json.dumps({"yolo_training": {**yolo, "phases_30_33_s": training_phases_s, "card": card}}))
    print(json.dumps({"sharded_video": {**sharded, "card": card}}))
    print(json.dumps({"sharded_int8": {**sharded8, "card": card}}))
    print(json.dumps({"sweep_mesh": {**swept_mesh, "card": card}}))
    print(json.dumps({"data_parallel": {**dp, "phases_34_37_s": scale_out_s, "card": card}}))
    print(json.dumps({"detector_gates": {**gated, "card": card}}))
    print(json.dumps({"trace_profile": {**traced, "phases_38_39_s": tools_s, "card": card}}))
    print(json.dumps({"bench_tools": {**benched, "phase_40_s": bench_s, "card": card}}))
    print(json.dumps({"polyfit_kernel": {**k3, "high_degree": k3_high, "card": card}}))
    print(json.dumps({"yolo_resume": {**resumed, "card": card}}))
    if profile:
        print(json.dumps({"profile": {**profiles, "card": card}}))
    print(json.dumps({"smoke": {"script_s": time.perf_counter() - t_start, "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 37, started by the script itself
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] in (["--cpu-polyfit"], ["--cpu-polyfit-deg8"]):  # a CPU polyfit replay of phase 14 or 41
        sys.exit(cpu_polyfit_replay(sys.argv[2], high_deg=sys.argv[1] == "--cpu-polyfit-deg8"))
    if sys.argv[1:2] == ["--resume-worker"]:  # phase 42's deterministic runs, started by the script itself
        sys.exit(resume_worker(sys.argv[2]))
    sys.exit(main())
