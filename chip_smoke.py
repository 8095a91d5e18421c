#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wtracker_tpu_torch``) on one NVIDIA card.

Drives the port's main paths, the real-video tracking loop and the synthetic
live loop over many streams, at full width:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every hand-written kernel from ``wtracker_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), prints the compiler's
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
   just after;
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
   stem for the BN-fused detector and so launches the kernel 0 times;
9. runs the synthetic flagship loop at the JAX package's bench
   configuration (``bench.py``: S=96 streams, 360 px camera, 4 detect
   sub-batches a cycle), cut to 12 cycles: one warm-up and three timed
   runs, held to the trained-tracking bar; and in float32 at S=4 the folded
   and standard stems give the same tracks;
10. times the standalone 40 ms decision (``make_decision_step``) at S=1 and
    S=4, 200 decisions each, host to synchronise and by CUDA events;
11. runs ROI streaming (``roi_window``) over the same recording at 480 and
    364 px (4 px of slack: chunks replay), through the kernel in bfloat16
    and float32 and at the default ``fold_stem=None``: each run bit-identical
    to the whole-frame loop of steps 5, 6 and 8, the kernel launched 2 times
    a cycle plus 2 per replayed cycle; then ROI and whole-frame cycles/s in
    turns;
12. writes the recording's first 16 cycles as 8-bit BMPs (numpy writer: the
    card's host need not have OpenCV) into a temporary directory, reads them back
    with the port's ``FrameReader`` byte for byte, and runs ``python -m
    wtracker_tpu_torch.workflows.track_video`` on them with the trained
    checkpoint, whole-frame and with ``--roi 480``: the two ``bboxes.csv``
    files must be the same text and hold the tracking bar;
13. runs ``run_video_live_sharded`` over 4 seeded recordings at full width
    (8 cycles in chunks of 4), each stream held against its own
    ``run_video_live`` (float32: positions exact, boxes to 1e-2 px;
    bfloat16: within 2 px), and its stream-cycles/s;
14. replays a seeded 61,200-frame worm log at the deployment configuration
    (4,079 cycles) through the csv, optimal, polyfit and mlp controllers and
    the step motor (cycles/s each), polyfit once more through ``python -m
    wtracker_tpu_torch.workflows.simulate``, and every run once more on the
    CPU: the same ``bboxes.csv`` text (mlp: equal positions in >= 99.9 %
    of frames, none more than 2 px apart);
15. runs ``python -m wtracker_tpu_torch.workflows.sweep`` over
    configs/exp0-exp4 (mixed geometry, each at its own length), each
    experiment equal to its single-stream run, then 96 streams of the
    deployment configuration in one batch (stream-cycles/s);
16. runs the live YOLOv8s@416 + ResMLP loop over 30 streams of exp0-exp4's
    three camera sizes (``yolo_mlp_controller_hetero``, 12 cycles): steps/s,
    0 K1 launches, every stream held to the tracking bar, and in float32 the
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
    (2 K1 launches a cycle, 63 K2 a forward), each held to the tracking bar;
20. measures the int8 folded detector's top-1 drift from the bf16 one on 48
    held-out views (median <= 1 px, >= 75 % within 8 px);
21. runs phase 9's synthetic loop with the int8 folded detect (steps/s beside
    phase 9's bf16 steps/s; 62 K2 launches a forward), and holds K2 against
    its plain version at every convolution shape of one of its 360-view
    forwards, as phase 18 does at 12 views;
22. runs ``track_video`` with the int8 artifact on the BMPs, held to the
    tracking bar;
23. runs ``python -m wtracker_tpu_torch.workflows.simulate --backend host``
    (the hook-based simulator) over phase 14's worm log, uncut, with the
    csv, optimal, polyfit and mlp controllers (four commands started
    together): each ``bboxes.csv`` is phase
    14's engine text row for row (mlp: differing rows counted, held to
    phase 14's bar), with wall time and the loop's cycles/s;
24. runs the live host loop, ``Simulator`` + ``LoggingController(
    YoloController)``, over phase 12's BMPs with the trained YOLOv8s@416 in
    float32 on the card: >= 95 % of decisions detected, the tracking bar,
    cycles/s, 0 launches of either hand kernel;
25. writes the trained checkpoint as an ultralytics-layout ``.pt`` and
    loads it back (state dict and 12-view logits identical to the ``.npz``
    load's), runs ``track_video --detector X.pt`` on phase 12's BMPs (phase
    12's CSV byte for byte), and times one ``WeightEvaluator.eval`` on the
    card over phase 14's log (the CPU's value exactly).

Prints one JSON line of kernel results, one of loop results, one for each
of steps 7 to 25 (with ``--profile``, one more of ``torch.profiler`` runs of
the loops, made after every timed phase), the card line, and last
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
DECISION_WARMUP = 10
DECISION_REPS = 200
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
# frames (4,079); the simulate command's default polyfit sample times;
# --profile traces a cut of 200 cycles (a polyfit cycle is ~1,500 launches)
REPLAY_POLYFIT_TIMES = (-15, -10, -5, 0, 3)
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# kernels: build, check against the plain version, time
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 50, flush_bytes: int = 64 << 20) -> float:
    """Median device time of ``fn`` in ms, one call per CUDA event pair.

    Before each call a write of more than the 50 MB L2 evicts the inputs (the
    loop finds the frame chunk cold: the detector runs between two
    preprocessing calls), and a spin of about 0.5 ms keeps the card busy
    while the host queues the call, so the host's own overhead does not show
    up as device time.  With ``flush_bytes=0`` the inputs stay in L2 from the
    call before."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush_bytes:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


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


def write_gray_bmp(path, frame: np.ndarray) -> None:
    """Write a (H, W) uint8 frame as an 8-bit BMP with a gray palette, the
    layout OpenCV's ``imwrite`` gives a gray frame (the card's host need not have
    OpenCV): 54 bytes of headers, 256 palette entries, rows bottom-up, each
    padded to a multiple of 4 bytes."""
    h, w = frame.shape
    row_bytes = (w + 3) // 4 * 4
    offset = 14 + 40 + 256 * 4
    header = (
        b"BM" + np.array([offset + row_bytes * h, 0, offset], "<u4").tobytes()
        + np.array([40, w, h], "<i4").tobytes() + np.array([1, 8], "<u2").tobytes()
        + np.array([0, row_bytes * h, 2835, 2835, 256, 0], "<u4").tobytes()
    )
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
    palette[:, 3] = 0
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, :w] = frame[::-1]
    with open(path, "wb") as f:
        f.write(header + palette.tobytes() + rows.tobytes())


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


def profile_run(run, top: int = 12) -> dict:
    """One more run of a loop under ``torch.profiler`` (``run()`` returns its
    wall seconds).  The device's busy time is the union of the intervals of
    its kernels, copies and fills (each counted once; the operators' own
    device-time totals repeat their kernels' time).  Also lists the
    operators and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        wall_s = run()
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"
    )
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)

    def listing(device_type):
        picked = [e for e in rows if e.device_type == device_type][:top]
        return [{"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total * 1e-3} for e in picked]

    return {
        "wall_s": wall_s,
        "device_events": len(spans),
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s,
        "top_ops": listing(DeviceType.CPU),
        "top_kernels": listing(DeviceType.CUDA),
    }


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


def bench_setup():
    """bench.py's geometry: 60 fps, 1400x1600 px arena, 90 px/mm, 4 mm
    camera (360 px), 0.32 mm micro, timing 200/40/50 ms (12 + 3 frames a
    cycle), headless frame bounds; returns (timing, params)."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams, headless_frame_shape

    exp = ExperimentConfig("bench", 60_000, 60, (1400, 1600), 90, (700, 700))
    timing = TimingConfig(
        experiment_config=exp, imaging_time_ms=200.0, pred_time_ms=40.0, moving_time_ms=50.0,
        camera_size_mm=(4.0, 4.0), micro_size_mm=(0.32, 0.32),
    )
    params = EngineParams.from_timing(timing, headless_frame_shape(timing, exp.orig_resolution))
    if not (params.cam_w == params.cam_h == 360 and params.cycle_n == 15):
        raise AssertionError(f"bench geometry changed: {params}")
    return timing, params


def synthetic_quality(params, logs, trajs: np.ndarray) -> dict:
    """tests/test_trained_detector.py's bar, on (C, S, L) logs: detection
    rate, median centre error against the true track, and the share of
    frames after cycle 3 with the worm inside the camera view."""
    pos = logs.positions.cpu().numpy().astype(np.float64)  # (C, S, L, 2)
    wrm = logs.worm_bboxes.cpu().numpy()
    n_cycles, S, L, _ = pos.shape
    fidx = (np.arange(n_cycles)[:, None] * L + np.arange(L)[None, :]).reshape(-1)
    gt = trajs[:, fidx, :].reshape(S, n_cycles, L, 2).transpose(1, 0, 2, 3)
    ok = np.isfinite(wrm).all(axis=-1)
    err = np.hypot(*(wrm[..., :2] + wrm[..., 2:] / 2 - gt).transpose(3, 0, 1, 2))[ok]
    dev = np.hypot(*(gt[3:] - pos[3:]).transpose(3, 0, 1, 2))
    return {
        "detection_rate": float(ok.mean()),
        "median_center_err_px": float(np.median(err)) if ok.any() else float("nan"),
        "in_camera_share_after_cycle_3": float((dev < params.cam_w / 2).mean()),
        "median_worm_deviation_px": float(np.median(dev)),
    }


def synthetic_loop(model, model32, predictor):
    """The JAX package's flagship path at its bench configuration:
    ``make_stream_batch_fused`` + ``run_engine_streams(delayed_log=True)``,
    S=96 streams, YOLOv8s@416 bf16 with the folded stem (the default for
    the BN-fused detector), 12 cycles.  Returns the phase's numbers and a
    function that runs the loop once more and returns its wall seconds."""
    from dataclasses import replace

    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, _resolve_detect, make_stream_batch_fused
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

    _, params = bench_setup()
    S = SYNTH_STREAMS
    # bench.py draws 60,000-frame tracks; the first frames of these are the same
    trajs = np.stack([make_trajectory(400, (1400, 1600), seed=i) for i in range(S)])
    init = np.tile([700, 700], (S, 1))
    cfg = LiveLoopConfig(
        imgsz=(416, 416), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0, detect_chunks=SYNTH_CHUNKS
    )
    if not getattr(_resolve_detect(None, cfg, model, (params.cam_h, params.cam_w)), "folds_preproc", False):
        raise AssertionError("the bench configuration did not select the folded stem")
    scene = SyntheticScene()
    ctl = make_stream_batch_fused(params, cfg, scene, trajs, model, predictor, device="cuda")

    def run(ctl=ctl, n_streams=S, n_cycles=SYNTH_CYCLES):
        t0 = time.perf_counter()
        logs = run_engine_streams(params, ctl, init[:n_streams], n_cycles, delayed_log=True, device="cuda")
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    crop_letterbox_views.launches = 0
    logs, warm_s = run()
    secs = [run()[1] for _ in range(SYNTH_TIMED_RUNS)]
    launches = crop_letterbox_views.launches
    if launches != 0:
        raise AssertionError(f"the synthetic loop launched crop_letterbox {launches} times")
    if logs.positions.shape != (SYNTH_CYCLES, S, params.cycle_n, 2) or logs.worm_bboxes.shape != (SYNTH_CYCLES, S, params.cycle_n, 4):
        raise AssertionError(f"synthetic log shapes {tuple(logs.positions.shape)} {tuple(logs.worm_bboxes.shape)}")
    quality = synthetic_quality(params, logs, trajs)
    log(f"synthetic loop S={S}: {quality}, runs {warm_s:.3f} (warm-up) {secs}")
    if not (quality["detection_rate"] >= 0.95 and quality["median_center_err_px"] <= 4.0):
        raise AssertionError(f"the synthetic loop lost the worm: {quality}")
    if not quality["in_camera_share_after_cycle_3"] >= 0.95:
        raise AssertionError(f"the worm left the camera in the synthetic loop: {quality}")

    # float32, S=4, 4 cycles: the folded and the standard stem give one track
    logs32 = {}
    for fold in (True, False):
        c = replace(cfg, fold_stem=fold, detect_chunks=1)
        ctl32 = make_stream_batch_fused(params, c, scene, trajs[:4], model32, predictor, device="cuda")
        logs32[fold] = run(ctl32, 4, 4)[0]
    pos32, box32 = log_diffs(logs32[True], logs32[False])
    if not (pos32 == 0 and box32 <= 1e-2):
        raise AssertionError(f"float32 folded and standard synthetic loops differ: {pos32} px, {box32} px")

    wall = float(np.median(secs))
    out = {
        "streams": S,
        "cycles": SYNTH_CYCLES,
        "detect_chunks": SYNTH_CHUNKS,
        "views_per_sub_batch": S * params.cycle_n // SYNTH_CHUNKS,
        "steps_per_s": S * SYNTH_CYCLES * params.cycle_n / wall,
        "cycles_per_s": SYNTH_CYCLES / wall,
        "warmup_s": warm_s,
        "run_s": secs,
        "crop_letterbox_launches": launches,
        "f32_fold_vs_standard_pos_max_abs_diff": pos32,
        "f32_fold_vs_standard_box_max_abs_diff": box32,
        **quality,
    }
    return out, lambda: run()[1]


def decision_latency(model, predictor, S: int) -> dict:
    """``make_decision_step`` at S streams on inputs built as bench.py builds
    them (k = 5 rendered views a stream around the worm): 10 warm-ups, then
    200 decisions, each timed on the host from the call until its move is
    on the host, and by CUDA events around the call (the device span)."""
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_decision_step
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    timing, params = bench_setup()
    view_hw = (params.cam_h, params.cam_w)
    cfg = LiveLoopConfig(imgsz=(416, 416), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0)
    decide = make_decision_step(cfg, model, predictor, view_hw)

    k = len(predictor.io_config.input_frames)
    rng = np.random.default_rng(0)
    cam_tl = rng.uniform(100, 900, (S, 2)).round().astype(np.float32)
    worm = cam_tl[:, None] + [params.cam_w / 2, params.cam_h / 2] + rng.uniform(-8, 8, (S, k, 2))
    cam_t = torch.from_numpy(cam_tl).cuda()
    views = SyntheticScene().render_views(
        torch.from_numpy(worm.reshape(S * k, 2).astype(np.float32)).cuda(),
        cam_t.repeat_interleave(k, dim=0), view_hw, torch.arange(S * k, device="cuda"),
    ).reshape(S, k, *view_hw)

    for _ in range(DECISION_WARMUP):
        decide(views, cam_t)
    torch.cuda.synchronize()
    host_ms, events, moves = [], [], []
    for _ in range(DECISION_REPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        move = decide(views, cam_t)
        e1.record()
        moves.append(move.cpu())  # waits for the move
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((e0, e1))
    torch.cuda.synchronize()
    device_ms = [a.elapsed_time(b) for a, b in events]
    move = moves[-1].numpy()
    # every decision the same; the move is the clipped MLP step plus the
    # newest detection's offset from the camera centre (<= 8 px + error)
    if move.shape != (S, 2) or move.dtype != np.int32 or any(not np.array_equal(m.numpy(), move) for m in moves):
        raise AssertionError(f"decision moves: {[m.tolist() for m in moves[:3]]}")
    if not np.abs(move).max() <= cfg.max_dist_per_pred + 16:
        raise AssertionError(f"decision move {move.tolist()} is out of reach")

    def tails(a):
        a = np.asarray(a)
        return {"p50": float(np.percentile(a, 50)), "p95": float(np.percentile(a, 95)), "max": float(a.max())}

    return {
        "streams": S,
        "views": S * k,
        "budget_ms": timing.pred_time_ms,
        "host_ms": tails(host_ms),
        "device_span_ms": tails(device_ms),
        "move": move.tolist(),
    }


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

    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    n = CLI_FRAMES
    frames = recording.data[:n]
    out = {"frames": n, "bytes_on_disk": 0}
    (tmp / "frames").mkdir()
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        write_gray_bmp(tmp / "frames" / f"frame_{i:06d}.bmp", frame)
    out["write_s"] = time.perf_counter() - t0
    out["bytes_on_disk"] = sum(p.stat().st_size for p in (tmp / "frames").iterdir())

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
    for name, extra in (("whole_frames", []), ("roi", ["--roi", str(win[0])])):
        cmd = [
            sys.executable, "-m", "wtracker_tpu_torch.workflows.track_video", "--frames", str(tmp / "frames"),
            "--timing-config", str(timing_config), "--exp-config", str(tmp / "exp.json"),
            "--detector", str(detector), "--output", str(tmp / name), "--device", "cuda", *extra,
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=600
        )
        out[f"{name}_wall_s"] = time.perf_counter() - t0
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


def video_streams(params, base, models, predictor) -> dict:
    """``run_video_live_sharded`` over STREAMS seeded recordings at full
    width (default ``fold_stem=None``), each stream held against its own
    ``run_video_live``: float32 positions exact and boxes within 1e-2 px,
    bfloat16 within 2 px; then stream-cycles/s of the bfloat16 loop."""
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
    crop_letterbox_views.launches = 0
    for dtype, model in models.items():
        logs, _ = sharded(model)
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
    return out


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


def replay(tmp: Path, device: str = "cuda") -> tuple[dict, dict]:
    """Phase 14: ``run_engine`` with the csv, optimal, polyfit (degree 2 at
    [-15, -10, -5, 0, 3]) and mlp (the seeded predictor) controllers and the
    csv controller on the step motor, at the deployment configuration over a
    seeded 61,200-frame worm log: cycles/s a controller (after a 20-cycle
    warm-up), polyfit once more through ``python -m
    wtracker_tpu_torch.workflows.simulate`` (wall time), and the same runs
    on the CPU: csv, optimal, polyfit and step give the same ``bboxes.csv``
    text, mlp equal positions in >= 99.9 % of frames and none 2 px apart.
    Returns the phase's numbers and, for ``--profile``, a function per
    profiled controller that runs PROFILE_REPLAY_CYCLES cycles."""
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor, save_predictor
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig

    exp_path, timing_path = ROOT / "configs" / "exp_config.json", ROOT / "configs" / "timing_config.json"
    exp, timing = ExperimentConfig.load_json(str(exp_path)), TimingConfig.load_json(str(timing_path))
    table = worm_csv(tmp / "worm.csv", exp.num_frames, tuple(exp.orig_resolution), SEED)
    frame_hw = te.headless_frame_shape(timing, exp.orig_resolution)
    n = te.EngineParams.from_timing(timing, frame_hw).n_logged_cycles(exp.num_frames)
    predictors = {
        dev: make_rmlp_predictor(IOConfig([0, -3, -6, -9, -12], [3]), seed=SEED, device=dev) for dev in {device, "cpu"}
    }
    save_predictor(predictors["cpu"], str(tmp / "predictor.npz"))  # phase 23's mlp

    def build(name: str, dev: str):
        params = te.EngineParams.from_timing(timing, frame_hw, motor="step" if name == "csv_step" else "sine")
        if name in ("csv", "csv_step"):
            return params, te.csv_controller(table, params, device=dev)
        if name == "optimal":
            return params, te.optimal_controller(table, params, device=dev)
        if name == "polyfit":
            times = np.array(REPLAY_POLYFIT_TIMES)
            return params, te.polyfit_controller(table, params, times, np.ones(len(times)), 2, device=dev)
        pred = predictors[dev]
        bound = te.mlp_max_dist_per_pred(timing, pred.io_config)
        return params, te.mlp_controller(table, params, pred, bound, device=dev)

    def run(name: str, dev: str, n_cycles: int = n):
        params, ctl = build(name, dev)
        t0 = time.perf_counter()
        logs = te.run_engine(params, ctl, exp.init_position, n_cycles, device=dev)
        cuda_sync(dev)
        return params, logs, time.perf_counter() - t0

    names = ("csv", "optimal", "polyfit", "mlp", "csv_step")
    out = {"cycles": n, "frames": exp.num_frames, "controllers": {}}
    crop_letterbox_views.launches = 0
    texts, logs_by = {}, {}
    for name in names:
        run(name, device, 20)  # warm-up
        params, logs, wall = run(name, device)
        if logs.positions.shape != (n, params.cycle_n, 2):
            raise AssertionError(f"{name}: log shape {tuple(logs.positions.shape)}")
        share = worm_in_view_share(params, logs, table)
        if not share >= 0.95:
            raise AssertionError(f"{name}: the worm was in view in only {share:.4f} of the frames")
        texts[name], logs_by[name] = te.logs_to_frame(params, logs).to_csv(index=False), logs
        (tmp / f"engine_{name}.csv").write_text(texts[name])  # phase 23 holds the host backend to it
        out["controllers"][name] = {
            "cycles_per_s": n / wall, "ms_per_cycle": wall / n * 1e3, "run_s": wall, "worm_in_view_share": share,
        }
        log(f"replay {name}: {n / wall:.1f} cycles/s")
    if crop_letterbox_views.launches != 0:
        raise AssertionError(f"the replay controllers launched K1 {crop_letterbox_views.launches} times")
    out["crop_letterbox_launches"] = crop_letterbox_views.launches

    # the command, as a user runs it (the default polyfit config)
    cmd = [
        sys.executable, "-m", "wtracker_tpu_torch.workflows.simulate", "--timing-config", str(timing_path),
        "--exp-config", str(exp_path), "--worm-csv", str(tmp / "worm.csv"), "--output", str(tmp / "simulate"),
        "--controller", "polyfit", "--device", device,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=900)
    out["cli_polyfit_wall_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"simulate exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    if (tmp / "simulate" / "bboxes.csv").read_text() != texts["polyfit"]:
        raise AssertionError("the simulate command wrote another bboxes.csv than the in-process polyfit run")
    out["cli_stdout"] = proc.stdout.strip().splitlines()

    # the same runs on the CPU
    cpu = {}
    for name in names:
        params, logs, wall = run(name, "cpu")
        cpu[name] = {"cycles_per_s": n / wall}
        if name == "mlp":
            diff = np.abs(logs.positions.numpy() - logs_by[name].positions.cpu().numpy()).max(axis=-1).reshape(-1)
            cpu[name].update(frames_equal_share=float((diff == 0).mean()), max_abs_pos_diff_px=int(diff.max()))
            if not (cpu[name]["frames_equal_share"] >= 0.999 and diff.max() <= 2):
                raise AssertionError(f"mlp on the card and on the CPU drift apart: {cpu[name]}")
        elif te.logs_to_frame(params, logs).to_csv(index=False) != texts[name]:
            raise AssertionError(f"{name}: the card and the CPU wrote different bboxes.csv text")
        else:
            cpu[name]["identical_text"] = True
    out["cpu"] = cpu
    profiled = {f"replay_{k}": (lambda k=k: run(k, device, PROFILE_REPLAY_CYCLES)[2]) for k in ("polyfit", "csv")}
    return out, profiled


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
        sys.executable, "-m", "wtracker_tpu_torch.workflows.sweep", "--worm-csvs",
        *[str(tmp / f"sweep_worm{i}.csv") for i in range(5)], "--exp-configs", *[str(e) for e, _ in cfgs],
        "--timing-configs", *[str(t) for _, t in cfgs], "--output", str(tmp / "sweep"), "--device", device,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=900)
    out["cli_mixed_wall_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sweep exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    out["cli_stdout"] = proc.stdout.strip().splitlines()
    solo_s, cycles_each = [], []
    for i, (exp, timing, table) in enumerate(zip(exps, timings, tables)):
        params = te.EngineParams.from_timing(timing, te.headless_frame_shape(timing, exp.orig_resolution))
        n = params.n_logged_cycles(exp.num_frames)
        t0 = time.perf_counter()
        logs = te.run_engine(params, te.csv_controller(table, params, device=device), exp.init_position, n, device=device)
        cuda_sync(device)
        solo_s.append(time.perf_counter() - t0)
        cycles_each.append(n)
        if (tmp / "sweep" / f"exp{i}" / "bboxes.csv").read_text() != te.logs_to_frame(params, logs).to_csv(index=False):
            raise AssertionError(f"the sweep's exp{i} differs from its single-stream run")
    out.update(mixed_cycles=cycles_each, mixed_equal_to_solo=True, solo_run_s=solo_s)

    # S streams of phase 14's configuration in one batch
    exp = ExperimentConfig.load_json(str(ROOT / "configs" / "exp_config.json"))
    timing = TimingConfig.load_json(str(ROOT / "configs" / "timing_config.json"))
    params = te.EngineParams.from_timing(timing, te.headless_frame_shape(timing, exp.orig_resolution))
    n, streams = params.n_logged_cycles(exp.num_frames), SWEEP_STREAMS
    csvs = np.stack([worm_boxes(exp.num_frames, tuple(exp.orig_resolution), SEED + 100 + s) for s in range(streams)])
    init = np.tile(exp.init_position, (streams, 1))
    ctl = te.csv_controller_streams(csvs, params, device=device)
    te.run_engine_streams(params, ctl, init, 20, batched_controller=True, device=device)  # warm-up
    t0 = time.perf_counter()
    logs = te.run_engine_streams(params, ctl, init, n, batched_controller=True, device=device)
    cuda_sync(device)
    wall = time.perf_counter() - t0
    for s in (0, streams - 1):
        solo = te.run_engine(params, te.csv_controller(csvs[s], params, device=device), exp.init_position, n, device=device)
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
        q = synthetic_quality(params, one, trajs[s : s + 1])
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
        crop_letterbox_views.launches = conv_s8.launches = 0
        logs, secs = run_loop(params, cfg, recording, num_frames, det, predictor, "cuda", **kw)
        k1, k2 = crop_letterbox_views.launches, conv_s8.launches
        if k1 != k1_per_cycle * n_cycles or k2 != k2_per_forward * 2 * n_cycles:
            raise AssertionError(f"int8 {name} loop: K1 {k1}, K2 {k2} launches in {n_cycles} cycles")
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
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

    _, params = bench_setup()
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
    crop_letterbox_views.launches = conv_s8.launches = 0
    secs = [run()[1] for _ in range(INT8_SYNTH_TIMED_RUNS)]
    k1, k2 = crop_letterbox_views.launches, conv_s8.launches
    if k1 != 0 or k2 != 62 * forwards * INT8_SYNTH_TIMED_RUNS:
        raise AssertionError(f"the int8 synthetic loop launched K1 {k1} and K2 {k2} times in {INT8_SYNTH_TIMED_RUNS} runs")
    quality = synthetic_quality(params, logs, trajs)
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
    cmd = [
        sys.executable, "-m", "wtracker_tpu_torch.workflows.track_video", "--frames", str(tmp / "frames"),
        "--timing-config", str(timing_config), "--exp-config", str(tmp / "exp.json"), "--detector", str(artifact),
        "--output", str(tmp / "int8"), "--device", "cuda",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
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
    host`` at phase 14's configuration on its worm log, uncut, with the csv,
    optimal, polyfit (the command's default, degree 2 at [-15, -10, -5, 0,
    3]) and mlp (phase 14's predictor, on the card) controllers, one command
    after another, so that each loop's cycles/s is its own and not shared
    with the others' start-up.  Each ``bboxes.csv`` (``\\r\\n`` line
    ends, the csv module's) must be phase 14's engine text row for row; for mlp the rows that
    differ are counted and held to phase 14's card-against-CPU bar."""
    exp_path, timing_path = ROOT / "configs" / "exp_config.json", ROOT / "configs" / "timing_config.json"
    out = {"controllers": {}}
    for name in HOST_CONTROLLERS:
        cmd = [
            sys.executable, "-m", "wtracker_tpu_torch.workflows.simulate", "--backend", "host",
            "--timing-config", str(timing_path), "--exp-config", str(exp_path), "--worm-csv", str(tmp / "worm.csv"),
            "--output", str(tmp / f"host_{name}"), "--controller", name, "--device", "cuda",
            *(["--predictor", str(tmp / "predictor.npz")] if name == "mlp" else []),
        ]
        started = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                              capture_output=True, text=True, timeout=600)
        stdout, stderr = proc.stdout, proc.stderr
        wall = time.perf_counter() - started
        if proc.returncode != 0:
            raise AssertionError(f"simulate --backend host {name} exited {proc.returncode}:\n{stderr[-4000:]}")
        stdout = stdout.strip().splitlines()
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
    rendered track and 0 launches of K1 and K2 on every run, and cycles/s
    over ``HOST_YOLO_RUNS`` timed runs after a warm-up run."""
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
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
        crop_letterbox_views.launches = conv_s8.launches = 0
        t0 = time.perf_counter()
        Simulator(timing, exp, LoggingController(ctl, LogConfig(root_folder=str(out_dir), save_err_view=False)),
                  reader=reader).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"crop_letterbox": crop_letterbox_views.launches, "conv_s8": conv_s8.launches}
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
    byte for byte.  Then one ``WeightEvaluator.eval`` over phase 14's log on
    the card (timed after a warm-up) equals the CPU's value exactly."""
    from wtracker_tpu_torch.models.yolo_port import save_torch_state_dict
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, preprocess_batch
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.sim.controllers import WeightEvaluator

    out = {}
    crop_letterbox_views.launches = conv_s8.launches = 0
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

    timing = TimingConfig.load_json(str(timing_path))
    times, target = np.array(EVAL_SAMPLE_TIMES), params.cycle_n + params.imaging_n // 2
    evals = {dev: WeightEvaluator([str(replay_tmp / "worm.csv")], timing, times, target, device=dev) for dev in ("cuda", "cpu")}
    weights = np.ones(len(times))
    evals["cuda"].eval(weights)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = evals["cuda"].eval(weights)
    out["weight_eval_ms"] = (time.perf_counter() - t0) * 1e3
    cpu = evals["cpu"].eval(weights)
    if card != cpu:
        raise AssertionError(f"WeightEvaluator.eval on the card {card!r} differs from the CPU's {cpu!r}")
    out.update(weight_eval_columns=int(evals["cpu"].y_input.shape[1]), weight_eval_mae=card, weight_eval_card_equals_cpu=True)
    out["launches"] = {"crop_letterbox": crop_letterbox_views.launches, "conv_s8": conv_s8.launches}
    if any(out["launches"].values()):
        raise AssertionError(f"the .pt phase launched a hand kernel: {out['launches']}")
    return out

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
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")) or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {len(reports)} kernel libraries in {build_s:.1f} s")
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
    synthetic, to_profile["synthetic"] = synthetic_loop(model, model32, predictor)
    del model32
    torch.cuda.empty_cache()

    # -- 10. the 40 ms decision ----------------------------------------------
    decisions = [decision_latency(model, predictor, s) for s in (1, 4)]
    for d in decisions:
        log(f"decision S={d['streams']}: host {d['host_ms']} device {d['device_span_ms']} (budget {d['budget_ms']} ms)")

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
    streams = video_streams(params, base, {"f32": model32, "bf16": model}, predictor)
    log(f"video streams: {streams['stream_cycles_per_s']:.2f} stream-cycles/s")

    # -- 14. replay through the four controllers, and the simulate command ------
    # (its worm log, engine texts and predictor stay for phases 23 and 25)
    replay_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_replay_")
    replay_tmp = Path(replay_dir.name)
    replayed, profiled = replay(replay_tmp)
    to_profile.update(profiled)
    log(f"replay: {({k: round(v['cycles_per_s'], 1) for k, v in replayed['controllers'].items()})} cycles/s")

    # -- 15. sweeps: the sweep command over exp0-exp4, S streams in process ------
    swept = sweep(replay_tmp)
    log(f"sweep: {swept['stream_cycles_per_s']:.0f} stream-cycles/s at S={swept['streams']}")

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

    # -- 22. track_video with the int8 artifact ------------------------------------
    int8_cli = int8_track_video_cli(params, recording, cam, bmp, artifact, timing_path)
    log(f"track_video int8: {int8_cli['wall_s']:.1f} s")

    # -- 23. the host simulator backend: simulate --backend host -------------------
    t0 = time.perf_counter()
    host = host_replay(replay_tmp)

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
    bmp_dir.cleanup()
    replay_dir.cleanup()

    profile = "--profile" in sys.argv
    profiles = {name: profile_run(run) for name, run in to_profile.items()} if profile else {}

    # -- results ---------------------------------------------------------------
    t12, t3 = times[params.imaging_n], times[params.moving_n]
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
                "design": k2_design(),
                "sass": k2_sass,
                "classes": k2["classes"],
                "classes_n360": k2_360["classes"],
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
            "build_s": build_s,
            "card": card,
        }
    }
    video_folded = {
        "video_loop_folded": {
            "crop_letterbox_launches": launches_f,
            "cycles_per_s": n_cycles / float(np.median(secs_f)),
            "run_s": secs_f,
            "bf16_pos_max_abs_diff_vs_kernel_loop": pos_fk,
            "bf16_box_max_abs_diff_vs_kernel_loop": box_fk,
            **quality_f,
        }
    }
    print(json.dumps(kernels))
    print(json.dumps(loop))
    print(json.dumps({"folded_detect": folded}))
    print(json.dumps(video_folded))
    print(json.dumps({"synthetic_loop": synthetic}))
    print(json.dumps({"decision_latency": decisions}))
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
    if profile:
        print(json.dumps({"profile": {**profiles, "card": card}}))
    print(json.dumps({"smoke": {"script_s": time.perf_counter() - t_start, "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
