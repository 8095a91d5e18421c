"""Experiment-scale benchmark of the real-video tracking path.

Port of the JAX package's ``tools/bench_video.py``.  The synthetic headline
(:mod:`wtracker_tpu_torch.tools.bench`) renders its views on the device; the
reference's own workflow reads a BMP recording of up to a few hours off
disk.  This tool measures that path end to end at the reference geometry:
native BMP decode (``runtime/frame_loader.cpp``) -> chunk upload -> crop ->
YOLOv8s@416 detect -> control -> log, through ``sim/engine_video.py::
run_video_live``, and reports sustained steps/s with the share of the wall
time the host spent decoding (a share near 1 means decoding bounds the
loop; the decode overlaps the card's work when the wall stays near the
larger of the two).

Usage::

    python -m wtracker_tpu_torch.tools.bench_video --generate --frames 12000   # once (~27 GB)
    python -m wtracker_tpu_torch.tools.bench_video [--variant bf16|int8] [--roi 512] [--json]

``--generate`` renders the recording with
:func:`wtracker_tpu_torch.tools.recording.generate` (whole 1400x1600 frames
of the synthetic scene, the exp0 geometry, so the recorded pixels are what
the synthetic headline detects).  The default 12,000 frames (800 cycles) is
long past the pipeline's steady state (chunks are 64 cycles).  ``--cpu``
renders the recording on the CPU; the measurement always runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from wtracker_tpu_torch.tools import CHECKPOINT
from wtracker_tpu_torch.tools.recording import ARENA

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "wtracker-video-bench")


def run(frames_dir: str, variant: str, chunk_cycles: int = 64, roi: int | None = None, roi_chunk_cycles: int = 8,
        detector=CHECKPOINT, imgsz: int = 416, device="cuda") -> dict:
    """Measure the disk -> decode -> track path over the recording in
    ``frames_dir``; returns the result dict.

    The geometry, models and loop configuration are the synthetic
    headline's (:func:`~wtracker_tpu_torch.tools.bench.build_flagship` at
    one stream).  ``roi`` turns on ROI streaming: only a ``roi``-sized
    window of each frame is read off disk and uploaded (speculated windows
    and exact replay: the logs equal the whole-frame loop's).  One run over
    two chunks warms up; the timed run goes over the whole recording."""
    from wtracker_tpu_torch.sim.engine_video import run_video_live
    from wtracker_tpu_torch.tools.bench import build_flagship
    from wtracker_tpu_torch.utils.frame_reader import FrameReader
    from wtracker_tpu_torch.utils.profiling import StageTimer

    ctx = build_flagship(S=1, n_cycles=1, detector=detector, imgsz=imgsz, device=device)
    params = ctx.params
    cfg = replace(ctx.cfg, detect_chunks=1)  # a single stream's batches need no sub-batches
    if variant == "bf16":
        model, detect_fn = ctx.det_model, None
    elif variant == "int8":
        model, detect_fn = ctx.int8_path()
    else:
        raise ValueError(f"unknown variant {variant!r}")

    reader = FrameReader.create_from_directory(frames_dir)
    num_frames = len(reader)
    timer = StageTimer(sync=False)  # the host's decode time alone: no wait for the card

    def frame_source(start: int, count: int, out: np.ndarray | None = None) -> np.ndarray:
        with timer("host decode"):
            return reader.read_batch(list(range(start, start + count)), out=out)

    def window_source(start: int, count: int, tls: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
        with timer("host decode"):
            return reader.read_window_batch(list(range(start, start + count)), tls, (roi, roi), out=out)

    roi_stats: dict = {}
    common = dict(
        params=params, config=cfg, frame_source=frame_source, detector_model=model, predictor=ctx.predictor,
        init_position=(700, 700), cycles_per_chunk=chunk_cycles, detect_fn=detect_fn, roi_window=roi,
        roi_chunk_cycles=roi_chunk_cycles, window_source=window_source if roi else None, roi_stats=roi_stats,
        device=ctx.device,
    )

    def synchronize():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    warm_frames = min(num_frames, 2 * chunk_cycles * params.cycle_n)
    float(run_video_live(num_frames=warm_frames, **common).positions.sum())
    synchronize()
    timer.reset()

    t0 = time.perf_counter()
    logs = run_video_live(num_frames=num_frames, **common)
    float(logs.positions.sum())
    synchronize()
    dt = time.perf_counter() - t0

    n_cycles = params.n_logged_cycles(num_frames)
    decode_s = timer.totals.get("host decode", 0.0)
    h, w = reader.frame_shape[:2]
    result = {
        "metric": f"video-path closed-loop steps/s ({variant}" + (f", ROI {roi}px" if roi else "")
        + f", YOLOv8s@416, {num_frames} x {h}x{w} BMP frames from disk)",
        "value": round(n_cycles * params.cycle_n / dt, 1),
        "unit": "steps/s",
        "wall_s": round(dt, 3),
        "host_decode_s": round(decode_s, 3),
        "decode_share": round(decode_s / dt, 3),
        "frames": num_frames,
        "cycles": n_cycles,
    }
    if roi:
        result["roi"] = {"window_px": roi, **roi_stats}
    return result


def main(argv: list[str] | None = None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--generate", action="store_true", help="render the recording, then exit")
    ap.add_argument("--cpu", action="store_true", help="render the recording on the CPU")
    ap.add_argument("--frames", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--chunk-cycles", type=int, default=64)
    ap.add_argument("--roi", type=int, default=None, metavar="PX",
                    help="ROI streaming window size (e.g. 512): the same logs, a fraction of the disk and upload bytes")
    ap.add_argument("--roi-chunk-cycles", type=int, default=8)
    ap.add_argument("--json", action="store_true", help="one-line JSON output")
    args = ap.parse_args(argv)

    if args.generate:
        from wtracker_tpu_torch.tools.recording import generate

        out = generate(args.dir, args.frames, args.seed, ARENA, device="cpu" if args.cpu else "cuda")
        print(f"generated {out['frames']} frames ({out['bytes'] / 1e9:.2f} GB) in {out['seconds']:.1f} s -> {out['dir']}")
        return None
    if not os.path.isdir(args.dir):
        sys.exit(f"{args.dir} does not exist: run with --generate first")
    result = run(args.dir, args.variant, args.chunk_cycles, roi=args.roi, roi_chunk_cycles=args.roi_chunk_cycles)
    print(json.dumps(result) if args.json else json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
