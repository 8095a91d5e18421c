"""Time the whole workflow chain over a recording, through the commands.

Port of the JAX package's ``tools/bench_workflow_chain.py``: the chain a lab
runs on a recording,

1. ``initialize_experiment``: background and a detection of every frame
   (the trained detector, ``--detector yolo``), ``init_bboxes.csv`` and the
   experiment's config;
2. ``track_video``: the closed loop over the recording (ROI streaming
   unless ``--roi 0``), ``bboxes.csv``;
3. ``analysis``: the log's analysis, with the precise (segmentation) error
   of every logged box against the recording and its background;
4. ``visualize``: the annotated first frames, written as PNGs
   (``--save-frames``: the card's host has no OpenCV to write an mp4),

each run as ``python -m wtracker_tpu_torch.workflows.<name>`` with the
repository's root put first on ``PYTHONPATH``, on ``--device``.  Writes
``WORKFLOW_CHAIN_TORCH.json`` with every field of the JAX package's
``WORKFLOW_CHAIN.json`` (``ran_at``, ``predictor`` and ``extrapolation``
included, which the JAX writer leaves out) and the card it ran on.  The
predictor is the seeded ResMLP or an ``.npz`` (the port refuses predictor
``.pt`` files).  Render the recording first with ``tools/recording.py``.

Usage::

    python -m wtracker_tpu_torch.tools.recording --output /tmp/rec --frames 1200
    python -m wtracker_tpu_torch.tools.workflow_chain --dir /tmp/rec --work /tmp/chain [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from wtracker_tpu_torch.tools import CHECKPOINT, REPO, card_line, commit

EXPERIMENT_FRAMES = 61_200  # a reference experiment: 17 min at 60 fps
NOTES = {
    "initialize_experiment": "background ({probes} probes) + detection of every frame at {imgsz} px -> init_bboxes.csv",
    "track_video": "closed loop over the recording ({roi}) -> bboxes.csv",
    "analysis": "log analysis with the batched precise (segmentation) error against the recording and background",
    "visualize": "annotated first {frames} frames as PNGs",
}


def run_stage(name: str, args: list, record: dict, note: str, timeout: int = 7200) -> None:
    """One command as a child process; its wall seconds and exit status go
    into ``record[name]``; a failed command raises with its output's end."""
    cmd = [sys.executable, "-m", f"wtracker_tpu_torch.workflows.{name}", *map(str, args)]
    print(f"[chain] {name}: {' '.join(cmd[1:])}", flush=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-6:])
    record[name] = {"seconds": round(dt, 1), "ok": out.returncode == 0, "note": note}
    print(f"[chain]   -> {dt:.1f} s (exit {out.returncode})\n{tail}\n", flush=True)
    if out.returncode != 0:
        raise RuntimeError(f"stage {name} failed:\n{tail}")


def run_chain(frames_dir: str, work: str, detector=CHECKPOINT, predictor: str | None = None, roi: int = 512,
              imgsz: int = 416, viz_frames: int = 600, px_per_mm: float = 90.0, bg_probes: int = 1000,
              device: str = "cuda") -> dict:
    """The four stages over ``frames_dir``, outputs under ``work``; returns
    the record."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    if predictor is not None and not str(predictor).endswith(".npz"):
        raise ValueError(f"the predictor must be an .npz (the port refuses .pt predictors): {predictor}")
    reader = FrameReader.create_from_directory(frames_dir)
    n_frames, (h, w) = len(reader), reader.frame_size
    work = Path(work)
    exp_dir, track_dir, analysis_dir = work / "experiment", work / "track", work / "analysis"
    os.makedirs(work, exist_ok=True)
    record: dict = {}

    run_stage("initialize_experiment", [
        "--frames", frames_dir, "--output", exp_dir, "--name", "chain", "--px-per-mm", px_per_mm,
        "--init-position", w // 2, h // 2, "--detector", "yolo", "--yolo-weights", detector, "--imgsz", imgsz,
        "--bg-probes", bg_probes, "--device", device,
    ], record, NOTES["initialize_experiment"].format(probes=bg_probes, imgsz=imgsz))

    # the reference's deployed schedule on the new experiment
    timing_path = work / "timing.json"
    exp = ExperimentConfig.load_json(str(exp_dir / "exp_config.json"))
    TimingConfig(
        experiment_config=exp, imaging_time_ms=200.0, pred_time_ms=40.0, moving_time_ms=50.0,
        camera_size_mm=(4.0, 4.0), micro_size_mm=(0.32, 0.32),
    ).save_json(str(timing_path))

    track = ["--frames", frames_dir, "--output", track_dir, "--timing-config", timing_path,
             "--exp-config", exp_dir / "exp_config.json", "--detector", detector, "--imgsz", imgsz, "--device", device]
    track += ["--predictor", predictor] if predictor else []
    track += ["--roi", roi] if roi else []
    run_stage("track_video", track, record, NOTES["track_video"].format(roi=f"ROI {roi}" if roi else "whole frames"))

    log = track_dir / "bboxes.csv"
    run_stage("analysis", [
        "--timing-config", timing_path, "--log", log, "--output", analysis_dir, "--worm-crops", frames_dir,
        "--background", exp_dir / "background.npy", "--remove-anomalies", "--device", device,
    ], record, NOTES["analysis"])

    shown = min(viz_frames, n_frames)
    run_stage("visualize", [
        "--timing-config", timing_path, "--log", log, "--frames", frames_dir, "--save-frames", work / "visualize",
        "--stop", shown, "--device", device,
    ], record, NOTES["visualize"].format(frames=shown))

    total = round(sum(s["seconds"] for s in record.values()), 1)
    hours = total / n_frames * EXPERIMENT_FRAMES / 3600
    return {
        "ran_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "recording": {"dir": str(frames_dir), "frames": n_frames, "geometry": f"{h}x{w} @ {exp.frames_per_sec:g} fps"},
        "detector": f"{Path(detector).name} (YOLOv8 at {imgsz} px)",
        "predictor": str(predictor) if predictor else "seeded ResMLP (make_rmlp_predictor, seed 0; untrained)",
        "roi": roi or None,
        "stages": record,
        "total_seconds": total,
        "extrapolation": f"a {EXPERIMENT_FRAMES:,}-frame experiment extrapolates linearly to ~{hours:.2f} h "
                         f"(every stage's time scaled by frames) - EXTRAPOLATED, not measured",
        "reference_quote": "initialize alone: 'might take very long time, up to few hours' "
                           "(the reference's workflows/initialize_experiment.ipynb, cell 11)",
        "device": device,
        "card": card_line() if device.startswith("cuda") else None,
        "commit": commit(),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", required=True, help="recording directory (tools/recording.py)")
    ap.add_argument("--work", required=True, help="output workspace")
    ap.add_argument("--detector", default=str(CHECKPOINT), help="detector weights (.npz)")
    ap.add_argument("--predictor", help="ResMLP weights (.npz); the seeded predictor if omitted")
    ap.add_argument("--roi", type=int, default=512, help="ROI window for tracking (0 = whole frames)")
    ap.add_argument("--imgsz", type=int, default=416, help="the detector's input size in both detecting stages")
    ap.add_argument("--viz-frames", type=int, default=600, help="frames to annotate")
    ap.add_argument("--px-per-mm", type=float, default=90.0)
    ap.add_argument("--bg-probes", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="torch device of every stage (default: cuda)")
    ap.add_argument("--output", default=str(REPO / "WORKFLOW_CHAIN_TORCH.json"))
    args = ap.parse_args(argv)

    if not os.path.isdir(args.dir):
        raise SystemExit(f"{args.dir} missing: render it with python -m wtracker_tpu_torch.tools.recording first")
    record = run_chain(args.dir, args.work, args.detector, args.predictor, args.roi, args.imgsz, args.viz_frames,
                       args.px_per_mm, args.bg_probes, args.device)
    with open(args.output, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({"chain_total_s": record["total_seconds"], **{k: v["seconds"] for k, v in record["stages"].items()}}))
    return record


if __name__ == "__main__":
    main()
