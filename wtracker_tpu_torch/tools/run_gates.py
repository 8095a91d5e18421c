"""Run the detector's quality gates and write the port's gate record.

Port of the JAX package's ``tools/run_gates.py``: it runs the gates of
:mod:`wtracker_tpu_torch.tools.gates` in this process on ``--device`` and
writes ``GATES_TORCH.json`` at the repository's root (the JAX package's
``GATES.json`` is its own record and is never touched).  Each gate records
its status, seconds, numbers, thresholds and hand-kernel launches; the
record also holds the commit, the checkpoint, the device and the card's
``nvidia-smi`` name and power limit.  ``--skip-trained`` skips the gates of
the trained checkpoint (held-out AP, trained int8 drift, closed loop), e.g.
while training.  The exit code is 0 only when every gate passes.

The sizes are the JAX gates' by default; the flags shrink them (the CPU
tests run a nano model at 64 px).

Usage::

    python -m wtracker_tpu_torch.tools.run_gates [--checkpoint models/yolov8s_worm416.npz]
        [--output GATES_TORCH.json] [--skip-trained] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import torch

from wtracker_tpu_torch.tools import CHECKPOINT, REPO, card_line, commit, gates


def run_all(args) -> dict:
    """Every selected gate, in order: ``{name: record}``."""
    dev = args.device
    sizes = dict(cam=args.cam, imgsz=args.imgsz)
    jobs = [
        ("s416_parity", lambda: gates.s416_parity(dev, scale=args.scale, views=args.parity_views, **sizes)),
        ("int8_drift_s416", lambda: gates.int8_drift_s416(dev, scale=args.scale, calib=args.calib,
                                                          heldout=args.heldout, **sizes)),
    ]
    if not args.skip_trained:
        ckpt = args.checkpoint
        jobs += [
            ("map50_heldout", lambda: gates.map50_heldout(ckpt, dev, imgsz=args.imgsz)),
            ("trained_int8_drift", lambda: gates.trained_int8_drift(ckpt, dev, calib=args.calib,
                                                                     heldout=args.heldout, **sizes)),
            ("closed_loop_tracking", lambda: gates.closed_loop_tracking(ckpt, dev, imgsz=args.imgsz)),
        ]
    results = {}
    for name, job in jobs:
        print(f"[run_gates] {name}", flush=True)
        t0 = time.perf_counter()
        numbers = job()
        results[name] = {"status": "pass" if numbers.pop("pass") else "fail",
                         "seconds": round(time.perf_counter() - t0, 2), **numbers}
        print(f"[run_gates]   -> {results[name]['status']} in {results[name]['seconds']} s", flush=True)
    return results


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=str(CHECKPOINT), help="the trained detector (.npz)")
    ap.add_argument("--output", default=str(REPO / "GATES_TORCH.json"))
    ap.add_argument("--skip-trained", action="store_true", help="skip the trained-checkpoint gates")
    ap.add_argument("--device", default="cuda", help="torch device of the gates (default: cuda)")
    ap.add_argument("--scale", default="s", help="YOLOv8 scale of the random-weight gates")
    ap.add_argument("--imgsz", type=int, default=gates.IMGSZ)
    ap.add_argument("--cam", type=int, default=gates.CAM, help="camera view size of the drift and parity gates")
    ap.add_argument("--calib", type=int, default=32, help="int8 calibration views")
    ap.add_argument("--heldout", type=int, default=16, help="int8 drift's held-out views")
    ap.add_argument("--parity-views", type=int, default=2)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    results = run_all(args)
    on_card = torch.device(args.device).type == "cuda"
    record = {
        "ran_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "commit": commit(),
        "host": {"machine": platform.machine(), "cpus": os.cpu_count()},
        "device": args.device,
        "card": card_line() if on_card else None,
        "device_name": torch.cuda.get_device_name(0) if on_card else None,
        "torch": torch.__version__,
        "trained_checkpoint": None if args.skip_trained else os.path.relpath(os.path.abspath(args.checkpoint), REPO),
        "sizes": {k: getattr(args, k) for k in ("scale", "imgsz", "cam", "calib", "heldout", "parity_views")},
        "gates": results,
        "seconds": round(time.perf_counter() - t0, 2),
        "all_pass": all(r["status"] == "pass" for r in results.values()),
    }
    with open(args.output, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"[run_gates] record -> {args.output}  all_pass={record['all_pass']}")
    return 0 if record["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
