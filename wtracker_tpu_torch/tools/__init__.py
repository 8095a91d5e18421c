"""The tools around the package, each runnable as
``python -m wtracker_tpu_torch.tools.<name>`` (on the card unless called with
``--device cpu``):

- :mod:`.make_synthetic_dataset`: the detector's synthetic training set;
- :mod:`.gates`: the shipped detector's quality gates as functions;
- :mod:`.run_gates`: runs the gates and writes ``GATES_TORCH.json``;
- :mod:`.trace_profile`: the synthetic closed loop under ``torch.profiler``;
- :mod:`.trace_diff`: where the device time moved between two traces;
- :mod:`.recording`: renders an exp0-geometry recording as BMP frames;
- :mod:`.workflow_chain`: times initialize → track → analyse → visualize
  through the commands and writes ``WORKFLOW_CHAIN_TORCH.json``;
- :mod:`.bench`: the headline bench, one JSON line (synthetic closed loop
  steps/s, int8, decision latency and cadence; card only);
- :mod:`.bench_video`: the real-video loop from a BMP recording on disk.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CHECKPOINT = REPO / "models" / "yolov8s_worm416.npz"  # the shipped detector


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def commit() -> str:
    """The checkout's short commit, or ``"unknown"`` outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, cwd=REPO,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"
