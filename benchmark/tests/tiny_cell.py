"""A cell of the benchmark cut to a size the CPU runs in seconds: the shipped
YOLOv8s checkpoint at 64 px on 48 px cameras (no padding, so the bf16 loop
folds its stem as at 416 px), 3 streams (10 over five rigs for the mixed
traffic) on a small arena, 2 cycles a run, a low confidence threshold so
that every view has a box.  Used by the harness's CPU tests only."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import run  # noqa: E402

SEED = 2**33 + 5  # wider than 32 bits: the command takes any whole seed

# the numbers' limits at this size, set as the cells' limits are (between
# the port's largest CPU reading over seeds and the smallest reading of the
# control or of a fault, nearer the former): bf16 head 0.0061 against the
# int8 control's 0.0255; int8 head 0.0251 against the int4 control's 0.60;
# boxes 0.25 / 0.39 px against 3.99 with a box moved 4 px
TINY_LIMITS = {
    "bf16": {"render_max_abs": 0.5, "head_rel_err": 0.014, "box_err_px": 1.5, "presence_gap": 1.0,
             "move_excess_px": 0.1},
    "int8": {"render_max_abs": 0.5, "head_rel_err": 0.15, "box_err_px": 2.0, "presence_gap": 1.0,
             "move_excess_px": 0.1},
}


def files(cell: str):
    """(cell, config, traffic, bench) of ``cell`` cut to the tiny size."""
    entry, config, traffic, bench = run.cell_files(cell)
    config = dict(config, imgsz=64, batch_views={"bf16": 9, "int8": 6}, calibration_views=8,
                  loop=dict(config["loop"], conf=0.005))
    if traffic["controller"] == "fused":
        rigs = [dict(traffic["rigs"][0], streams=3, orig_resolution_hw=[200, 240], px_per_mm=12, init_xy=None)]
        traffic = dict(traffic, rigs=rigs, track_frames=200, cycles_per_run=2, check_streams=2)
    else:
        rigs = [dict(r, streams=2, orig_resolution_hw=[200, 240], px_per_mm=r["px_per_mm"] / 7.5, init_xy=None)
                for r in traffic["rigs"]]
        traffic = dict(traffic, rigs=rigs, track_frames=200, cycles_per_run=2, check_streams=3)
    return entry, config, traffic, bench


def run_tiny(cell: str, trace: bool = False, fault: str | None = None, seed: int = SEED, seconds: float = 0.3):
    entry, config, traffic, bench = files(cell)
    return run.run_cell(entry, config, traffic, bench, seed, seconds, trace, device="cpu", fault=fault,
                        limits=TINY_LIMITS[config["precision"]])
