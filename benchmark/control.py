"""The readings that the limits of ``limits/<cell>.json`` are set from, and
the controls that have to fail them (see ``check.py``): for one cell, in one
process,

- ``program``: the cell's loop, one engine run a seed, its numbers;
- ``control``: the loop computed one precision below the configuration's:
  the bf16 configurations through the port's own int8 path, the int8
  configuration with the reference at int4 in the detector's place, each
  held to the configuration's own reference;
- ``fault:<name>``: the loop broken underneath (``system.FAULTS``).

    python -m benchmark.control --workload <cell> --seeds 1 2 ... [--control-seeds ...] [--fault-seeds ...] [--out FILE]

One JSON line a run, on standard output and appended to ``--out``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import check, run, system


def readings(cell: str, seeds: list[int], control_seeds: list[int], fault_seeds: list[int], device: str = "cuda",
             out=None, faults=system.FAULTS, files=None) -> list[dict]:
    _, config, traffic, _ = files or run.cell_files(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    model32 = system.load_detector(config, dev)
    rows = []

    def one(kind: str, seed: int, ref_precision: str, **build_kw):
        t0 = time.perf_counter()
        loop = system.build(config, traffic, seed, dev, model32, **build_kw)
        target = int(np.random.default_rng([int(seed), 1 << 21]).integers(loop.calls))
        loop.recorder.arm(target)
        positions, boxes = loop.run()
        t_run = time.perf_counter() - t0
        det = check.reference_detector(config, ref_precision, traffic, seed, dev)
        nums = check.numbers(loop, positions, boxes, det, config, traffic, seed, dev)
        row = {"cell": cell, "kind": kind, "seed": seed, "numbers": nums, "run_s": t_run,
               "check_s": time.perf_counter() - t0 - t_run}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")

    precision = config["precision"]
    for seed in seeds:
        one("program", seed, precision)
    for seed in control_seeds:
        if precision == "bf16":
            one("control", seed, "bf16", precision="int8")
        else:
            def int4(recorder, seed=seed):
                det4 = check.reference_detector(config, "int8", traffic, seed, dev, bits=4)
                holder = torch.nn.Module()
                holder.register_buffer("anchor", torch.zeros(1, device=dev))
                return holder, check.reference_detect_fn(det4, int(config["imgsz"]), recorder)

            one("control", seed, "int8", detect_override=int4)
    for fault in faults:
        for seed in fault_seeds:
            one(f"fault:{fault}", seed, precision, fault=fault)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 1
    readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
