"""One run of one benchmark cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  The run loads and warms up the cell's loop
(``system.py``), then:

- ``--trace 0``: runs engine runs of ``cycles_per_run`` cycles back to back,
  each ended by fetching its logs to the host, until ``--seconds`` have
  passed (the run that straddles the end is finished and counted), and
  reports ``steps_per_s`` (every frame of every stream tracked in the window,
  over the whole window) and ``setup_s`` (process start to the first timed
  cycle);
- ``--trace 1``: runs one engine run, then one more under ``torch.profiler``,
  and reports the cell's per-layer metrics (``metrics/<name>.py``), the
  card's busy time and a breakdown.

``attempted`` counts the frames logged (in the window, or in the traced run),
``failed`` those of them logged without a worm box.  Either way the last
engine run's outputs are then held against the plain
reference (``check.py``), each number beside its limit
(``limits/<cell>.json``), on standard error's last lines and under the
result's last key, ``checks``.  The last line of standard output is the
result.  Without a CUDA card (or with fewer than the cell asks for), or with
JAX or the JAX package loaded, the run prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

_T_IMPORT = time.perf_counter()
HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wtracker_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this module
    was imported where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``wtracker_tpu_torch`` is not
    ``wtracker_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(name: str) -> tuple[dict, dict, dict, dict]:
    """The cell's entry in ``BENCHMARK.json``, its configuration, its traffic
    and the whole benchmark."""
    bench = load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[cell["config"]]["file"])
    from benchmark import traffic as traffic_mod

    return cell, config, traffic_mod.load(cell["traffic"]), bench


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: dict, config: dict, traffic: dict, bench: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str | None = None, limits: dict | None = None) -> dict:
    """The measurement: returns the result line as a dict (``checks`` last)."""
    import numpy as np
    import torch

    from benchmark import check, system
    from benchmark import trace as trace_mod

    torch.backends.cuda.matmul.allow_tf32 = False  # the reference computes in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_device = dev.type == "cuda"
    name = cell["name"]
    limits = limits if limits is not None else check.load_limits(name)

    stages = {"start_to_imports": process_age_s()}
    t = time.perf_counter()
    model32 = system.load_detector(config, dev)
    stages["detector"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = system.build(config, traffic, seed, dev, model32, fault=fault)
    stages["loop"] = time.perf_counter() - t
    target = int(np.random.default_rng([int(seed), 1 << 21]).integers(loop.calls))
    loop.recorder.arm(target)
    t = time.perf_counter()
    loop.run(2)  # warms every shape the cell uses: each cycle makes the same calls
    _sync(dev)
    stages["warm_up"] = time.perf_counter() - t
    print("set-up stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)

    missed = 0
    device_info: dict = {}
    if not trace:
        t_first = process_age_s()
        frames, runs, t0 = 0, 0, time.perf_counter()
        while True:
            loop.recorder.arm(target)
            positions, boxes = loop.run()
            frames += loop.frames_per_run
            missed += int((~np.isfinite(boxes).all(axis=-1)).sum())
            runs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        metrics = {"steps_per_s": {"value": frames / window, "unit": "steps/s"},
                   "setup_s": {"value": t_first, "unit": "s"}}
        print(f"window {window:.3f} s, {runs} engine runs, {frames} frames, set-up {t_first:.3f} s", file=sys.stderr)
    else:
        loop.recorder.arm(target)
        loop.run()
        _sync(dev)
        loop.recorder.arm(target)
        tr, (positions, boxes) = trace_mod.record(loop.run)
        frames = loop.frames_per_run
        missed = int((~np.isfinite(boxes).all(axis=-1)).sum())
        busy, window = trace_mod.busy_s(tr), trace_mod.traced_window_s(tr)
        ctx = types.SimpleNamespace(trace=tr, busy_s=busy, window_s=window, config=config, traffic=traffic,
                                    precision=loop.precision, stem_folded=loop.stem_folded,
                                    device_cycles=loop.device_cycles, views=loop.views_per_run,
                                    batches=loop.batches, on_device=on_device)
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": busy, "window_s": window}
        breakdown = trace_mod.breakdown(tr)

    peak = torch.cuda.max_memory_allocated(dev) if on_device else 0
    kind = torch.cuda.get_device_name(dev) if on_device else "cpu"

    # the program's state goes before the reference runs
    loop.run = loop.controller = loop.module = None
    del model32
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    det = check.reference_detector(config, loop.precision, traffic, seed, dev)
    nums = check.numbers(loop, positions, boxes, det, config, traffic, seed, dev)
    correct, compared = check.verdict(nums, limits)
    print(f"reference check {time.perf_counter() - t_ref:.3f} s over {nums['frames_checked']} frames",
          file=sys.stderr)

    device_info = {"platform": "gpu" if on_device else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": peak,
                   **device_info}
    out = {"correct": bool(correct), "attempted": frames, "failed": missed, "metrics": metrics,
           "device": device_info}
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = {k: [v["value"], v["limit"]] for k, v in compared.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic, bench = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"this cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    out = run_cell(cell, config, traffic, bench, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark drives the port alone", file=sys.stderr)
        return 1
    for k, (value, limit) in out["checks"].items():
        print(f"check {k}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
