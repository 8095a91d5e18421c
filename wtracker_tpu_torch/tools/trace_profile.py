"""Device-trace profiler of the synthetic closed loop (bf16 or int8).

Port of the JAX package's ``tools/trace_profile.py`` onto ``torch.profiler``:
it builds the flagship loop with the bench's builder
(:func:`wtracker_tpu_torch.tools.bench.build_flagship`: S streams, 360 px
camera, the trained YOLOv8s@416 BN-fused with the folded stem, the
reference's ResMLP or a seeded one), runs one window to warm up and one
under the profiler, and reports

- the device's busy share of the window's wall time and its busy ms per
  cycle (the union of the intervals of kernels, copies and fills),
- the top operators and kernels by device time, and
- ``layers``: for each span name of the program (``wt.cycle``,
  ``wt.detector``, ...; :func:`wtracker_tpu_torch.utils.profiling.span`),
  its calls, host ms, and the device ms of the operations enqueued inside
  it, in total and self (with no inner span),

for the ``bf16`` loop or the ``int8`` serving path (folded-stem int8
detector, the int8 convolution kernel).  ``--trace-dir`` also exports the
Chrome trace (open it in Perfetto, or diff two with ``trace_diff``).  On the
CPU (``--device cpu``) the trace has no device events: operators are listed
by CPU time.

Usage::

    python -m wtracker_tpu_torch.tools.trace_profile [bf16|int8] [--streams 96] [--cycles 12] [--top 25]
        [--trace-dir DIR] [--detector models/yolov8s_worm416.npz] [--imgsz 416] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

import torch

from wtracker_tpu_torch.tools import CHECKPOINT

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")  # device events of an exported trace
SPAN_PREFIX = "wt."
# host calls that enqueue device work: a device operation carries its call's correlation id
ENQUEUE = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")


def device_intervals(events) -> list[tuple[float, float]]:
    """Sorted (start, end) µs of the device operations among a profiler's
    ``events()``: kernels, copies and fills, not the device-side ranges of
    annotations (a span's range covers its gaps) nor CUPTI's
    ``Command Buffer Full``."""
    from torch.autograd import DeviceType

    return sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"
        and not getattr(e, "is_user_annotation", False)
    )


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of sorted intervals: overlaps once, gaps never."""
    busy_us, end = 0.0, float("-inf")
    for s, e in intervals:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us


def span_layers(prof) -> list[dict]:
    """For each span name of a profiled run (``wt.*``): its calls, summed
    host ms, and the summed device ms of the operations enqueued inside its
    spans (``device_ms``) and inside them with no inner span
    (``self_device_ms``), each operation found by the correlation id of the
    host call that enqueued it.  Sorted by self device time, then name."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    spans, enqueued, ops = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), -e.end_ns(), name))
            elif ENQUEUE.match(name):
                enqueued.setdefault(e.correlation_id(), e.start_ns())
        elif not e.is_user_annotation() and name != "Command Buffer Full":
            ops.append((e.correlation_id(), e.end_ns() - e.start_ns()))
    rows = {name: {"name": name, "calls": 0, "host_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0}
            for _, _, name in spans}
    for s, neg_e, name in spans:
        rows[name]["calls"] += 1
        rows[name]["host_ms"] += (-neg_e - s) * 1e-6
    timed = sorted((enqueued[corr], dur) for corr, dur in ops if corr in enqueued)
    spans.sort()
    stack, i = [], 0
    for t, dur in timed:  # the spans open at each enqueue call, innermost last
        while i < len(spans) and spans[i][0] <= t:
            while stack and -stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and -stack[-1][1] <= t:
            stack.pop()
        if stack:
            rows[stack[-1][2]]["self_device_ms"] += dur * 1e-6
            for name in {sp[2] for sp in stack}:
                rows[name]["device_ms"] += dur * 1e-6
    return sorted(rows.values(), key=lambda r: (-r["self_device_ms"], r["name"]))


def summarize(prof, wall_s: float, top: int = 12) -> dict:
    """A profiled run's summary: the device's busy time, the union of the
    intervals of its kernels, copies and fills (each counted once: the
    operators' own device-time totals repeat their kernels' time), its share
    of ``wall_s``, the operators and kernels that take the most device
    time, and the program's spans (:func:`span_layers`).  A trace without
    device events lists operators by CPU time."""
    from torch.autograd import DeviceType

    spans = device_intervals(prof.events())
    busy_us = union_us(spans)
    rows = list(prof.key_averages())
    on_device = any(e.self_device_time_total > 0 for e in rows)

    def listing(device_type):
        key = (lambda e: e.self_device_time_total) if on_device else (lambda e: e.self_cpu_time_total)
        picked = sorted((e for e in rows if e.device_type == device_type and key(e) > 0), key=lambda e: -key(e))[:top]
        return [
            {"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total * 1e-3,
             "cpu_ms": e.self_cpu_time_total * 1e-3}
            for e in picked
        ]

    return {
        "wall_s": wall_s,
        "device_events": len(spans),
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s,
        "top_ops": listing(DeviceType.CPU),
        "top_kernels": listing(DeviceType.CUDA),
        "layers": span_layers(prof),
    }


def profile_run(run, top: int = 12, trace_dir: str | None = None) -> dict:
    """One more run of a loop (``run()`` returns its wall seconds) under
    :func:`~wtracker_tpu_torch.utils.profiling.device_trace` (CPU and, where
    a card is visible, CUDA activities); :func:`summarize`\\ d, and exported
    as a Chrome trace into ``trace_dir`` when given (``"trace"`` in the
    result)."""
    from wtracker_tpu_torch.utils.profiling import device_trace

    with device_trace(trace_dir or None) as prof:
        wall_s = run()
    out = summarize(prof, wall_s, top)
    if prof.trace_path:
        out["trace"] = prof.trace_path
    return out


def load_trace(path: str) -> dict:
    """Read an exported Chrome trace (a file, or the newest ``*.json`` under a
    directory): ``{"device_ms": summed device event time, "kernels": {name:
    ms}, "ops": {name: ms}}``, kernels being the device events (kernels,
    copies, fills) and ops the CPU operators (inclusive times)."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True), key=os.path.getmtime)
        if not found:
            raise FileNotFoundError(f"no torch.profiler trace (*.json) under {path}")
        path = found[-1]
    elif not os.path.isfile(path):
        raise FileNotFoundError(f"no torch.profiler trace at {path}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels: dict[str, float] = {}
    ops: dict[str, float] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        table = kernels if cat in DEVICE_CATEGORIES else ops if cat == "cpu_op" else None
        if table is not None:
            table[ev["name"]] = table.get(ev["name"], 0.0) + float(ev.get("dur", 0.0)) * 1e-3
    return {"device_ms": sum(kernels.values()), "kernels": kernels, "ops": ops}


def trace(variant: str = "bf16", streams: int = 96, cycles: int = 12, top: int = 25, trace_dir: str | None = None,
          detector=CHECKPOINT, imgsz: int = 416, device="cuda") -> dict:
    """Builds the loop, runs a warm-up window, then one under the profiler:
    the :func:`summarize` result with the busy ms per cycle and the device
    ceiling in steps/s (streams x cycles x frames a cycle over busy time)."""
    from wtracker_tpu_torch.tools.bench import build_flagship

    ctx = build_flagship(S=streams, n_cycles=cycles, detector=detector, imgsz=imgsz, device=device)
    ctl = ctx.make_ctl(variant)

    def run() -> float:
        t0 = time.perf_counter()
        ctx.run(ctl).positions.sum().item()  # waits for the window's last step
        return time.perf_counter() - t0

    warm_s = run()
    out = profile_run(run, top, trace_dir)
    busy_ms = out["device_busy_s"] * 1e3
    steps = ctx.steps
    return {
        "variant": variant, "streams": streams, "cycles": cycles, "device": str(device), "warmup_s": warm_s,
        "busy_ms_per_cycle": busy_ms / cycles,
        "device_ceiling_steps_per_s": steps / out["device_busy_s"] if busy_ms else None,
        **out,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variant", nargs="?", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--streams", type=int, default=96)
    ap.add_argument("--cycles", type=int, default=12)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-dir", help="export the Chrome trace into this directory")
    ap.add_argument("--detector", default=str(CHECKPOINT), help="detector weights (.npz)")
    ap.add_argument("--imgsz", type=int, default=416)
    ap.add_argument("--device", default="cuda", help="torch device of the loop (default: cuda)")
    args = ap.parse_args(argv)

    out = trace(args.variant, args.streams, args.cycles, args.top, args.trace_dir, args.detector, args.imgsz, args.device)
    print(f"{args.variant}, S={args.streams}, {args.cycles} cycles: wall {out['wall_s'] * 1e3:.1f} ms, device busy "
          f"{out['device_busy_s'] * 1e3:.1f} ms ({out['device_busy_share']:.3f} of the wall), "
          f"{out['busy_ms_per_cycle']:.2f} ms a cycle")
    column = "device_ms" if out["device_events"] else "cpu_ms"
    for title, rows in (("operators", out["top_ops"]), ("kernels", out["top_kernels"])):
        total = sum(r[column] for r in rows) or 1.0
        print(f"\ntop {len(rows)} {title} by {column}:")
        for r in rows:
            print(f"  {r[column]:9.3f} ms  {r[column] / total * 100:5.1f}%  x{r['calls']:<6d} {r['name']}")
    print("\nspans: device ms self / total, host ms")
    for r in out["layers"]:
        print(f"  {r['self_device_ms']:9.3f} / {r['device_ms']:9.3f} ms  {r['host_ms']:9.3f} ms  x{r['calls']:<6d} "
              f"{r['name']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
