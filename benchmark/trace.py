"""The device trace of a traced stretch: ``torch.profiler`` over the card
(CUPTI), read into kernel intervals, the card's busy time, and a breakdown.

The arithmetic is a copy of the port's ``tools/bench.py::call_busy_s`` and
``_is_kernel``: busy time is the union of the device operations' intervals,
overlaps counted once and gaps not at all; a kernel is a device event that is
not a copy, a fill or a range annotation.  ``TEARDOWN_CUPTI=1`` is set before
the session (without it a session leaves every later launch of the process
slower).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

WINDOW_RANGE = "benchmark_traced_window"
SHORT_GAP_S = 5e-6  # gaps shorter than this are summed under one label
NAME_CHARS = 160


@dataclass
class Trace:
    window_ns: tuple[int, int]  # the traced stretch on the trace's clock
    kernels: list[tuple[str, int, int]] = field(default_factory=list)  # (name, start_ns, end_ns)
    device_ops: list[tuple[str, int, int]] = field(default_factory=list)  # kernels, copies and fills
    host_ops: list[tuple[str, int, int]] = field(default_factory=list)  # CPU-side events


def union_s(spans: list[tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds covered by the union of ``spans`` (ns) clipped to [lo, hi]."""
    total, end = 0, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def idle_gaps(spans: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no span covers."""
    gaps, cursor = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    return gaps


def is_kernel(name: str, annotation: bool) -> bool:
    return not (name.startswith(("Memcpy", "Memset")) or annotation)


def record(run) -> tuple[Trace, object]:
    """``run()`` under ``torch.profiler`` (CPU and CUDA activities) inside a
    range of its own; returns the trace and ``run``'s result.  ``run`` must
    end with the card idle (a synchronise or a copy to the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_RANGE):
            out = run()
    tr = Trace(window_ns=(0, 0))
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW_RANGE:
                tr.window_ns = (s, t)
            elif t > s:
                tr.host_ops.append((name, s, t))
        else:
            annotation = e.is_user_annotation()
            if not annotation:
                tr.device_ops.append((name, s, t))
            if is_kernel(name, annotation):
                tr.kernels.append((name, s, t))
    if tr.window_ns == (0, 0):
        raise RuntimeError("the trace holds no window range")
    return tr, out


def busy_s(tr: Trace) -> float:
    lo, hi = tr.window_ns
    return union_s([(s, e) for _, s, e in tr.device_ops], lo, hi)


def traced_window_s(tr: Trace) -> float:
    lo, hi = tr.window_ns
    return (hi - lo) * 1e-9


def kernel_seconds(tr: Trace, match) -> float:
    """Summed device seconds of the kernels whose name ``match`` accepts."""
    return sum(e - s for name, s, e in tr.kernels if match(name)) * 1e-9


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took the most time (summed by name) and the
    longest idle time by what the host was doing (the innermost host event
    running at each gap's middle; gaps under ``SHORT_GAP_S`` summed apart)."""
    lo, hi = tr.window_ns
    by_name: dict[str, int] = {}
    for name, s, e in tr.device_ops:
        by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0) + (min(e, hi) - max(s, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    host = sorted(tr.host_ops, key=lambda h: h[1])
    starts = np.array([s for _, s, _ in host], dtype=np.int64)
    gaps: dict[str, int] = {}
    short = f"gaps under {SHORT_GAP_S * 1e6:g} us"
    for g0, g1 in idle_gaps([(s, e) for _, s, e in tr.device_ops], lo, hi):
        if (g1 - g0) * 1e-9 < SHORT_GAP_S:
            label = short
        else:
            mid = (g0 + g1) // 2
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            label = "host outside any op"
            for j in range(i, max(i - 200, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0][:NAME_CHARS]
                    break
        gaps[label] = gaps.get(label, 0) + (g1 - g0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops], "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
