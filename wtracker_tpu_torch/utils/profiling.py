"""Profiling and timing instrumentation.

Port of :mod:`wtracker_tpu.utils.profiling`: :func:`device_trace`, a
``torch.profiler`` run over the host and the card that writes a trace file
(open it in Perfetto or ``chrome://tracing``), and :class:`StageTimer`, a
host-side stage breakdown whose stages end only once the work they queued
on the card has finished.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where a card is
    visible, CUDA activities) and write its trace to
    ``log_dir/trace_<pid>_<ns>.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize_used_devices() -> None:
    """Wait for every CUDA device this process has initialised (a process
    that never touched a card waits for nothing)."""
    if not torch.cuda.is_initialized():
        return
    has_context = getattr(torch._C, "_cuda_hasPrimaryContext", lambda i: True)
    for i in range(torch.cuda.device_count()):
        if has_context(i):  # a device without a context has run nothing
            torch.cuda.synchronize(i)


@dataclass
class StageTimer:
    """Accumulates wall time per named stage; with ``sync`` (the default) a
    stage ends only after every CUDA device the process uses is idle.

    Usage::

        timer = StageTimer()
        with timer("detect"):
            out = detect(frames)
        ...
        print(timer.report())
    """

    sync: bool = True
    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _synchronize_used_devices()  # wait for everything queued inside the block
            dt = time.perf_counter() - start
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for stage, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[stage]
            lines.append(
                f"{stage:24s} {t * 1e3:9.1f} ms  ({n}x, {t / n * 1e3:7.2f} ms/call, {t / total * 100:4.1f}%)"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
