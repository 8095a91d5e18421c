"""Profiling and timing instrumentation.

Port of :mod:`wtracker_tpu.utils.profiling`: :func:`device_trace`, a
``torch.profiler`` run over the host and the card that writes a trace file
(open it in Perfetto or ``chrome://tracing``), and :class:`StageTimer`, a
host-side stage breakdown whose stages end only once the work they queued
on the card has finished.

:func:`span` names a stretch of the program (``wt.cycle``, ``wt.detector``,
...) in the trace of any ``torch.profiler`` session, on the clock of the
device operations it enqueues; with no session running it costs one flag
read.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the enclosed stretch of the program
    ``name`` in the trace: ``torch.profiler.record_function(name)`` while a
    ``torch.profiler`` session runs (any session: :func:`device_trace`,
    ``tools/trace_profile.py``, a benchmark's traced run), so the stretch
    and the device operations enqueued inside it share the trace's clock,
    and nested spans name their parent.  Otherwise one shared null context:
    no allocation, no dispatcher call.  A span never synchronises the card
    or reads a device value."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU and, where a card is
    visible, CUDA activities) and, with ``log_dir``, write its trace to
    ``log_dir/trace_<pid>_<ns>.json``.  Yields the profiler, whose
    ``trace_path`` names the file written once the block has ended (None
    without ``log_dir``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, acc_events=True) as prof:
        prof.trace_path = None
        yield prof
    if log_dir is not None:
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


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
