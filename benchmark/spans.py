"""The card's time by the program's spans: each device operation of a traced
run given to the innermost ``wt.*`` span (``wtracker_tpu_torch/utils/
profiling.py::span``) that was open on the host when its enqueue call began.

``trace.record`` keeps the host's runtime and driver calls in
``host_ops`` but not their correlation ids, so calls and operations are
paired in order, kind by kind: the loop runs on one stream, so the k-th
kernel launch enqueued the k-th kernel, the k-th copy call the k-th copy
and the k-th fill call the k-th fill (a call made inside another such
call, a runtime call's own driver call, is the same enqueue).  The pairing
is checked: each kind's counts must be equal and every operation must
start after its call began, less ``CLOCK_STEP_NS``: CUPTI's device
timestamps can step back by some milliseconds in the middle of a trace (up
to 9.7 ms in the loop cells' traces on an H100, torch 2.11), so operations
that start on an idle card just after the step read as starting before
their calls.  Where a check fails, or the trace holds no ``wt.*`` span or
no ``wt.cycle`` span, :func:`layers` returns None and so does every reader.

Each span name's **self** time is the summed device time of the operations
given to it; a layer's metric is its self time over the run's cycles (the
``wt.cycle`` spans).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

PREFIX = "wt."
CYCLE = "wt.cycle"
ENQUEUE = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")
PSEUDO = ("Command Buffer Full",)  # device events that no call enqueued
CLOCK_STEP_NS = 50_000_000  # the device clock's largest step back admitted (5x the largest seen)
KINDS = ("Memcpy", "Memset")  # else a kernel

# the span names with a metric of their own; every other ``wt.*`` name
# (``wt.run``, ``wt.cycle``, ``wt.detect``) is the engine's
LAYER_SPANS = {
    "detector": "wt.detector",
    "preprocess": "wt.preprocess",
    "render": "wt.render",
    "decode": "wt.decode",
    "predictor": "wt.predict",
    "motor": "wt.motor",
}


@dataclass
class Layers:
    self_ns: dict[str, int]  # span name -> summed device ns of its own operations
    counts: dict[str, int]  # span name -> spans opened
    attributed_ns: int  # device ns enqueued inside some span
    total_ns: int  # device ns of every paired operation

    @property
    def cycles(self) -> int:
        return self.counts.get(CYCLE, 0)

    def ms_per_cycle(self, ns: int) -> float:
        return ns * 1e-6 / self.cycles


def enqueue_calls(host_ops: list[tuple[str, int, int]]) -> list[tuple[str, int, int]]:
    """The calls that enqueue device work, in order, a call inside another
    such call left out."""
    calls, end = [], None
    for name, s, e in sorted((op for op in host_ops if ENQUEUE.match(op[0])), key=lambda op: (op[1], -op[2])):
        if end is not None and s < end and e <= end:
            continue  # made by the enclosing call
        calls.append((name, s, e))
        end = e
    return calls


def kind(name: str) -> str:
    """``Memcpy``, ``Memset`` or ``kernel``: of a device operation (``Memcpy
    HtoD ...``) or of the call that enqueued it (``cudaMemcpyAsync``)."""
    return next((k for k in KINDS if k in name[:16]), "kernel")


def innermost(spans: list[tuple[str, int, int]], times: list[int]) -> list[str | None]:
    """For each of the sorted ``times``, the name of the innermost span open
    at it (spans nest: one host thread), or None."""
    out, stack, i = [], [], 0
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            name, s, e = spans[i]
            while stack and stack[-1][2] <= s:
                stack.pop()
            stack.append((name, s, e))
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def attribute(tr) -> Layers | None:
    """The traced run's device time by span name, or None where the pairing
    does not hold or the run opened no span."""
    spans = [op for op in tr.host_ops if op[0].startswith(PREFIX)]
    if not spans:
        return None
    every_call, pairs = enqueue_calls(tr.host_ops), []
    for k in ("kernel", *KINDS):
        calls = [c for c in every_call if kind(c[0]) == k]
        ops = sorted((s, e) for name, s, e in tr.device_ops if name not in PSEUDO and kind(name) == k)
        if len(calls) != len(ops) or any(op[0] < call[1] - CLOCK_STEP_NS for op, call in zip(ops, calls)):
            return None
        pairs += [(call[1], op) for call, op in zip(calls, ops)]
    if not pairs:
        return None
    pairs.sort()
    owners = innermost(spans, [t for t, _ in pairs])
    ops = [op for _, op in pairs]
    self_ns: dict[str, int] = {}
    total = attributed = 0
    for owner, (s, e) in zip(owners, ops):
        total += e - s
        if owner is not None:
            self_ns[owner] = self_ns.get(owner, 0) + (e - s)
            attributed += e - s
    counts: dict[str, int] = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    out = Layers(self_ns=self_ns, counts=counts, attributed_ns=attributed, total_ns=total)
    return out if out.cycles else None


_last: tuple = (None, None)


def layers(ctx) -> Layers | None:
    """:func:`attribute` of ``ctx.trace``, computed once for all readers."""
    global _last
    if not ctx.on_device:
        return None
    if _last[0] is not ctx.trace:
        _last = (ctx.trace, attribute(ctx.trace))
    return _last[1]


def layer_ms(ctx, layer: str) -> float | None:
    """Device ms a cycle of one layer's own operations (``LAYER_SPANS``), or
    None where its span never opened."""
    lay = layers(ctx)
    name = LAYER_SPANS[layer]
    if lay is None or not lay.counts.get(name):
        return None
    return lay.ms_per_cycle(lay.self_ns.get(name, 0))


def engine_ms(ctx) -> float | None:
    """Device ms a cycle of the operations of every span without a metric of
    its own (``wt.run``, ``wt.cycle``, ``wt.detect``)."""
    lay = layers(ctx)
    if lay is None:
        return None
    own = set(LAYER_SPANS.values())
    return lay.ms_per_cycle(sum(ns for name, ns in lay.self_ns.items() if name not in own))
