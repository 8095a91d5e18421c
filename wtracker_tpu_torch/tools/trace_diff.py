"""Diff two exported ``torch.profiler`` traces: where did the device time move?

Port of the JAX package's ``tools/trace_diff.py``.  Pairs with
``trace_profile`` (run each variant with its own ``--trace-dir``): it groups
the kernels of each trace under a normalised name (template arguments,
parameter lists and instance suffixes stripped, so the instantiations of one
kernel meet) and prints the largest deltas in device ms.  Traces without
device events (CPU runs) are compared by their operators.

Usage::

    python -m wtracker_tpu_torch.tools.trace_diff TRACE_A TRACE_B [--top 20]

(each a trace file or a directory: its newest ``*.json``).
"""

from __future__ import annotations

import argparse
import re

from wtracker_tpu_torch.tools.trace_profile import load_trace


def _normalize(name: str) -> str:
    """The kernel's name without its instance: ``void ns::k<4, float>(int,
    float*)`` -> ``ns::k``, ``fusion.123`` -> ``fusion``; a namespace such
    as ``(anonymous namespace)`` stays."""
    name = name.removeprefix("void ").split("%")[-1]
    while True:  # innermost template argument lists first
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    name = name.strip()
    if name.endswith(")"):  # the parameter list: the last balanced group
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"\.\d+$", "", name)


def load(path: str) -> tuple[float, dict[str, float], str]:
    """(total ms, {normalised name: ms}, "device" or "cpu") of a trace: its
    device events, or its operators when it has none."""
    t = load_trace(path)
    kind = "device" if t["kernels"] else "cpu"
    grouped: dict[str, float] = {}
    for name, ms in (t["kernels"] if kind == "device" else t["ops"]).items():
        key = _normalize(name)
        grouped[key] = grouped.get(key, 0.0) + ms
    return sum(grouped.values()), grouped, kind


def diff(a: str, b: str, top: int = 20) -> list[tuple[str, float, float]]:
    """The ``top`` names whose time moved most from trace ``a`` to ``b``:
    ``(name, a ms, b ms)``, largest change first."""
    _, ops_a, kind_a = load(a)
    _, ops_b, kind_b = load(b)
    if kind_a != kind_b:
        raise ValueError(f"cannot compare a {kind_a} trace with a {kind_b} trace")
    keys = sorted(set(ops_a) | set(ops_b), key=lambda k: -abs(ops_b.get(k, 0.0) - ops_a.get(k, 0.0)))
    return [(k, ops_a.get(k, 0.0), ops_b.get(k, 0.0)) for k in keys[:top]]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_a")
    ap.add_argument("trace_b")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    ms_a, _, kind = load(args.trace_a)
    ms_b, _, _ = load(args.trace_b)
    print(f"A = {args.trace_a}: {ms_a:.3f} ms {kind} total")
    print(f"B = {args.trace_b}: {ms_b:.3f} ms {kind} total   (B-A: {ms_b - ms_a:+.3f} ms)")
    print(f"\n{'delta ms':>10} {'A ms':>9} {'B ms':>9}  {'kernel' if kind == 'device' else 'operator'}")
    for name, a, b in diff(args.trace_a, args.trace_b, args.top):
        print(f"{b - a:>+10.3f} {a:>9.3f} {b:>9.3f}  {name[:90]}")


if __name__ == "__main__":
    main()
