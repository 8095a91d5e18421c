"""The trace arithmetic: the union of intervals, the idle gaps, the
breakdown and the per-layer readers on a synthetic trace."""

import types

import pytest

from tiny_cell import REPO  # noqa: F401

from benchmark import trace
from benchmark.run import metric_reader


def test_union_overlaps_once_gaps_never():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.union_s(spans, 0, 100) == pytest.approx(25e-9)
    assert trace.union_s(spans, 8, 22) == pytest.approx(9e-9)
    assert trace.idle_gaps(spans, 0, 40) == [(15, 20), (30, 40)]


def _trace():
    tr = trace.Trace(window_ns=(0, 100_000))
    tr.device_ops = [("convA_fprop", 0, 30_000), ("silu", 30_000, 40_000), ("Memcpy DtoH", 90_000, 95_000)]
    tr.kernels = tr.device_ops[:2]
    tr.host_ops = [("aten::cat", 40_000, 80_000), ("aten::item", 80_000, 100_000)]
    return tr


def test_breakdown_labels_gaps_by_host_op():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["convA_fprop", 30_000e-9]
    assert dict(b["idle_gaps"]) == pytest.approx({"aten::cat": 50_000e-9, "aten::item": 5_000e-9})


def test_readers_on_a_synthetic_trace():
    tr = _trace()
    busy = trace.busy_s(tr)
    ctx = types.SimpleNamespace(trace=tr, busy_s=busy, window_s=1e-4, on_device=True, device_cycles=2,
                                config={"peak_ops_per_s": 1e15}, precision="bf16", stem_folded=True,
                                views=0, batches=[])
    assert abs(metric_reader("device_idle_share")(ctx) - 55.0) < 1e-9
    assert metric_reader("launches_per_cycle")(ctx) == 1.0
    assert metric_reader("k2_roofline")(ctx) is None  # a bf16 run has no K2 to read
    off = types.SimpleNamespace(**{**vars(ctx), "on_device": False})
    assert metric_reader("device_idle_share")(off) is None
