"""The operation and byte counts the rooflines and the mfu divide by."""

import json

from tiny_cell import REPO

from benchmark import counting

CONFIG = json.loads((REPO / "benchmark" / "configs" / "yolov8s-416-bf16.json").read_text())


def test_two_layers_by_hand():
    convs = {c.name: c for c in counting.yolov8_convs(CONFIG)}
    # b0: 3 -> 32 channels, 3x3, stride 2, 416 -> 208
    assert convs["b0"].macs == 208 * 208 * 32 * 3 * 3 * 3
    # b4's first bottleneck: 64 -> 64, 3x3 at 52 x 52
    assert convs["b4.m_0.cv1"].macs == 52 * 52 * 64 * 9 * 64
    assert len(convs) == 63


def test_total_against_ultralytics():
    """Ultralytics publishes 28.6 GFLOPs for YOLOv8s at 640 px and 80
    classes; the count gives it to the digit there, and 12.01 GFLOP at 416
    px and one class (the published figure scaled by (416/640)^2 is 12.08:
    the 79 fewer class channels of the head and the grid's rounding)."""
    assert round(counting.ops_per_view(dict(CONFIG, nc=80, imgsz=640)) / 1e9, 1) == 28.6
    ops = counting.ops_per_view(CONFIG)
    assert abs(ops / 1e9 - 12.012) < 1e-3
    assert abs(ops / 1e9 - 28.6 * (416 / 640) ** 2) < 0.1


def test_k2_bound_at_12_views():
    """PERF.md's K2 bound at N=12 (the unfolded forward's 63 convolutions):
    0.0728 ms of operations alone, 0.1183 ms summing each convolution's
    larger bound (most of them bound by their bytes)."""
    work = [counting.k2_work(c, 12) for c in counting.yolov8_convs(CONFIG)]
    assert abs(sum(o for o, _ in work) / 1979e12 * 1e3 - 0.0728) < 5e-5
    assert abs(counting.bound_s(work, 1979e12) * 1e3 - 0.1183) < 5e-5
