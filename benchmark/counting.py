"""Operations and bytes of the detector's convolutions, counted from the
layer shapes of Ultralytics' ``yolov8.yaml`` at a configuration's scale
(depth and width multiples, channel cap), class count and input size: the
same work whatever implements it (folded stem or not, fused or not).

An operation is a multiply or an add: 2 per multiply-accumulate, the
convention of Ultralytics' GFLOPs.  Biases, activations, concatenations,
pooling, upsampling and the box decode are not counted (under 1 % of the
convolutions' operations at these sizes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

# H100 SXM (NVIDIA's data sheet, dense): HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12


class Conv(NamedTuple):
    name: str
    h: int  # input rows
    w: int  # input columns
    cin: int
    cout: int
    k: int
    stride: int

    @property
    def out_hw(self) -> tuple[int, int]:
        p = self.k // 2
        return (self.h + 2 * p - self.k) // self.stride + 1, (self.w + 2 * p - self.k) // self.stride + 1

    @property
    def macs(self) -> int:
        ho, wo = self.out_hw
        return ho * wo * self.cout * self.k * self.k * self.cin


def _divisible(x: float, d: int = 8) -> int:
    return int(math.ceil(x / d) * d)


def yolov8_convs(config: dict) -> list[Conv]:
    """Every convolution of one view's forward, in graph order (``b0`` first)."""
    depth, width, cap = float(config["depth_multiple"]), float(config["width_multiple"]), int(config["max_channels"])
    nc, reg_max, s = int(config["nc"]), int(config.get("reg_max", 16)), int(config["imgsz"])

    def ch(c):
        return _divisible(min(c, cap) * width)

    def rep(n):
        return max(round(n * depth), 1)

    convs: list[Conv] = []

    def conv(name, hw, cin, cout, k=1, stride=1):
        convs.append(Conv(name, hw, hw, cin, cout, k, stride))
        return convs[-1].out_hw[0]

    def c2f(name, hw, cin, cout, n):
        h = cout // 2
        conv(f"{name}.cv1", hw, cin, 2 * h)
        for i in range(n):
            conv(f"{name}.m_{i}.cv1", hw, h, h, 3)
            conv(f"{name}.m_{i}.cv2", hw, h, h, 3)
        conv(f"{name}.cv2", hw, (2 + n) * h, cout)
        return hw

    c1, c2, c3, c4, c5 = ch(64), ch(128), ch(256), ch(512), ch(1024)
    hw = conv("b0", s, 3, c1, 3, 2)
    hw = conv("b1", hw, c1, c2, 3, 2)
    hw = c2f("b2", hw, c2, c2, rep(3))
    hw3 = conv("b3", hw, c2, c3, 3, 2)
    c2f("b4", hw3, c3, c3, rep(6))
    hw4 = conv("b5", hw3, c3, c4, 3, 2)
    c2f("b6", hw4, c4, c4, rep(6))
    hw5 = conv("b7", hw4, c4, c5, 3, 2)
    c2f("b8", hw5, c5, c5, rep(3))
    conv("b9.cv1", hw5, c5, c5 // 2)
    conv("b9.cv2", hw5, 4 * (c5 // 2), c5)
    c2f("n12", hw4, c5 + c4, c4, rep(3))
    c2f("n15", hw3, c4 + c3, c3, rep(3))
    conv("n16", hw3, c3, c3, 3, 2)
    c2f("n18", hw4, c3 + c4, c4, rep(3))
    conv("n19", hw4, c4, c4, 3, 2)
    c2f("n21", hw5, c4 + c5, c5, rep(3))
    box_ch, cls_ch = max(16, c3 // 4, 4 * reg_max), max(c3, min(nc, 100))
    for i, (hw_i, c) in enumerate(((hw3, c3), (hw4, c4), (hw5, c5))):
        conv(f"head.cv2_{i}_0", hw_i, c, box_ch, 3)
        conv(f"head.cv2_{i}_1", hw_i, box_ch, box_ch, 3)
        conv(f"head.cv2_{i}_2", hw_i, box_ch, 4 * reg_max)
        conv(f"head.cv3_{i}_0", hw_i, c, cls_ch, 3)
        conv(f"head.cv3_{i}_1", hw_i, cls_ch, cls_ch, 3)
        conv(f"head.cv3_{i}_2", hw_i, cls_ch, nc)
    return convs


def ops_per_view(config: dict) -> int:
    """The detector's operations on one view (2 per multiply-accumulate)."""
    return 2 * sum(c.macs for c in yolov8_convs(config))


def is_logits(conv: Conv) -> bool:
    """The head's last convolutions, whose outputs are logits."""
    return conv.name.startswith("head.") and conv.name.endswith("_2")


def conv_bytes(conv: Conv, n: int, in_bytes: int, w_bytes: int, out_bytes: int, per_channel_bytes: int) -> int:
    """Bytes that ``n`` views' convolution must move at the least: the input
    read once, the weights and per-channel vectors read once, the output
    written once."""
    ho, wo = conv.out_hw
    return (n * conv.h * conv.w * conv.cin * in_bytes + conv.k * conv.k * conv.cin * conv.cout * w_bytes
            + per_channel_bytes * conv.cout + n * ho * wo * conv.cout * out_bytes)


def k2_work(conv: Conv, n: int) -> tuple[int, int]:
    """(operations, bytes) of the int8 convolution kernel K2 on ``n`` views:
    int8 input and weights, a float32 scale and bias a channel, int8 output
    (bf16 for the head's logits)."""
    return 2 * n * conv.macs, conv_bytes(conv, n, 1, 1, 2 if is_logits(conv) else 1, 8)


def bf16_conv_work(conv: Conv, n: int) -> tuple[int, int]:
    """(operations, bytes) of a bf16 convolution on ``n`` views: bf16 input,
    weights, bias and output."""
    return 2 * n * conv.macs, conv_bytes(conv, n, 2, 2, 2, 2)


def bound_s(work: list[tuple[int, int]], peak_ops: float) -> float:
    """The least time of a list of (operations, bytes): each call's larger of
    its operations at ``peak_ops`` and its bytes at the HBM peak, summed."""
    return sum(max(o / peak_ops, b / PEAK_BYTES_PER_S) for o, b in work)
