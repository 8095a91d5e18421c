"""Bounding-box operations on tensors.

Port of :mod:`wtracker_tpu.ops.boxes`, the device twin of
:mod:`wtracker_tpu_torch.utils.bbox`: pure functions on ``(..., 4)`` tensors
with no data-dependent shapes; NaN boxes flow through and are masked by the
callers.
"""

from __future__ import annotations

import torch

from wtracker_tpu_torch.utils.bbox import BoxFormat

__all__ = [
    "BoxFormat",
    "to_xyxy",
    "to_xywh",
    "to_yolo",
    "center",
    "round_boxes",
    "discretize",
    "box_iou",
    "intersect_area",
]


def to_xyxy(bbox: torch.Tensor, src_format: BoxFormat = BoxFormat.XYWH) -> torch.Tensor:
    if src_format == BoxFormat.XYXY:
        return bbox
    xy = bbox[..., :2]
    if src_format == BoxFormat.YOLO:
        xy = xy - bbox[..., 2:] / 2
    return torch.cat([xy, xy + bbox[..., 2:]], dim=-1)


def to_xywh(bbox: torch.Tensor, src_format: BoxFormat = BoxFormat.XYXY) -> torch.Tensor:
    if src_format == BoxFormat.XYWH:
        return bbox
    if src_format == BoxFormat.XYXY:
        return torch.cat([bbox[..., :2], bbox[..., 2:] - bbox[..., :2]], dim=-1)
    return torch.cat([bbox[..., :2] - bbox[..., 2:] / 2, bbox[..., 2:]], dim=-1)


def to_yolo(bbox: torch.Tensor, src_format: BoxFormat) -> torch.Tensor:
    if src_format == BoxFormat.YOLO:
        return bbox
    wh = bbox[..., 2:] - bbox[..., :2] if src_format == BoxFormat.XYXY else bbox[..., 2:]
    return torch.cat([bbox[..., :2] + wh / 2, wh], dim=-1)


def center(bboxes: torch.Tensor, box_format: BoxFormat = BoxFormat.XYWH) -> torch.Tensor:
    b = to_xywh(bboxes, box_format)
    return b[..., :2] + b[..., 2:] / 2


def round_boxes(bboxes: torch.Tensor, box_format: BoxFormat) -> torch.Tensor:
    """Outward-round to integer pixels: floor the top-left, ceil the bottom-right."""
    b = to_xyxy(bboxes, box_format)
    out = torch.cat([torch.floor(b[..., :2]), torch.ceil(b[..., 2:])], dim=-1)
    out = torch.nan_to_num(out, nan=0.0).to(torch.int32)  # XLA casts NaN to 0
    if box_format == BoxFormat.XYXY:
        return out
    return to_xywh(out, BoxFormat.XYXY) if box_format == BoxFormat.XYWH else to_yolo(out, BoxFormat.XYXY)


def discretize(
    bboxes: torch.Tensor,
    bounds: tuple[int, int],
    box_format: BoxFormat,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp to ``bounds`` = (h, w) and flag legal boxes; illegal ones become zeros."""
    finite = torch.isfinite(bboxes).all(dim=-1)
    bboxes = torch.where(finite[..., None], bboxes, 0.0)

    b = round_boxes(to_xyxy(bboxes, box_format), BoxFormat.XYXY)
    h, w = bounds
    x = b[..., 0::2].clamp(0, w)
    y = b[..., 1::2].clamp(0, h)
    b = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)

    is_legal = finite & (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
    b = torch.where(is_legal[..., None], b, 0).to(torch.int32)
    if box_format != BoxFormat.XYXY:
        b = to_xywh(b, BoxFormat.XYXY) if box_format == BoxFormat.XYWH else to_yolo(b, BoxFormat.XYXY)
    return b, is_legal


def intersect_area(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection area of two aligned box tensors (XYXY)."""
    tl = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    br = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh = (br - tl).clamp_min(0)
    return wh[..., 0] * wh[..., 1]


def box_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two aligned box tensors (XYXY)."""
    inter = intersect_area(a_xyxy, b_xyxy)
    area_a = (a_xyxy[..., 2] - a_xyxy[..., 0]) * (a_xyxy[..., 3] - a_xyxy[..., 1])
    area_b = (b_xyxy[..., 2] - b_xyxy[..., 0]) * (b_xyxy[..., 3] - b_xyxy[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1), 0.0)
