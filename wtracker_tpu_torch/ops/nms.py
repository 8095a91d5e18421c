"""Greedy fixed-size non-maximum suppression.

Port of :mod:`wtracker_tpu.ops.nms`: ``max_det`` output slots filled one
per step; each step takes the first maximum of the live scores, keeps it if
it clears ``score_threshold``, and drops every live candidate whose IoU with
it is above ``iou_threshold``.  :func:`batched_nms` runs the steps for a
whole batch at once (each a handful of tensor ops over (B, A)), never a
Python loop over images, and never reads a value back to the host.
"""

from __future__ import annotations

import torch


def _iou_one_vs_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of each image's (B, 4) ``box`` with its (B, A, 4) ``boxes`` → (B, A)."""
    box = box[:, None, :]
    tl = torch.maximum(box[..., :2], boxes[..., :2])
    br = torch.minimum(box[..., 2:], boxes[..., 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (box[..., 2] - box[..., 0]).clamp_min(0.0) * (box[..., 3] - box[..., 1]).clamp_min(0.0)
    area_b = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.1,
    max_det: int = 100,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over a batch: (B, A, 4) xyxy candidates and (B, A) scores
    → (B, max_det, 4) boxes, (B, max_det) scores and (B, max_det) validity.
    Invalid slots hold zeros."""
    b, a = scores.shape
    dev = scores.device
    rows = torch.arange(b, device=dev)
    anchors = torch.arange(a, device=dev)
    live = scores >= score_threshold
    out_boxes = boxes.new_zeros((b, max_det, 4))
    out_scores = scores.new_zeros((b, max_det))
    out_valid = torch.zeros((b, max_det), dtype=torch.bool, device=dev)
    slot = torch.zeros(b, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    for _ in range(max_det):
        idx = torch.where(live, scores, neg_inf).argmax(dim=1)  # first maximum
        best = scores[rows, idx]
        ok = live[rows, idx] & (best >= score_threshold)
        box = boxes[rows, idx]
        suppress = _iou_one_vs_many(box, boxes) > iou_threshold
        live = live & ~suppress & (anchors[None, :] != idx[:, None])

        out_boxes[rows, slot] = torch.where(ok[:, None], box, out_boxes[rows, slot])
        out_scores[rows, slot] = torch.where(ok, best, out_scores[rows, slot])
        out_valid[rows, slot] = out_valid[rows, slot] | ok
        slot = slot + ok.long()
    return out_boxes, out_scores, out_valid


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.1,
    max_det: int = 100,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over one image: (A, 4) xyxy and (A,) scores → (max_det, 4)
    boxes, (max_det,) scores and (max_det,) validity."""
    out = batched_nms(boxes[None], scores[None], iou_threshold, score_threshold, max_det)
    return tuple(t[0] for t in out)
