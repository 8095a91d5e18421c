"""YOLOv8 detection training: task-aligned assignment and the CIoU, DFL and
BCE losses.

Port of :mod:`wtracker_tpu.neural.yolo_training` (the reference hands
detector training to ultralytics; yolo/yolo_train_config.yaml: YOLOv8s,
imgsz 384, batch 72, AdamW, one class):

* :func:`task_aligned_assigner`: the TAL matching of predictions to ground
  truth (align metric ``score^α·IoU^β``, the top k anchors whose centre lies
  inside each gt box, an anchor claimed by several gts going to the one of
  highest IoU);
* :func:`detection_loss`: BCE against the normalised align metric, CIoU box
  loss and distribution-focal loss on the two bins next to the target, with
  gains 7.5 / 0.5 / 1.5;
* :class:`YoloTrainer`: AdamW steps over padded-gt batches;
* :func:`make_dp_yolo_train_step`: the same step data-parallel over a mesh,
  one process a rank (:mod:`wtracker_tpu_torch.parallel.mesh`).

The ground truth is padded to a fixed ``G`` slots with a validity mask, and
the assigner runs on the whole batch at once.  Its outputs are targets, not
functions to differentiate: it runs without autograd on detached inputs (the
JAX package's ``stop_gradient``).  ``sort(...)[:, -k]`` is the k-th largest
value and ``argmax`` takes the first maximum, as in JAX.

The loss heads compute in float32, as the JAX package's do, or in float64
when the model does (the JAX package keeps them float32 whatever its
compute dtype): a float64 step is then float64 throughout, so a
data-parallel float64 step equals the one-device step to rounding.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from wtracker_tpu_torch.models.yolov8 import YoloV8, make_anchors


def _ciou(gt: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Complete IoU of broadcast-aligned (..., 4) xyxy boxes."""
    tl = torch.maximum(gt[..., :2], pr[..., :2])
    br = torch.minimum(gt[..., 2:], pr[..., 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]

    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    area_p = (pr[..., 2] - pr[..., 0]) * (pr[..., 3] - pr[..., 1])
    union = area_g + area_p - inter
    iou = inter / union.clamp_min(1e-9)

    # enclosing box diagonal and centre distance
    e_tl = torch.minimum(gt[..., :2], pr[..., :2])
    e_br = torch.maximum(gt[..., 2:], pr[..., 2:])
    c2 = ((e_br - e_tl) ** 2).sum(-1) + 1e-9

    g_c = (gt[..., :2] + gt[..., 2:]) / 2
    p_c = (pr[..., :2] + pr[..., 2:]) / 2
    rho2 = ((g_c - p_c) ** 2).sum(-1)

    # aspect-ratio term
    g_wh = (gt[..., 2:] - gt[..., :2]).clamp_min(1e-9)
    p_wh = (pr[..., 2:] - pr[..., :2]).clamp_min(1e-9)
    v = (4 / math.pi**2) * (torch.atan(g_wh[..., 0] / g_wh[..., 1]) - torch.atan(p_wh[..., 0] / p_wh[..., 1])) ** 2
    alpha = v / (1 - iou + v).clamp_min(1e-9)

    return iou - rho2 / c2 - alpha * v


def pairwise_ciou(gt_xyxy: torch.Tensor, pred_xyxy: torch.Tensor) -> torch.Tensor:
    """Complete IoU between (..., G, 4) gt and (..., A, 4) predictions →
    (..., G, A)."""
    return _ciou(gt_xyxy[..., :, None, :], pred_xyxy[..., None, :, :])


@torch.no_grad()
def task_aligned_assigner(
    cls_scores: torch.Tensor,
    pred_xyxy: torch.Tensor,
    anchors_xy: torch.Tensor,
    gt_xyxy: torch.Tensor,
    gt_cls: torch.Tensor,
    gt_mask: torch.Tensor,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
):
    """Assign anchors to ground-truth boxes for a batch of images.

    Args:
        cls_scores: (B, A, nc) sigmoided class scores.
        pred_xyxy: (B, A, 4) decoded predicted boxes (input pixels).
        anchors_xy: (A, 2) anchor centres (input pixels).
        gt_xyxy: (B, G, 4) padded ground-truth boxes.
        gt_cls: (B, G) ground-truth class ids.
        gt_mask: (B, G) validity of each gt slot.

    Returns:
        fg_mask (B, A), assigned gt index (B, A), target_scores (B, A, nc).
    """
    A = pred_xyxy.shape[-2]
    nc = cls_scores.shape[-1]
    cls_i = gt_cls.long()

    iou = pairwise_ciou(gt_xyxy, pred_xyxy).clamp(0.0, 1.0)  # (B, G, A)
    # score of each anchor for the gt's class
    score_for_gt = torch.gather(cls_scores.transpose(-1, -2), -2, cls_i[..., None].expand(*cls_i.shape, A))
    align = score_for_gt**alpha * iou**beta

    # candidates: anchor centre inside the gt box
    ax, ay = anchors_xy[..., 0], anchors_xy[..., 1]
    inside = (
        (ax[..., None, :] >= gt_xyxy[..., :, 0:1])
        & (ax[..., None, :] <= gt_xyxy[..., :, 2:3])
        & (ay[..., None, :] >= gt_xyxy[..., :, 1:2])
        & (ay[..., None, :] <= gt_xyxy[..., :, 3:4])
    )
    align = torch.where(inside & gt_mask[..., :, None], align, 0.0)

    # top-k per gt (no epsilon floor: cold-start align scores are ~1e-13)
    k = min(topk, A)
    kth = torch.topk(align, k, dim=-1).values[..., k - 1 : k]
    is_topk = (align >= kth) & (align > 0)

    # an anchor claimed by several gts goes to the one of highest IoU
    claimed = torch.where(is_topk, iou, -1.0)
    best_gt = claimed.argmax(dim=-2)  # (B, A), first maximum
    fg_mask = is_topk.any(dim=-2)

    # normalised target scores: per gt, align · max_iou / max_align
    max_align = align.amax(dim=-1, keepdim=True)
    max_iou = torch.where(is_topk, iou, 0.0).amax(dim=-1, keepdim=True)
    norm = align * max_iou / max_align.clamp_min(1e-30)  # (B, G, A)
    anchor_score = torch.gather(norm, -2, best_gt[..., None, :])[..., 0, :]  # (B, A)

    cls_of_best = torch.gather(cls_i, -1, best_gt)
    value = torch.where(fg_mask, anchor_score, 0.0).to(cls_scores.dtype)
    target_scores = F.one_hot(cls_of_best, nc).to(cls_scores.dtype) * value[..., None]
    return fg_mask, best_gt, target_scores


def _anchor_tables(imgsz: tuple[int, int], device: torch.device):
    anchors, strides = make_anchors(imgsz)
    return torch.from_numpy(anchors).to(device), torch.from_numpy(strides).to(device)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``: ``−y·log σ(x) − (1−y)·log σ(−x)``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def detection_loss(
    box_logits: list[torch.Tensor],
    cls_logits: list[torch.Tensor],
    gt_xyxy: torch.Tensor,
    gt_cls: torch.Tensor,
    gt_mask: torch.Tensor,
    imgsz: tuple[int, int],
    reg_max: int = 16,
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    data_parallel: bool = False,
):
    """The YOLOv8 training loss for a batch.

    Args:
        box_logits/cls_logits: raw per-level NHWC head outputs.
        gt_xyxy: (B, G, 4) padded ground truth in input pixels.
        gt_cls: (B, G) class ids.
        gt_mask: (B, G) gt validity.
        data_parallel: this rank's share of the whole batch's loss,
            normalised by the target-score sum of the whole batch (summed
            over the ranks of the default ``torch.distributed`` group), so
            the ranks' losses sum to the whole batch's.
    Returns:
        scalar loss and a dict of its three parts.
    """
    B = box_logits[0].shape[0]
    nc = cls_logits[0].shape[-1]
    dtype = torch.promote_types(box_logits[0].dtype, torch.float32)  # float32, or float64 for a float64 model
    box_flat = torch.cat([t.reshape(B, -1, 4 * reg_max) for t in box_logits], dim=1)
    cls_flat = torch.cat([t.reshape(B, -1, nc) for t in cls_logits], dim=1).to(dtype)
    A = box_flat.shape[1]

    anchors, strides = _anchor_tables(imgsz, box_flat.device)  # (A, 2) stride units, (A, 1)
    anchors_px = anchors * strides

    dist = box_flat.reshape(B, A, 4, reg_max).to(dtype)
    bins = torch.arange(reg_max, dtype=dtype, device=dist.device)
    ltrb = (torch.softmax(dist, dim=-1) * bins).sum(-1)  # (B, A, 4)
    pred_xyxy = torch.cat([(anchors - ltrb[..., :2]) * strides, (anchors + ltrb[..., 2:]) * strides], dim=-1)

    scores = torch.sigmoid(cls_flat)
    gt_xyxy = gt_xyxy.to(dtype)
    fg_mask, best_gt, target_scores = task_aligned_assigner(
        scores.detach(), pred_xyxy.detach(), anchors_px, gt_xyxy, gt_cls, gt_mask
    )
    fg = fg_mask.float()

    # classification: BCE against the aligned target scores
    score_sum = target_scores.sum()
    if data_parallel:
        from wtracker_tpu_torch.parallel.mesh import all_reduce_sum

        score_sum = all_reduce_sum(score_sum)
    score_sum = score_sum.clamp_min(1.0)
    cls_loss = sigmoid_binary_cross_entropy(cls_flat, target_scores).sum() / score_sum

    # box: CIoU of each anchor with its assigned gt, weighted by target score
    tgt_boxes = torch.gather(gt_xyxy, 1, best_gt[..., None].expand(B, A, 4))  # (B, A, 4)
    weight = target_scores.sum(-1)  # (B, A)
    box_loss = ((1.0 - _ciou(tgt_boxes, pred_xyxy)) * weight * fg).sum() / score_sum

    # DFL: cross-entropy on the two bins next to the target ltrb
    tgt_ltrb = torch.cat([anchors - tgt_boxes[..., :2] / strides, tgt_boxes[..., 2:] / strides - anchors], dim=-1)
    tgt_ltrb = tgt_ltrb.clamp(0, reg_max - 1 - 0.01)
    tl = torch.floor(tgt_ltrb)
    wr = tgt_ltrb - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(dist, dim=-1)  # (B, A, 4, reg_max)
    tl_i = tl.long()
    lp_l = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (tl_i + 1).clamp_max(reg_max - 1)[..., None])[..., 0]
    dfl = -(wl * lp_l + wr * lp_r)  # (B, A, 4)
    dfl_loss = (dfl.mean(-1) * weight * fg).sum() / score_sum

    total = box_w * box_loss + cls_w * cls_loss + dfl_w * dfl_loss
    return total, {"box": box_loss, "cls": cls_loss, "dfl": dfl_loss}


def train_step(
    model: YoloV8, optimizer: torch.optim.Optimizer, images, gt_xyxy, gt_cls, gt_mask, imgsz, data_parallel: bool = False
):
    """One optimisation step in train mode: forward, the loss, backward and
    the optimizer's update; returns the loss and its parts as tensors.

    ``data_parallel``: the arguments are this rank's rows of the whole
    batch (:mod:`wtracker_tpu_torch.parallel.mesh`); BatchNorm and the
    loss's normaliser take the whole batch's statistics, the gradients are
    summed over the ranks before the update, and the returned loss and parts
    are the whole batch's: the step of one device on the whole batch."""
    from wtracker_tpu_torch.models.batchnorm import synced_batch_norm

    model.train()
    with synced_batch_norm() if data_parallel else contextlib.nullcontext():
        box_l, cls_l = model(images)
    loss, parts = detection_loss(box_l, cls_l, gt_xyxy, gt_cls, gt_mask, imgsz, model.reg_max, data_parallel=data_parallel)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    parts = {k: v.detach() for k, v in parts.items()}
    if data_parallel:
        from wtracker_tpu_torch.parallel.mesh import all_reduce_gradients, all_reduce_sum

        all_reduce_gradients(model.parameters())
        loss, *summed = all_reduce_sum(torch.stack([loss.detach(), *parts.values()])).unbind(0)
        parts = dict(zip(parts, summed))
    optimizer.step()
    return loss.detach(), parts


@dataclass
class YoloTrainer:
    """Minimal detector trainer: AdamW steps over padded-gt batches, on the
    device of ``model``'s weights (which it updates in place).

    Args:
        model: the detector (float32).
        imgsz: training image size.
        learning_rate / weight_decay: AdamW hyperparameters (reference recipe:
            AdamW, batch 72, imgsz 384 — yolo/yolo_train_config.yaml).
    """

    model: YoloV8
    imgsz: tuple[int, int] = (384, 384)
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4

    def __post_init__(self):
        self.optimizer = torch.optim.AdamW(self.model.parameters(), self.learning_rate, weight_decay=self.weight_decay)
        self.device = self.model.b1.conv.weight.device

    def step(self, images: np.ndarray, gt_xyxy: np.ndarray, gt_cls: np.ndarray, gt_mask: np.ndarray):
        """One optimization step; returns (loss, component dict)."""
        args = (torch.as_tensor(np.asarray(a)).to(self.device) for a in (images, gt_xyxy, gt_cls, gt_mask))
        loss, parts = train_step(self.model, self.optimizer, *args, self.imgsz)
        return float(loss), {k: float(v) for k, v in parts.items()}


def make_dp_yolo_train_step(trainer: YoloTrainer, mesh, axis: str = "data"):
    """Data-parallel detector train step over a mesh: one process a slot
    (joined with :func:`~wtracker_tpu_torch.parallel.mesh.init_data_parallel`),
    ``trainer`` holding the model on this rank's device.

    Returns ``step(images, gt_xyxy, gt_cls, gt_mask) -> (loss, parts)``:
    every rank passes the whole batch and steps on its contiguous rows
    (:func:`train_step` with ``data_parallel=True``); the weights, BatchNorm
    statistics and optimizer state stay the same on every rank and equal
    one device's step on the whole batch.  The JAX package's step threads
    ``(params, batch_stats, opt_state)``; here the trainer holds them.
    """
    from wtracker_tpu_torch.parallel.mesh import dp_rows

    def step(images, gt_xyxy, gt_cls, gt_mask):
        rows = dp_rows(mesh, int(images.shape[0]))
        args = (torch.as_tensor(np.asarray(a))[rows].to(trainer.device) for a in (images, gt_xyxy, gt_cls, gt_mask))
        loss, parts = train_step(trainer.model, trainer.optimizer, *args, trainer.imgsz, data_parallel=True)
        return loss, parts

    return step
