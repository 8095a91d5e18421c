"""The full detector-training recipe: augmentation, schedule, EMA,
validation, checkpoints and resume.

Port of :mod:`wtracker_tpu.neural.yolo_recipe`, whose settings are the
reference's ultralytics training file (yolo/yolo_train_config.yaml): AdamW
with a warmup and cosine decay, mosaic / flips / translate / scale /
brightness and contrast augmentation, EMA weights, validation mAP@0.5 with
NMS at IoU 0.7, best/last checkpoints and early stopping.

The JAX package runs an epoch as one compiled scan with the augmentation's
random draws made inside the step (``jax.random`` under ``jax_enable_x64``:
float64 uniforms, int64 ``randint``).  Here each epoch's draws are made on
the host by :mod:`~wtracker_tpu_torch.utils.flax_init`'s threefry in JAX's
key order (:func:`sample_epoch`) and uploaded once; the steps then gather,
augment (:func:`apply_augment`), train and update the EMA on the device.
Sampling and applying are separate, so :func:`augment_batch` with JAX's key
gives JAX's batch.

The augmentation keeps JAX's geometry exactly: the spatial warp is two
separable bilinear resamples (:func:`_axis_resample`) whose sample
coordinates are float64, as in JAX, with weights applied to float32 pixels;
the mosaic is a fixed 2×2 grid of half-size resizes; brightness and
contrast gains are the grayscale form of HSV jitter.  Images stored as
uint8 gray (N, H, W) are expanded per batch: one channel through the whole
chain, broadcast to the model's three at the end.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from wtracker_tpu_torch.models.yolov8 import YoloV8, YoloV8Detector, decode_predictions
from wtracker_tpu_torch.neural.yolo_training import train_step
from wtracker_tpu_torch.ops.image import resize_bilinear
from wtracker_tpu_torch.ops.nms import batched_nms
from wtracker_tpu_torch.utils import flax_init

BORDER = 114.0 / 255.0  # ultralytics letterbox/affine fill, normalized

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AugmentConfig:
    """Augmentation strengths (defaults = the reference's training yaml)."""

    mosaic: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.3
    translate: float = 0.1  # fraction of image size
    scale: float = 0.2  # gain: s ~ U[1-scale, 1+scale]
    brightness: float = 0.4  # hsv_v equivalent for grayscale
    contrast: float = 0.3  # hsv_s equivalent for grayscale
    min_box_px: float = 2.0  # boxes shrinking below this are dropped

    @property
    def identity(self) -> bool:
        return (
            self.mosaic == 0
            and self.fliplr == 0
            and self.flipud == 0
            and self.translate == 0
            and self.scale == 0
            and self.brightness == 0
            and self.contrast == 0
        )


@dataclass(frozen=True)
class RecipeConfig:
    """Full training-run settings (defaults = the reference recipe)."""

    epochs: int = 100
    batch: int = 72
    lr0: float = 1e-3  # AdamW peak LR
    lrf: float = 0.01  # final LR = lr0 * lrf (cosine decay)
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    patience: int = 100  # early-stop epochs without val improvement
    close_mosaic: int = 10  # disable mosaic for the last N epochs
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0  # ramp: decay * (1 - exp(-step / tau))
    val_fraction: float = 0.2  # split when no explicit val set is given
    val_iou: float = 0.7  # NMS IoU threshold during validation
    val_conf: float = 0.001  # validation score floor
    val_max_det: int = 32
    ckpt_every: int = 1
    """Write last/train-state checkpoints every N epochs (and always at the
    final epoch, and at the epoch where patience stops the run)."""
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 0


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float):
    """optax's ``warmup_cosine_decay_schedule`` as a function of the update
    count: linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then a cosine to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


# ---------------------------------------------------------------------------
# dataset loading (YOLO txt-label format)
# ---------------------------------------------------------------------------


def resize_gray_uint8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of a uint8 gray image with OpenCV's ``INTER_LINEAR``
    geometry (pixel centres at +0.5, edge pixels repeated), rounded to the
    nearest grey level: within one level of ``cv2.resize``, whose weights
    are 11-bit fixed point."""

    def taps(n_in: int, n_out: int):
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(src).astype(np.int64)
        f = src - i0
        f = np.where(i0 < 0, 0.0, f)
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        return i0, i1, f

    y0, y1, fy = taps(img.shape[0], new_h)
    x0, x1, fx = taps(img.shape[1], new_w)
    src = img.astype(np.float64)
    rows = src[y0] * (1.0 - fy)[:, None] + src[y1] * fy[:, None]
    out = rows[:, x0] * (1.0 - fx)[None, :] + rows[:, x1] * fx[None, :]
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def load_yolo_dataset(images_dir: str, labels_dir: str, imgsz: int, max_gt: int = 4, gray_uint8: bool = False):
    """Load a YOLO-format dataset (images + ``class cx cy w h`` label files)
    into padded arrays: (N, s, s, 3) float32 images in [0, 1], (N, G, 4) xyxy
    gt boxes in pixels, (N, G) classes, (N, G) validity.

    ``gray_uint8=True`` returns (N, s, s) uint8 images instead, the compact
    form the training run expands per batch.  Images are read with
    :mod:`~wtracker_tpu_torch.utils.image_codec` (PNG and BMP without
    OpenCV).  Non-square sources are letterboxed to ``imgsz`` (ratio
    preserved, centred 114 padding) with the matching label transform; the
    resize is :func:`resize_gray_uint8`.  Label files with more than
    ``max_gt`` boxes are truncated with a warning.
    """
    import warnings

    from wtracker_tpu_torch.utils import image_codec

    names = sorted(f for f in os.listdir(images_dir) if f.lower().endswith((".png", ".jpg", ".bmp")))
    images, gts, clss, masks = [], [], [], []
    for name in names:
        img = image_codec.imread(os.path.join(images_dir, name), image_codec.IMREAD_GRAYSCALE)
        sh, sw = img.shape[:2]
        scale = min(imgsz / sh, imgsz / sw)
        new_h, new_w = round(sh * scale), round(sw * scale)
        pad_top = (imgsz - new_h) // 2
        pad_left = (imgsz - new_w) // 2
        if (new_h, new_w) != (sh, sw):
            img = resize_gray_uint8(img, new_h, new_w)
        canvas = np.full((imgsz, imgsz), 114, np.uint8)
        canvas[pad_top : pad_top + new_h, pad_left : pad_left + new_w] = img
        images.append(
            canvas if gray_uint8 else np.repeat(canvas[..., None], 3, axis=-1).astype(np.float32) / 255.0
        )

        label_path = os.path.join(labels_dir, os.path.splitext(name)[0] + ".txt")
        gt = np.zeros((max_gt, 4), np.float32)
        cls = np.zeros((max_gt,), np.int32)
        mask = np.zeros((max_gt,), bool)
        if os.path.exists(label_path):
            with open(label_path) as f:
                rows = [ln for ln in f.read().splitlines() if ln.strip()]
            if len(rows) > max_gt:
                warnings.warn(
                    f"{label_path}: {len(rows)} boxes exceed max_gt={max_gt}; keeping the first {max_gt}",
                    stacklevel=2,
                )
                rows = rows[:max_gt]
            for j, line in enumerate(rows):
                c, cx, cy, bw, bh = (float(v) for v in line.split())
                gt[j] = (
                    (cx - bw / 2) * sw * scale + pad_left,
                    (cy - bh / 2) * sh * scale + pad_top,
                    (cx + bw / 2) * sw * scale + pad_left,
                    (cy + bh / 2) * sh * scale + pad_top,
                )
                cls[j] = int(c)
                mask[j] = True
        gts.append(gt)
        clss.append(cls)
        masks.append(mask)
    return np.stack(images), np.stack(gts), np.stack(clss), np.stack(masks)


# ---------------------------------------------------------------------------
# augmentation: the draws (host), then their application (device)
# ---------------------------------------------------------------------------


def _sample_mosaic(key: np.ndarray, batch: int, p: float) -> dict:
    """The mosaic's draws from its key: three partners per image (indices
    into the whole batch) and whether the image is tiled."""
    k_pick, k_apply = flax_init.split(key)
    return {
        "partners": flax_init.randint(k_pick, (batch, 3), 0, batch),
        "use_mosaic": flax_init.uniform(k_apply, (batch,), dtype=np.float64) < p,
    }


def _sample_spatial(key: np.ndarray, batch: int, hw: tuple[int, int], cfg: AugmentConfig) -> dict:
    """The affine jitter's draws from its key (JAX's ``_sample_affine``)."""
    f64 = np.float64
    h, w = hw
    ks, kt, kfx, kfy = flax_init.split(key, 4)
    t = flax_init.uniform(kt, (batch, 2), -cfg.translate, cfg.translate, dtype=f64)
    return {
        "scale": flax_init.fma(cfg.scale, flax_init.uniform(ks, (batch,), -1.0, 1.0, dtype=f64), 1.0),
        "tx": t[:, 0] * w,
        "ty": t[:, 1] * h,
        "flip_x": flax_init.uniform(kfx, (batch,), dtype=f64) < cfg.fliplr,
        "flip_y": flax_init.uniform(kfy, (batch,), dtype=f64) < cfg.flipud,
    }


def _sample_photometric(key: np.ndarray, batch: int, cfg: AugmentConfig) -> dict:
    """The brightness and contrast gains' draws from their key."""
    kb, kc = flax_init.split(key)
    return {
        "bright": flax_init.fma(cfg.brightness, flax_init.uniform(kb, (batch,), -1.0, 1.0, dtype=np.float64), 1.0),
        "contr": flax_init.fma(cfg.contrast, flax_init.uniform(kc, (batch,), -1.0, 1.0, dtype=np.float64), 1.0),
    }


def sample_augment(key: np.ndarray, batch: int, hw: tuple[int, int], cfg: AugmentConfig) -> dict:
    """One batch's augmentation draws from ``key``, as JAX's
    ``augment_batch`` draws them (float64, int64).  The multiply-adds that
    XLA fuses are rounded once (:func:`~wtracker_tpu_torch.utils.flax_init.fma`)."""
    k_m, k_s, k_p = flax_init.split(key, 3)
    draws = _sample_mosaic(k_m, batch, cfg.mosaic) if cfg.mosaic > 0 else {}
    return {**draws, **_sample_spatial(k_s, batch, hw, cfg), **_sample_photometric(k_p, batch, cfg)}


def sample_epoch(seed: int, n_batches: int, batch: int, hw: tuple[int, int], cfg: AugmentConfig, device) -> dict:
    """All of an epoch's draws, stacked (n_batches, batch, ...) and uploaded
    in one copy each: batch ``i`` uses key ``i`` of ``split(PRNGKey(seed),
    n_batches)``, as the JAX epoch does."""
    per_batch = [sample_augment(k, batch, hw, cfg) for k in flax_init.split(flax_init.key(seed), n_batches)]
    return {name: torch.from_numpy(np.stack([d[name] for d in per_batch])).to(device) for name in per_batch[0]}


def _axis_resample(images: torch.Tensor, src: torch.Tensor, axis: int):
    """Bilinear resample of (B, H, W, C) ``images`` along ``axis`` (1 or 2);
    returns ``(out, weight_sum)``.

    ``src`` is (B, n) float64 source coordinates for each output index.  The
    two taps are gathered; a tap outside the axis loses its weight, and
    ``weight_sum`` (float64, (B, n)) is what remains, so the caller can blend
    the missing mass toward the border constant.
    """
    n = images.shape[axis]
    i0f = torch.floor(src)
    f = src - i0f
    i0 = i0f.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), 1.0 - f, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < n), f, 0.0)
    shape = [images.shape[0], 1, 1, 1]
    shape[axis] = src.shape[1]

    def gather(i):
        return torch.gather(images, axis, i.clamp(0, n - 1).reshape(shape).expand_as(images))

    out = w0.to(images.dtype).reshape(shape) * gather(i0) + w1.to(images.dtype).reshape(shape) * gather(i1)
    return out, w0 + w1


def spatial_apply(images: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, draws: dict, cfg: AugmentConfig):
    """Centred scale + translate + flips on a (B, H, W, C) batch, as JAX's
    ``spatial_augment`` for the drawn ``scale``, ``tx``, ``ty``, ``flip_x``,
    ``flip_y``.  Boxes go through the forward affine in float64 and are
    clipped; boxes collapsing under ``min_box_px`` are masked."""
    B, H, W = images.shape[:3]
    s, tx, ty = draws["scale"][:, None], draws["tx"][:, None], draws["ty"][:, None]
    flip_x, flip_y = draws["flip_x"][:, None], draws["flip_y"][:, None]
    dev = images.device

    # inverse map (output pixel → source coordinate), flips composed in
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float64, device=dev)[None, :]
    xs = torch.arange(W, dtype=torch.float64, device=dev)[None, :]
    ys = torch.where(flip_y, (H - 1) - ys, ys)
    xs = torch.where(flip_x, (W - 1) - xs, xs)
    src_y = (ys - cy - ty) / s + cy  # (B, H)
    src_x = (xs - cx - tx) / s + cx  # (B, W)

    out, wy = _axis_resample(images, src_y, axis=1)
    out = out + ((1.0 - wy) * BORDER).to(out.dtype).reshape(B, H, 1, 1)
    out, wx = _axis_resample(out, src_x, axis=2)
    out = out + ((1.0 - wx) * BORDER).to(out.dtype).reshape(B, 1, W, 1)

    # forward affine on the box corners (then flip, then clip)
    def fwd(pts_x, pts_y):
        fx = (pts_x - cx) * s + cx + tx
        fy = (pts_y - cy) * s + cy + ty
        return torch.where(flip_x, (W - 1) - fx, fx), torch.where(flip_y, (H - 1) - fy, fy)

    x0, y0 = fwd(gt[..., 0], gt[..., 1])
    x1, y1 = fwd(gt[..., 2], gt[..., 3])
    gx0, gx1 = torch.minimum(x0, x1).clamp(0, W), torch.maximum(x0, x1).clamp(0, W)  # flips swap corners
    gy0, gy1 = torch.minimum(y0, y1).clamp(0, H), torch.maximum(y0, y1).clamp(0, H)
    new_gt = torch.stack([gx0, gy0, gx1, gy1], dim=-1)
    alive = (gx1 - gx0 >= cfg.min_box_px) & (gy1 - gy0 >= cfg.min_box_px)
    return out, new_gt, mask & alive


def _pad_gt(gt, cls, mask, extra: int):
    """Grow the gt capacity by ``extra`` empty slots."""
    B = gt.shape[0]
    return (
        torch.cat([gt, gt.new_zeros((B, extra, 4))], dim=1),
        torch.cat([cls, cls.new_zeros((B, extra))], dim=1),
        torch.cat([mask, mask.new_zeros((B, extra))], dim=1),
    )


def mosaic_apply(images, gt, cls, mask, draws: dict):
    """Fixed-grid 2×2 mosaic where ``use_mosaic`` is drawn, from the image
    and its three drawn ``partners``; gt capacity grows to 4·G."""
    B, H, W, _ = images.shape
    G = gt.shape[1]
    partners, use = draws["partners"], draws["use_mosaic"]

    half = resize_bilinear(images, (H // 2, W // 2)).to(images.dtype)  # (B, H/2, W/2, C)
    quads = [half, half[partners[:, 0]], half[partners[:, 1]], half[partners[:, 2]]]
    tiled = torch.cat([torch.cat(quads[:2], dim=2), torch.cat(quads[2:], dim=2)], dim=1)

    offs = torch.tensor([[0.0, 0.0], [W / 2, 0.0], [0.0, H / 2], [W / 2, H / 2]], dtype=torch.float32, device=images.device)
    src_idx = torch.cat([torch.arange(B, device=images.device)[:, None], partners], dim=1)  # (B, 4)
    mosaic_gt = (gt[src_idx] * 0.5 + offs[None, :, None, :].repeat(1, 1, 1, 2)).reshape(B, 4 * G, 4)
    mosaic_cls = cls[src_idx].reshape(B, 4 * G)
    mosaic_mask = mask[src_idx].reshape(B, 4 * G)
    plain_gt, plain_cls, plain_mask = _pad_gt(gt, cls, mask, 3 * G)

    images = torch.where(use[:, None, None, None], tiled, images)
    gt = torch.where(use[:, None, None], mosaic_gt, plain_gt)
    cls = torch.where(use[:, None], mosaic_cls, plain_cls)
    mask = torch.where(use[:, None], mosaic_mask, plain_mask)
    return images, gt, cls, mask


def photometric_apply(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """Brightness/contrast gains about each image's mean, clipped to [0, 1]."""
    bright = draws["bright"].to(images.dtype)[:, None, None, None]
    contr = draws["contr"].to(images.dtype)[:, None, None, None]
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * contr + mean * bright).clamp(0.0, 1.0)


def _upload(draws: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in draws.items()}


def spatial_augment(key: np.ndarray, images: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, cfg: AugmentConfig):
    """JAX's ``spatial_augment``: random centred scale + translate + flips
    on a (B, H, W, C) batch, drawn from ``key`` (a uint32 key pair, the value
    of a ``jax.random`` key); returns (images, gt, mask)."""
    B, H, W = images.shape[:3]
    draws = _upload(_sample_spatial(np.asarray(key, np.uint32), B, (H, W), cfg), images.device)
    return spatial_apply(images, gt, mask, draws, cfg)


def mosaic_augment(key: np.ndarray, images: torch.Tensor, gt, cls, mask, p: float):
    """JAX's ``mosaic_augment``: a fixed-grid 2×2 mosaic with probability
    ``p`` per image, drawn from ``key``; gt capacity grows to 4·G."""
    draws = _upload(_sample_mosaic(np.asarray(key, np.uint32), images.shape[0], p), images.device)
    return mosaic_apply(images, gt, cls, mask, draws)


def photometric_augment(key: np.ndarray, images: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """JAX's ``photometric_augment``: brightness and contrast jitter drawn
    from ``key``."""
    draws = _upload(_sample_photometric(np.asarray(key, np.uint32), images.shape[0], cfg), images.device)
    return photometric_apply(images, draws)


def apply_augment(draws: dict, images, gt, cls, mask, cfg: AugmentConfig, mosaic_on: bool = True, rows: slice | None = None):
    """The augmentation chain for one batch, given its draws: returns
    (images, gt, cls, mask) with gt capacity 4·G whenever mosaic is
    configured (also while ``mosaic_on`` is false, during the close-mosaic
    epochs, so every step sees one shape).

    ``rows``: only those rows of the result (a data-parallel rank's share):
    the mosaic runs over the whole batch, whose images its partners index,
    and the per-image steps over the rows alone."""
    if cfg.mosaic > 0:
        if mosaic_on:
            images, gt, cls, mask = mosaic_apply(images, gt, cls, mask, draws)
        else:
            gt, cls, mask = _pad_gt(gt, cls, mask, 3 * gt.shape[1])
    if rows is not None:
        images, gt, cls, mask = images[rows], gt[rows], cls[rows], mask[rows]
        draws = {k: v[rows] for k, v in draws.items()}
    images, gt, mask = spatial_apply(images, gt, mask, draws, cfg)
    images = photometric_apply(images, draws)
    return images, gt, cls, mask


def augment_batch(key: np.ndarray, images, gt, cls, mask, cfg: AugmentConfig, mosaic_on: bool = True):
    """JAX's ``augment_batch``: the draws of ``key`` (a uint32 key pair, the
    value of a ``jax.random`` key) applied to a (B, H, W, C) batch."""
    draws = sample_augment(np.asarray(key, np.uint32), images.shape[0], tuple(images.shape[1:3]), cfg)
    return apply_augment(_upload(draws, images.device), images, gt, cls, mask, cfg, mosaic_on)


def expand_gray(images: torch.Tensor) -> torch.Tensor:
    """uint8 gray (B, H, W) → float32 (B, H, W, 1) in [0, 1]."""
    return images[..., None].to(torch.float32) / 255.0


# ---------------------------------------------------------------------------
# validation: decode → general NMS → single-class AP@0.5
# ---------------------------------------------------------------------------


@torch.no_grad()
def detections_for_map(model: YoloV8, images, imgsz, conf, iou, max_det, chunk: int = 64):
    """Every anchor decoded and suppressed (:func:`batched_nms`), in chunks
    of ``chunk`` images: numpy (boxes, scores, valid)."""
    was_training = model.training
    model.eval()
    dev = model.b1.conv.weight.device
    outs = []
    for s in range(0, images.shape[0], chunk):
        part = torch.as_tensor(images[s : s + chunk]).to(dev)
        if part.dtype == torch.uint8 and part.ndim == 3:  # compact gray storage
            part = expand_gray(part).expand(*part.shape, 3)
        box_logits, cls_logits = model(part)
        boxes, scores = decode_predictions(box_logits, cls_logits, imgsz, model.reg_max)
        outs.append([t.cpu().numpy() for t in batched_nms(boxes, scores.amax(dim=-1), iou, conf, max_det)])
    model.train(was_training)
    return [np.concatenate(parts, axis=0) for parts in zip(*outs)]


def average_precision_50(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    det_valid: np.ndarray,
    gt: np.ndarray,
    gt_mask: np.ndarray,
    iou_thr: float = 0.5,
) -> float:
    """Single-class AP@``iou_thr`` over a validation set, in float64 numpy.

    VOC-style continuous AP: detections sorted by score, each greedily
    matched to the best unmatched gt of its image, the precision envelope
    integrated over recall.  The greedy match runs as D argmax sweeps over
    the whole batch (per-image score order reproduces the global order,
    since matching is per image).
    """
    det_boxes = np.asarray(det_boxes, np.float64)
    det_scores = np.asarray(det_scores, np.float64)
    det_valid = np.asarray(det_valid, bool)
    gt = np.asarray(gt, np.float64)
    gt_mask = np.asarray(gt_mask, bool)

    n_gt = int(gt_mask.sum())
    n_det = int(det_valid.sum())
    if n_det == 0 or n_gt == 0:
        return 0.0
    B, D = det_scores.shape

    # pairwise IoU (B, D, G); masked gts get -1 so they can never be chosen
    ix0 = np.maximum(det_boxes[:, :, None, 0], gt[:, None, :, 0])
    iy0 = np.maximum(det_boxes[:, :, None, 1], gt[:, None, :, 1])
    ix1 = np.minimum(det_boxes[:, :, None, 2], gt[:, None, :, 2])
    iy1 = np.minimum(det_boxes[:, :, None, 3], gt[:, None, :, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_d = (det_boxes[..., 2] - det_boxes[..., 0]) * (det_boxes[..., 3] - det_boxes[..., 1])
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    union = area_d[:, :, None] + area_g[:, None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    iou = np.where(gt_mask[:, None, :] & det_valid[:, :, None], iou, -1.0)

    # per-image score order, stable (equal scores keep detection order)
    order = np.argsort(-det_scores + np.where(det_valid, 0.0, np.inf), axis=1, kind="stable")
    tp = np.zeros((B, D))
    gt_free = gt_mask.copy()
    rows = np.arange(B)
    for r in range(D):
        d = order[:, r]
        cand = np.where(gt_free, iou[rows, d], -1.0)  # (B, G)
        best_j = np.argmax(cand, axis=1)
        hit = cand[rows, best_j] >= iou_thr
        gt_free[rows[hit], best_j[hit]] = False
        tp[rows[hit], d[hit]] = 1.0

    # global ranking: stable sort by -score over valid detections
    g_order = np.argsort(-det_scores.ravel(), kind="stable")
    g_order = g_order[det_valid.ravel()[g_order]]
    cum_tp = np.cumsum(tp.ravel()[g_order])
    recall = cum_tp / n_gt
    precision = cum_tp / (np.arange(n_det) + 1)
    env = np.maximum.accumulate(precision[::-1])[::-1]  # precision envelope
    r = np.concatenate([[0.0], recall, [recall[-1]]])
    p = np.concatenate([[env[0]], env, [0.0]])
    return float(np.trapezoid(p, r))


def evaluate_map50(
    model: YoloV8,
    images,
    gt: np.ndarray,
    gt_mask: np.ndarray,
    imgsz: tuple[int, int],
    conf: float = 0.001,
    iou: float = 0.7,
    max_det: int = 32,
) -> float:
    """mAP@0.5 of a detector over a labeled set (single class)."""
    boxes, scores, valid = detections_for_map(model, images, imgsz, conf, iou, max_det)
    return average_precision_50(boxes, scores, valid, np.asarray(gt), np.asarray(gt_mask))


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


@dataclass
class EpochResult:
    epoch: int
    train_loss: float
    val_map50: float
    lr: float
    train_s: float = float("nan")
    """Host seconds of the epoch's training steps (a loss read ends them)."""
    val_s: float = float("nan")
    """Host seconds of its validation."""


class YoloTrainingRun:
    """Drives the full recipe on the device of ``model``'s weights: epochs of
    AdamW steps with augmentation and EMA, EMA validation, best/last
    checkpoints, early stop and resume.

    ``model`` is trained in place; :attr:`ema_model` holds the EMA weights
    (with the training model's BatchNorm statistics copied in before each
    validation and save), the weights the JAX package validates and ships.

    Data parallelism (``mesh``, a data mesh of
    :mod:`wtracker_tpu_torch.parallel.mesh`): one process a slot, each
    joined with :func:`~wtracker_tpu_torch.parallel.mesh.init_data_parallel`
    and holding ``model`` on its slot's device.  Every rank holds the whole
    dataset and makes the epoch's draws (sample order, augmentation) from
    the same seeds, gathers each whole batch, mosaics it (its partners index
    the whole batch) and steps on its contiguous rows; BatchNorm statistics,
    the loss's normaliser and the gradients are the whole batch's, so the
    weights, schedule and EMA stay the same on every rank and equal one
    device's run.  Only rank 0 validates (the others get its value), logs
    and writes checkpoints; every rank reads them on resume.
    """

    def __init__(
        self,
        model: YoloV8,
        imgsz: tuple[int, int],
        config: RecipeConfig = RecipeConfig(),
        steps_per_epoch: int | None = None,
        n_train: int | None = None,
        mesh=None,
        data_axis: str = "data",
    ):
        self.mesh = mesh
        self.data_axis = data_axis
        self.rank = 0
        if mesh is not None:
            from wtracker_tpu_torch.parallel.mesh import dp_rank

            self.rank = dp_rank(mesh)
            if model.b1.conv.weight.device != mesh.devices[self.rank]:
                raise ValueError(f"rank {self.rank}'s model is on {model.b1.conv.weight.device}, its slot on "
                                 f"{mesh.devices[self.rank]}")
        self.model = model
        self.config = config
        self.imgsz = tuple(imgsz)
        self.device = model.b1.conv.weight.device
        self.ema_model = copy.deepcopy(model)
        if steps_per_epoch is None:
            if n_train is None:
                raise ValueError("pass steps_per_epoch or n_train")
            steps_per_epoch = max(1, -(-n_train // config.batch))
        self.steps_per_epoch = steps_per_epoch

        total_steps = max(2, config.epochs * steps_per_epoch)
        # warmup can't swallow the whole run: clamp to total-1 so the cosine
        # leg always has at least one step
        warmup = int(round(config.warmup_epochs * steps_per_epoch))
        warmup = min(max(1, warmup), total_steps - 1)
        self.schedule = warmup_cosine_decay(
            config.lr0 * 0.01, config.lr0, warmup, total_steps, config.lr0 * config.lrf
        )
        self.optimizer = torch.optim.AdamW(model.parameters(), self.schedule(0), weight_decay=config.weight_decay)
        self.step_count = 0

    # -- one epoch ---------------------------------------------------------

    def _epoch_order(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """One epoch's (n_batches, bs) sample order from ``rng``: a
        permutation, padded by re-drawing to ``steps_per_epoch`` full
        batches.  The draw count depends on (n, batch, steps) alone, so a
        resumed run replays the interrupted epochs' draws exactly."""
        bs = min(self.config.batch, n)
        need = self.steps_per_epoch * bs
        perm = rng.permutation(n)
        while len(perm) < need:
            perm = np.concatenate([perm, rng.permutation(n)])
        return perm[:need].reshape(self.steps_per_epoch, bs)

    def _ema_decay(self) -> tuple[float, float]:
        """``d = decay·(1 − exp(−(step+1)/τ))`` and ``1 − d`` in float32,
        for the update that follows step ``step_count``."""
        f32 = np.float32
        step = f32(self.step_count)
        d = f32(self.config.ema_decay) * (f32(1.0) - np.exp(-(step + f32(1.0)) / f32(self.config.ema_tau)))
        return float(d), float(f32(1.0) - d)

    @torch.no_grad()
    def _update_ema(self) -> None:
        d, one_minus_d = self._ema_decay()
        ema = list(self.ema_model.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(self.model.parameters()), alpha=one_minus_d)

    def run_epoch(self, epoch_idx: int, images, gt, cls, mask, rng: np.random.Generator) -> float:
        """One training epoch over the device-resident dataset."""
        cfg, aug = self.config, self.config.augment
        n = images.shape[0]
        bs = min(cfg.batch, n)
        rows = None
        if self.mesh is not None:
            from wtracker_tpu_torch.parallel.mesh import dp_rows

            rows = dp_rows(self.mesh, bs)  # raises for a batch that does not split evenly
        order = torch.from_numpy(self._epoch_order(n, rng)).to(self.device)
        mosaic_on = epoch_idx < cfg.epochs - cfg.close_mosaic
        gray = images.dtype == torch.uint8
        draws = None
        if not aug.identity:
            hw = tuple(images.shape[1:3])
            draws = sample_epoch(cfg.seed * 100_003 + epoch_idx, self.steps_per_epoch, bs, hw, aug, self.device)

        losses = []
        for i in range(self.steps_per_epoch):
            idx = order[i]
            b_images, b_gt, b_cls, b_mask = images[idx], gt[idx], cls[idx], mask[idx]
            if gray:  # the chain runs on one channel; broadcast at the end
                b_images = expand_gray(b_images)
            if draws is not None:
                step_draws = {k: v[i] for k, v in draws.items()}
                b_images, b_gt, b_cls, b_mask = apply_augment(
                    step_draws, b_images, b_gt, b_cls, b_mask, aug, mosaic_on, rows=rows
                )
            elif rows is not None:
                b_images, b_gt, b_cls, b_mask = b_images[rows], b_gt[rows], b_cls[rows], b_mask[rows]
            if gray:
                b_images = b_images.expand(*b_images.shape[:3], 3)

            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step_count)
            loss, _ = train_step(
                self.model, self.optimizer, b_images, b_gt, b_cls, b_mask, self.imgsz, data_parallel=rows is not None
            )
            self._update_ema()
            self.step_count += 1
            losses.append(loss)
        return float(torch.stack(losses).mean())

    # -- weights -----------------------------------------------------------

    def eval_model(self, ema: bool = True) -> YoloV8:
        """The model to validate and ship: the EMA weights with the training
        model's BatchNorm statistics (or the training model itself)."""
        if not ema:
            return self.model
        with torch.no_grad():
            for dst, src in zip(self.ema_model.buffers(), self.model.buffers()):
                dst.copy_(src)
        return self.ema_model

    def state(self, ema: bool = True) -> dict:
        """A detached copy of :meth:`eval_model`'s state dict, on the device."""
        return {k: v.detach().clone() for k, v in self.eval_model(ema).state_dict().items()}

    # -- full-state checkpoints (resume) ---------------------------------------

    def save_state(self, directory: str, epoch: int, best_map: float, best_epoch: int) -> None:
        """Persist the complete training state (weights, BatchNorm
        statistics, optimizer, EMA) as ``train_state.pt`` and the scalars
        (epoch, step count, best-mAP bookkeeping) as JAX's
        ``train_state.json``, so an interrupted run resumes exactly."""
        path = os.path.abspath(directory)
        os.makedirs(path, exist_ok=True)
        torch.save(
            {
                "model": self.model.state_dict(),
                "ema": self.ema_model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
            },
            os.path.join(path, "train_state.pt"),
        )
        meta = {"epoch": epoch, "step_count": self.step_count, "best_map": best_map, "best_epoch": best_epoch}
        with open(os.path.join(path, "train_state.json"), "w") as f:
            json.dump(meta, f)

    def load_state(self, directory: str) -> dict | None:
        """Restore a :meth:`save_state` checkpoint in place (tensors only:
        ``torch.load(weights_only=True)``); returns the scalar metadata, or
        ``None`` when the directory holds no resumable state."""
        path = os.path.abspath(directory)
        meta_path, state_path = os.path.join(path, "train_state.json"), os.path.join(path, "train_state.pt")
        if not (os.path.exists(meta_path) and os.path.exists(state_path)):
            return None
        state = torch.load(state_path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.ema_model.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["optimizer"])
        with open(meta_path) as f:
            meta = json.load(f)
        self.step_count = int(meta["step_count"])
        return meta

    # -- the full loop -----------------------------------------------------

    def fit(
        self,
        train_images,
        train_gt,
        train_cls,
        train_mask,
        val_images=None,
        val_gt=None,
        val_mask=None,
        ckpt_dir: str | None = None,
        log=print,
        resume: bool = False,
        stop_after: int | None = None,
        tensorboard_dir: str | None = None,
    ) -> list[EpochResult]:
        """Train with per-epoch validation, best/last checkpoints, early stop.

        Without an explicit val set, ``val_fraction`` of the data is split off
        (by ``default_rng(seed)``).  Returns the per-epoch history; the best
        EMA weights end up in ``self.best_state``.  ``resume=True`` restores
        the full train state from ``ckpt_dir`` and continues from the next
        epoch, giving the uninterrupted run's weights; ``stop_after`` caps
        the epochs run in this call; ``tensorboard_dir`` streams loss, val
        mAP50 and lr scalars.

        Two checkpoint faults of the JAX package (``yolo_recipe.py:901-919``)
        are not copied: the epoch at which patience stops the run writes
        ``last.npz`` and the train state like a final epoch, and an epoch
        without a validation value (NaN) does not count as an improvement
        for the writes (it still refreshes the best weights and the patience
        count, as in JAX).

        Data-parallel (``mesh``): every rank calls this with the same data;
        rank 0 alone validates, logs and writes (tensorboard included).
        """
        cfg = self.config
        main = self.rank == 0
        if not main:
            log, tensorboard_dir = (lambda *a, **k: None), None
        if val_images is None:
            n = train_images.shape[0]
            idx = np.random.default_rng(cfg.seed).permutation(n)
            n_val = max(1, int(round(n * cfg.val_fraction))) if n > 4 else 0
            if n_val:
                val_idx, tr_idx = idx[:n_val], idx[n_val:]
                val_images, val_gt, val_mask = train_images[val_idx], train_gt[val_idx], train_mask[val_idx]
                train_images, train_gt, train_cls, train_mask = (
                    train_images[tr_idx], train_gt[tr_idx], train_cls[tr_idx], train_mask[tr_idx],
                )

        d_images, d_gt, d_cls, d_mask = (
            torch.as_tensor(np.asarray(a)).to(self.device) for a in (train_images, train_gt, train_cls, train_mask)
        )

        history: list[EpochResult] = []
        best_map, best_epoch, start_epoch = -1.0, -1, 0
        self.best_state = self.state()

        if resume:
            if not ckpt_dir:
                raise ValueError("resume=True requires ckpt_dir")
            meta = self.load_state(ckpt_dir)
            if meta is not None:
                start_epoch = int(meta["epoch"]) + 1
                best_map, best_epoch = float(meta["best_map"]), int(meta["best_epoch"])
                best_path = os.path.join(ckpt_dir, "best.npz")
                if os.path.exists(best_path):
                    best = YoloV8Detector.load(best_path, device=self.device).model
                    self.best_state = best.state_dict()
                log(f"resumed from epoch {meta['epoch']} (best mAP50 {best_map:.3f})")

        writer = None
        if tensorboard_dir:
            from wtracker_tpu_torch.neural.training import summary_writer

            writer = summary_writer(tensorboard_dir)

        # one permutation stream threaded across epochs; a resumed run replays
        # the interrupted epochs' draws
        rng = np.random.default_rng(cfg.seed)
        for _ in range(start_epoch):
            self._epoch_order(d_images.shape[0], rng)

        ran = 0
        for e in range(start_epoch, cfg.epochs):
            if stop_after is not None and ran >= stop_after:
                break
            ran += 1
            t0 = time.perf_counter()
            loss = self.run_epoch(e, d_images, d_gt, d_cls, d_mask, rng)
            t1 = time.perf_counter()
            val_map = (
                evaluate_map50(
                    self.eval_model(), val_images, val_gt, val_mask, self.imgsz,
                    conf=cfg.val_conf, iou=cfg.val_iou, max_det=cfg.val_max_det,
                )
                if main and val_images is not None and len(val_images)
                else float("nan")
            )
            if self.mesh is not None:  # rank 0's value, on every rank
                import torch.distributed as dist

                box = [val_map]
                dist.broadcast_object_list(box, src=0)
                val_map = box[0]
            t2 = time.perf_counter()
            lr = self.schedule(self.step_count - 1)
            history.append(EpochResult(e, loss, val_map, lr, t1 - t0, t2 - t1))
            log(f"epoch {e}: loss {loss:.4f}  val mAP50 {val_map:.3f}  lr {lr:.2e}  train {t1 - t0:.3f} s  val {t2 - t1:.3f} s")
            if writer is not None:
                writer.add_scalar("train/loss", loss, e)
                if not np.isnan(val_map):
                    writer.add_scalar("val/mAP50", val_map, e)
                writer.add_scalar("train/lr", lr, e)

            # best weights refresh on mAP ties; the best epoch moves only on a
            # strict gain, so a plateau still trips the patience stop
            improved = np.isnan(val_map) or val_map > best_map
            if improved or val_map >= best_map:
                self.best_state = self.state()
            if improved:
                best_map = -1.0 if np.isnan(val_map) else val_map
                best_epoch = e
            stop = e - best_epoch >= cfg.patience
            last_epoch = stop or e == cfg.epochs - 1 or (stop_after is not None and ran >= stop_after)
            gained = improved and not np.isnan(val_map)
            if main and ckpt_dir and (gained or last_epoch or (e + 1) % cfg.ckpt_every == 0):
                self._save(os.path.join(ckpt_dir, "best.npz"), self.best_state)
                self._save(os.path.join(ckpt_dir, "last.npz"), self.state())
                self.save_state(ckpt_dir, e, best_map, best_epoch)
            if stop:
                log(f"early stop at epoch {e} (no val improvement for {cfg.patience})")
                break
        if writer is not None:
            writer.close()
        return history

    def detector(self, state: dict | None = None) -> YoloV8Detector:
        """A float32 :class:`YoloV8Detector` holding ``state`` (default: the
        best EMA weights), on the run's device."""
        model = YoloV8(nc=self.model.nc, scale=self.model.scale, reg_max=self.model.reg_max)
        model.load_state_dict(self.best_state if state is None else state)
        return YoloV8Detector(model.to(self.device).eval(), self.imgsz)

    def _save(self, path: str, state: dict) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.detector(state).save(path)
