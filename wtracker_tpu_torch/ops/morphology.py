"""Classical worm detection on the device: threshold, morphology, largest blob.

Port of :mod:`wtracker_tpu.ops.morphology`: background absdiff → binary
threshold → opening → dilation → bbox of the largest connected component,
batched over frames.  Erosion and dilation are ``max_pool2d`` windows on
float32 masks; the largest component comes from min-label flooding over the
3×3 neighbourhood (one max window over negated labels), repeated until no
label changes.

Semantics kept from the JAX package:

* erosion pads with +inf (borders do not erode), dilation with -inf;
* labels are float32 flat pixel indices (exact below 2**24 pixels a frame);
* one flood runs before the loop, then the loop floods while fewer than
  ``max_iters`` loop floods ran and the last flood changed a label, so at
  most ``max_iters + 1`` floods run; a batch runs until every frame has
  converged (a converged frame is a fixed point of the flood);
* blobs are ranked by pixel count, and on a tie the smallest root label
  (the first pixel in raster order) wins, as ``jnp.argmax`` picks;
* a frame without a blob gets the box (0, 0, 0, 0) and ``found`` False.

Convergence is read on the host only every :data:`CHECK_EVERY` floods:
floods after convergence change nothing, and the flood count still stops at
exactly the JAX package's cap.  ``largest_component_bbox.floods`` counts the
floods run (tests and ``chip_smoke.py`` read it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHECK_EVERY = 8  # floods between two host reads of "did any label change"


def _window_max(x: torch.Tensor, size: int, pad_value: float) -> torch.Tensor:
    """Max over a ``size``×``size`` window ("SAME": the output has the input's
    shape), padding with ``pad_value`` (-inf: the border never wins)."""
    lead = x.shape[:-2]
    x = x.reshape(-1, 1, *x.shape[-2:])
    lo = (size - 1) // 2
    if size % 2:  # max_pool2d's implicit padding is -inf, symmetric
        out = F.max_pool2d(x, size, stride=1, padding=lo)
    else:
        out = F.max_pool2d(F.pad(x, (lo, size - 1 - lo, lo, size - 1 - lo), value=pad_value), size, stride=1)
    return out.reshape(*lead, *out.shape[-2:])


def erode(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary erosion of a (..., H, W) mask with a ``size``×``size`` all-ones
    kernel; outside the frame counts as set."""
    return -_window_max(-mask.to(torch.float32), size, -float("inf")) > 0.5


def dilate(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary dilation of a (..., H, W) mask with a ``size``×``size`` all-ones
    kernel; outside the frame counts as clear."""
    return _window_max(mask.to(torch.float32), size, -float("inf")) > 0.5


def opening(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Morphological opening (erode → dilate)."""
    return dilate(erode(mask, size), size)


def _propagate_negated(neg_labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One flood on negated labels: each set pixel takes the least label of
    its 3×3 neighbourhood, itself included (the greatest negated label)."""
    return torch.where(mask, _window_max(neg_labels, 3, -float("inf")), -float("inf"))


def largest_component_bbox(mask: torch.Tensor, max_iters: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Bbox (x, y, w, h) of the largest connected component of each (N, H, W)
    (or (H, W)) binary mask.

    Returns ``(bbox int32 (N, 4), found bool (N,))`` (no batch axis for a
    single mask); the bbox is (0, 0, 0, 0) where a mask is empty.
    """
    single = mask.ndim == 2
    if single:
        mask = mask[None]
    n, h, w = mask.shape
    # labels are held negated, so that a flood is one max window
    idx = torch.arange(h * w, dtype=torch.float32, device=mask.device).reshape(h, w)
    neg = torch.where(mask, -idx, -float("inf"))

    neg = _propagate_negated(neg, mask)
    floods, it = 1, 0
    while it < max_iters:
        block = min(CHECK_EVERY, max_iters - it)
        for _ in range(block):
            prev, neg = neg, _propagate_negated(neg, mask)
        floods, it = floods + block, it + block
        if not bool((neg != prev).any()):
            break
    largest_component_bbox.floods += floods
    labels = -neg

    # pixel counts per root label: the (frame, label) pairs of set pixels
    frame_of, ys, xs = torch.nonzero(mask, as_tuple=True)
    roots = labels[frame_of, ys, xs].to(torch.int64)
    keys, counts = torch.unique(frame_of * (h * w) + roots, return_counts=True)  # sorted by frame, then label
    key_frame = keys // (h * w)
    best_count = torch.zeros(n, dtype=counts.dtype, device=mask.device).scatter_reduce(
        0, key_frame, counts, reduce="amax", include_self=True
    )
    candidate = torch.where(counts == best_count[key_frame], keys, torch.iinfo(torch.int64).max)
    best_key = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=mask.device).scatter_reduce(
        0, key_frame, candidate, reduce="amin", include_self=True
    )
    found = best_count > 0
    best_label = torch.where(found, best_key - torch.arange(n, device=mask.device) * (h * w), 0)

    sel = (labels == best_label.to(torch.float32)[:, None, None]) & mask
    rows, cols = sel.any(dim=2), sel.any(dim=1)
    big = torch.iinfo(torch.int32).max
    ys_ = torch.arange(h, dtype=torch.int32, device=mask.device)
    xs_ = torch.arange(w, dtype=torch.int32, device=mask.device)
    y0 = torch.where(rows, ys_, big).amin(dim=1)
    y1 = torch.where(rows, ys_, -1).amax(dim=1)
    x0 = torch.where(cols, xs_, big).amin(dim=1)
    x1 = torch.where(cols, xs_, -1).amax(dim=1)
    bbox = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=1)
    bbox = torch.where(found[:, None], bbox, 0).to(torch.int32)
    return (bbox[0], found[0]) if single else (bbox, found)


largest_component_bbox.floods = 0


def worm_bboxes_batch(
    frames: torch.Tensor,
    background: torch.Tensor,
    diff_thresh: int = 20,
    open_size: int = 5,
    dilate_size: int = 11,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) uint8 gray frames + (H, W) uint8 background → (N, 4) int32
    xywh boxes of the largest blob and (N,) ``found``, on the frames' device.
    The difference is taken in int32: uint8 would wrap."""
    diff = (frames.to(torch.int32) - background.to(torch.int32)).abs()
    mask = dilate(opening(diff > diff_thresh, open_size), dilate_size)
    return largest_component_bbox(mask)


def worm_bbox_from_frame(
    frame: torch.Tensor,
    background: torch.Tensor,
    diff_thresh: int = 20,
    open_size: int = 5,
    dilate_size: int = 11,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pipeline for one (H, W) gray frame: ``(bbox int32 (4,), found)``."""
    bbox, found = worm_bboxes_batch(frame[None], background, diff_thresh, open_size, dilate_size)
    return bbox[0], found[0]
