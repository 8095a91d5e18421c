"""Tracking-error metrics: bbox, MSE, and segmentation-based precise error.

Port of :mod:`wtracker_tpu.eval.error_calculator`.  The per-frame functions
(``calculate_segmentation``, ``calculate_precise`` with its ``probe_hook``
test seam, ``calculate_bbox_error``, ``calculate_mse_error``) are numpy on
the host, as in the JAX package.  The batched precise error
(:func:`precise_error_batched`, :func:`precise_error_tiles`) runs as torch
ops on the device: worm crops padded to one tile, the background uploaded
once and its windows gathered by index arithmetic, then a masked count.
Every step keeps the JAX package's dtypes (int32 differences, int64 counts,
a float64 ratio, float32 errors), so the errors are equal, not close.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from wtracker_tpu_torch.dataset.box_calculator import bgr_to_gray
from wtracker_tpu_torch.utils import bbox as bb
from wtracker_tpu_torch.utils.bbox import BoxFormat
from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.frame_reader import FrameReader


class ErrorCalculator:
    """Static methods computing per-frame tracking errors."""

    probe_hook: Callable[[np.ndarray, np.ndarray], None] = None
    """Optional callback receiving (worm_view, segmentation_mask) per frame —
    the reference's only purpose-built test seam."""

    @staticmethod
    def calculate_segmentation(
        bbox: np.ndarray,
        image: np.ndarray,
        background: np.ndarray,
        diff_thresh: float,
    ) -> np.ndarray:
        """Foreground mask of a worm view vs the matching background window."""
        x, y, w, h = bbox
        assert image.shape[:2] == (h, w)

        bg_view = background[y : y + h, x : x + w]
        diff = np.abs(image.astype(np.int32) - bg_view.astype(np.int32)).astype(np.uint8)

        if diff.ndim == 3 and diff.shape[2] == 3:
            diff = bgr_to_gray(diff)
        if diff.ndim != 2:
            raise ValueError("Image must be either a gray or a color image.")

        return diff > diff_thresh

    @staticmethod
    def calculate_precise(
        background: np.ndarray,
        worm_bboxes: np.ndarray,
        mic_bboxes: np.ndarray,
        frame_nums: np.ndarray,
        worm_reader: FrameReader,
        diff_thresh: float = 10,
    ) -> np.ndarray:
        """Fraction of segmented worm pixels outside the microscope view.

        ``worm_reader`` returns, per frame number, the worm view cropped to the
        matching (discretized) worm bbox.  Illegal/missing bboxes yield NaN.
        """
        assert frame_nums.ndim == 1
        assert len(frame_nums) == worm_bboxes.shape[0] == mic_bboxes.shape[0]

        errors = np.zeros(len(frame_nums), dtype=float)
        bounds = background.shape[:2]

        worm_bboxes, is_legal = bb.discretize(worm_bboxes, bounds=bounds, box_format=BoxFormat.XYWH)
        mic_bboxes, _ = bb.discretize(mic_bboxes, bounds=bounds, box_format=BoxFormat.XYWH)

        errors[~is_legal] = np.nan
        worm_bboxes = worm_bboxes[is_legal]
        mic_bboxes = mic_bboxes[is_legal]
        frame_nums = frame_nums[is_legal]

        # intersection of worm and microscope boxes, in worm-view coordinates
        wrm_xyxy = bb.to_xyxy(worm_bboxes, BoxFormat.XYWH)
        mic_xyxy = bb.to_xyxy(mic_bboxes, BoxFormat.XYWH)
        int_tl = np.maximum(wrm_xyxy[:, :2], mic_xyxy[:, :2])
        int_br = np.minimum(wrm_xyxy[:, 2:], mic_xyxy[:, 2:])
        int_wh = np.maximum(int_br - int_tl, 0)
        int_tl -= wrm_xyxy[:, :2]

        out_idx = np.flatnonzero(is_legal)
        for i, frame_num in enumerate(frame_nums):
            worm_view = worm_reader[frame_num]
            mask_wrm = ErrorCalculator.calculate_segmentation(
                bbox=worm_bboxes[i], image=worm_view, background=background, diff_thresh=diff_thresh
            )

            if ErrorCalculator.probe_hook is not None:
                ErrorCalculator.probe_hook(worm_view, mask_wrm)

            mask_mic = np.zeros_like(mask_wrm, dtype=bool)
            mask_mic[int_tl[i, 1] : int_tl[i, 1] + int_wh[i, 1], int_tl[i, 0] : int_tl[i, 0] + int_wh[i, 0]] = True

            total = mask_wrm.sum()
            if total == 0:
                errors[out_idx[i]] = 0.0
                continue
            intersection = np.logical_and(mask_wrm, mask_mic).sum()
            errors[out_idx[i]] = 1.0 - intersection / total

        return errors

    @staticmethod
    def calculate_bbox_error(worm_bboxes: np.ndarray, mic_bboxes: np.ndarray) -> np.ndarray:
        """Fraction of the worm bbox area outside the microscope bbox."""
        wrm = bb.to_xyxy(np.asarray(worm_bboxes, dtype=float), BoxFormat.XYWH)
        mic = bb.to_xyxy(np.asarray(mic_bboxes, dtype=float), BoxFormat.XYWH)

        int_tl = np.maximum(wrm[..., :2], mic[..., :2])
        int_br = np.minimum(wrm[..., 2:], mic[..., 2:])
        int_wh = np.maximum(int_br - int_tl, 0)

        intersection = int_wh[..., 0] * int_wh[..., 1]
        total = np.asarray(worm_bboxes)[..., 2] * np.asarray(worm_bboxes)[..., 3]

        with np.errstate(invalid="ignore", divide="ignore"):
            errors = 1.0 - intersection / total
        errors = np.asarray(errors)
        errors[total == 0] = 0.0
        return errors

    @staticmethod
    def calculate_mse_error(worm_bboxes: np.ndarray, mic_bboxes: np.ndarray) -> np.ndarray:
        """Mean squared distance between worm and microscope centers."""
        worm_centers = bb.center(np.asarray(worm_bboxes, dtype=float))
        mic_centers = bb.center(np.asarray(mic_bboxes, dtype=float))
        return np.mean((worm_centers - mic_centers) ** 2, axis=-1)


# ---------------------------------------------------------------------------
# batched, on the device
# ---------------------------------------------------------------------------


def _precise_tile_math(worm_views, bg_views, view_hw, int_tlwh, diff_thresh):
    """Mask and intersection over padded (N, H, W) tiles: (N,) float32 errors."""
    H, W = worm_views.shape[1:3]
    ys = torch.arange(H, device=worm_views.device)[None, :, None]
    xs = torch.arange(W, device=worm_views.device)[None, None, :]

    valid = (ys < view_hw[:, 0, None, None]) & (xs < view_hw[:, 1, None, None])
    diff = (worm_views.to(torch.int32) - bg_views.to(torch.int32)).abs()
    mask_wrm = (diff > diff_thresh) & valid

    x0 = int_tlwh[:, 0, None, None]
    y0 = int_tlwh[:, 1, None, None]
    in_mic = (xs >= x0) & (xs < x0 + int_tlwh[:, 2, None, None]) & (ys >= y0) & (ys < y0 + int_tlwh[:, 3, None, None])

    total = mask_wrm.sum(dim=(1, 2))
    inter = (mask_wrm & in_mic).sum(dim=(1, 2))
    err = 1.0 - inter.to(torch.float64) / total.clamp(min=1).to(torch.float64)
    return torch.where(total == 0, 0.0, err).to(torch.float32)


def _on(device: torch.device, a, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def precise_error_batched(
    worm_views: np.ndarray,
    bg_views: np.ndarray,
    view_hw: np.ndarray,
    int_tlwh: np.ndarray,
    diff_thresh: float = 10,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Batched precise error on the device (caller-assembled background crops).

    Args:
        worm_views: (N, H, W) uint8 worm crops (padded).
        bg_views: (N, H, W) uint8 matching background crops (padded).
        view_hw: (N, 2) int — valid (h, w) of each crop.
        int_tlwh: (N, 4) int — micro∩worm rectangle in view coords (x, y, w, h).
        diff_thresh: foreground threshold.
        device: where the math runs.

    Returns:
        (N,) float32 errors (fraction of worm pixels outside the micro view),
        on ``device``.
    """
    dev = resolve_device(device)
    return _precise_tile_math(
        _on(dev, worm_views), _on(dev, bg_views), _on(dev, view_hw), _on(dev, int_tlwh), diff_thresh
    )


def precise_error_tiles(
    background,
    worm_views: np.ndarray,
    boxes_xywh: np.ndarray,
    int_tlwh: np.ndarray,
    diff_thresh: float = 10,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Batched precise error with the background windows gathered on the device.

    The full arena background is uploaded once (pass it as a tensor on
    ``device`` to reuse it across calls) and padded by the tile's (H, W), so
    a window starting anywhere inside the arena never clamps; each worm box's
    window is gathered by row and column indices.

    Args:
        background: (Hbg, Wbg) uint8 full-arena background (numpy or tensor).
        worm_views: (N, H, W) uint8 worm crops, zero-padded to the tile.
        boxes_xywh: (N, 4) int discretized worm boxes in arena coords.
        int_tlwh: (N, 4) int — micro∩worm rectangle in view coords (x, y, w, h).
        diff_thresh: foreground threshold.
        device: where the math runs.

    Returns:
        (N,) float32 errors on ``device``.
    """
    dev = resolve_device(device)
    views = _on(dev, worm_views)
    H, W = views.shape[1:3]
    bgp = torch.nn.functional.pad(_on(dev, background), (0, W, 0, H))
    boxes = _on(dev, boxes_xywh, torch.int64)
    rows = boxes[:, 1, None] + torch.arange(H, device=dev)
    cols = boxes[:, 0, None] + torch.arange(W, device=dev)
    bg_views = bgp[rows[:, :, None], cols[:, None, :]]
    return _precise_tile_math(views, bg_views, boxes[:, [3, 2]], _on(dev, int_tlwh, torch.int64), diff_thresh)
