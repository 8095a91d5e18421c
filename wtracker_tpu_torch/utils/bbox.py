"""Bounding-box utilities (host / numpy side).

Port of :mod:`wtracker_tpu.utils.bbox` (itself the reference's
``wtracker/utils/bbox_utils.py``: BoxFormat, BoxUtils, BoxConverter): the
same numpy code, kept here so that the port imports nothing of the JAX
package.  Vectorized slicing on ``(..., 4)`` arrays.

Formats:
    XYWH — (x_left, y_top, width, height)
    XYXY — (x_left, y_top, x_right, y_bottom)
    YOLO — (x_center, y_center, width, height)

Behavioral invariants preserved from the reference:
    * ``round_boxes`` floors the top-left corner and ceils the bottom-right corner
      so that rounded boxes always cover the input box.
    * ``discretize`` zeroes out non-finite boxes, clamps to ``(h, w)`` bounds and
      returns a legality mask; degenerate (zero-area) boxes are also zeroed.
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class BoxFormat(Enum):
    """Bounding-box coordinate conventions."""

    XYWH = 0
    XYXY = 1
    YOLO = 2


# ---------------------------------------------------------------------------
# functional core
# ---------------------------------------------------------------------------


def is_bbox(array: np.ndarray) -> bool:
    """True when the trailing axis holds 4 coordinates."""
    return array.shape[-1] == 4


def unpack(bbox: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split a ``(..., 4)`` box array into its four coordinate components."""
    return bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]


def pack(c1: np.ndarray, c2: np.ndarray, c3: np.ndarray, c4: np.ndarray) -> np.ndarray:
    """Stack four coordinate components into a ``(..., 4)`` box array."""
    return np.stack(np.broadcast_arrays(c1, c2, c3, c4), axis=-1)


def to_xyxy(bbox: np.ndarray, src_format: BoxFormat) -> np.ndarray:
    if src_format == BoxFormat.XYXY:
        return bbox
    out = np.array(bbox, dtype=bbox.dtype, copy=True)
    if src_format == BoxFormat.YOLO:
        out[..., :2] -= out[..., 2:] / 2
    out[..., 2:] += out[..., :2]
    return out


def to_xywh(bbox: np.ndarray, src_format: BoxFormat) -> np.ndarray:
    if src_format == BoxFormat.XYWH:
        return bbox
    out = np.array(bbox, dtype=bbox.dtype, copy=True)
    if src_format == BoxFormat.XYXY:
        out[..., 2:] -= out[..., :2]
    else:  # YOLO: center -> corner
        out[..., :2] -= out[..., 2:] / 2
    return out


def to_yolo(bbox: np.ndarray, src_format: BoxFormat) -> np.ndarray:
    if src_format == BoxFormat.YOLO:
        return bbox
    out = np.array(bbox, dtype=bbox.dtype, copy=True)
    if src_format == BoxFormat.XYXY:
        out[..., 2:] -= out[..., :2]
    out[..., :2] += out[..., 2:] / 2
    return out


def change_format(bbox: np.ndarray, src_format: BoxFormat, dst_format: BoxFormat) -> np.ndarray:
    """Convert between any two box formats.

    Note: the reference maps ``dst=YOLO`` to an XYWH conversion
    (bbox_utils.py:195-196, an upstream bug).  We implement the correct YOLO
    conversion; callers relying on the quirk should call :func:`to_xywh`.
    """
    if dst_format == BoxFormat.XYXY:
        return to_xyxy(bbox, src_format)
    if dst_format == BoxFormat.XYWH:
        return to_xywh(bbox, src_format)
    if dst_format == BoxFormat.YOLO:
        return to_yolo(bbox, src_format)
    raise ValueError(f"unsupported bbox format conversion: {src_format} -> {dst_format}")


def center(bboxes: np.ndarray, box_format: BoxFormat = BoxFormat.XYWH) -> np.ndarray:
    """Box centers as an array shaped ``(..., 2)`` — format ``(cx, cy)``."""
    b = to_xywh(bboxes, box_format)
    return b[..., :2] + b[..., 2:] / 2


def round_boxes(bboxes: np.ndarray, box_format: BoxFormat) -> np.ndarray:
    """Outward-round boxes to integer pixel coordinates (floor TL, ceil BR)."""
    b = to_xyxy(bboxes, box_format)
    out = np.empty_like(b, dtype=np.int32)
    out[..., :2] = np.floor(b[..., :2])
    out[..., 2:] = np.ceil(b[..., 2:])
    return change_format(out, BoxFormat.XYXY, box_format)


def discretize(
    bboxes: np.ndarray,
    bounds: tuple[int, int],
    box_format: BoxFormat,
) -> tuple[np.ndarray, np.ndarray]:
    """Integer-round and clamp boxes to image ``bounds`` (h, w); flag legality.

    Returns ``(boxes_int32, is_legal)``.  Non-finite and degenerate boxes are
    zeroed out and marked illegal, making results safe for image slicing.
    """
    bboxes = np.asarray(bboxes, dtype=float)
    finite = np.isfinite(bboxes).all(axis=-1)
    bboxes = np.where(finite[..., None], bboxes, 0.0)

    b = round_boxes(to_xyxy(bboxes, box_format), BoxFormat.XYXY)
    h, w = bounds
    b[..., 0::2] = np.clip(b[..., 0::2], 0, w)
    b[..., 1::2] = np.clip(b[..., 1::2], 0, h)

    is_legal = finite & (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
    b = np.where(is_legal[..., None], b, 0).astype(np.int32)
    return change_format(b, BoxFormat.XYXY, box_format), is_legal.astype(bool)


# ---------------------------------------------------------------------------
# class facades (reference-compatible API surface)
# ---------------------------------------------------------------------------


class BoxUtils:
    """Reference-compatible facade over the functional box ops."""

    is_bbox = staticmethod(is_bbox)
    unpack = staticmethod(unpack)
    pack = staticmethod(pack)
    center = staticmethod(center)
    round = staticmethod(round_boxes)
    discretize = staticmethod(discretize)


class BoxConverter:
    """Reference-compatible facade over the format conversions."""

    change_format = staticmethod(change_format)
    to_xyxy = staticmethod(to_xyxy)
    to_xywh = staticmethod(to_xywh)
    to_yolo = staticmethod(to_yolo)
