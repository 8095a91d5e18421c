"""The port's box ops, greedy NMS and ``detect_multi`` against the JAX package.

Reference: ``wtracker_tpu/ops/boxes.py``, ``wtracker_tpu/ops/nms.py`` and
``YoloV8Detector.detect_multi`` (``wtracker_tpu/models/yolov8.py``).  Box
ops are exact.  NMS runs on boxes with integer corners, so every area and
intersection is exact and the IoU of both sides is one division: kept boxes,
scores and validity are equal, ties in score included (first maximum wins).
``detect_multi`` on the trained checkpoint keeps boxes at IoU >= 0.99
(BASELINE.md's bar) with the same validity.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.ops import boxes as jb
from wtracker_tpu.utils.bbox import BoxFormat as JaxBoxFormat
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.ops import boxes as tb
from wtracker_tpu_torch.utils.bbox import BoxFormat

torch.set_num_threads(2)

CHECKPOINT = "models/yolov8s_worm416.npz"
jn = importlib.import_module("wtracker_tpu.ops.nms")  # the package re-exports the function as ops.nms
tn = importlib.import_module("wtracker_tpu_torch.ops.nms")  # so is the port's


def _boxes(rng, shape, fmt):
    xy = rng.uniform(-20, 300, shape + (2,))
    wh = rng.uniform(0.5, 60, shape + (2,))
    b = np.concatenate([xy, wh], axis=-1).astype(np.float32)
    if fmt == BoxFormat.XYXY:
        b[..., 2:] += b[..., :2]
    elif fmt == BoxFormat.YOLO:
        b[..., :2] += b[..., 2:] / 2
    b[::7] = np.nan  # missing detections flow through
    return b


@pytest.mark.parametrize("fmt", list(BoxFormat), ids=lambda f: f.name)
def test_box_ops_exact(fmt):
    rng = np.random.default_rng(3)
    b = _boxes(rng, (40,), fmt)
    c = _boxes(rng, (40,), BoxFormat.XYXY)
    j, t = jnp.asarray(b), torch.from_numpy(b)
    jfmt = JaxBoxFormat[fmt.name]  # each package has its own enum
    pairs = [
        (jb.to_xyxy(j, jfmt), tb.to_xyxy(t, fmt)),
        (jb.to_xywh(j, jfmt), tb.to_xywh(t, fmt)),
        (jb.to_yolo(j, jfmt), tb.to_yolo(t, fmt)),
        (jb.center(j, jfmt), tb.center(t, fmt)),
        (jb.round_boxes(j, jfmt), tb.round_boxes(t, fmt)),
        *zip(jb.discretize(j, (240, 280), jfmt), tb.discretize(t, (240, 280), fmt)),
        (jb.box_iou(jnp.asarray(c), jb.to_xyxy(j, jfmt)), tb.box_iou(torch.from_numpy(c), tb.to_xyxy(t, fmt))),
        (jb.intersect_area(jnp.asarray(c), jb.to_xyxy(j, jfmt)), tb.intersect_area(torch.from_numpy(c), tb.to_xyxy(t, fmt))),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        assert str(want.dtype) == str(got.dtype).removeprefix("torch."), (want.dtype, got.dtype)
        np.testing.assert_array_equal(got.numpy(), want)


def _nms_inputs(seed, B=3, A=60):
    """Integer-corner boxes in clusters (so suppression happens), scores on
    a coarse grid (so ties happen), some below the score floor."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(20, 200, (B, 5, 2))
    pick = rng.integers(0, 5, (B, A))
    c = np.take_along_axis(centres, pick[..., None], axis=1) + rng.integers(-6, 7, (B, A, 2))
    wh = rng.integers(4, 30, (B, A, 2))
    boxes = np.concatenate([c - wh // 2, c - wh // 2 + wh], axis=-1).astype(np.float32)
    scores = (rng.integers(0, 12, (B, A)) / 12.0).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou,conf,max_det", [(0.45, 0.1, 100), (0.7, 0.001, 8), (0.3, 0.5, 20)])
def test_batched_nms_equals_jax(seed, iou, conf, max_det):
    boxes, scores = _nms_inputs(seed)
    want = jn.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), iou, conf, max_det)
    got = tn.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), iou, conf, max_det)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all() or max_det <= 8  # some slots used, some left


def test_nms_one_image_equals_jax():
    boxes, scores = _nms_inputs(5, B=1)
    want = jn.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5, 0.2, 30)
    got = tn.nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.5, 0.2, 30)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _worm_views(centers, hw=(360, 360), seed=0):
    """Noisy background plus an elongated Gaussian worm blob per view."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0 : hw[0], 0 : hw[1]].astype(np.float32)
    out = []
    for cx, cy in centers:
        blob = 160.0 * np.exp(-0.5 * (((xs - cx) / 5.0) ** 2 + ((ys - cy) / 3.0) ** 2))
        out.append(np.clip(rng.normal(40, 6, hw) + blob, 0, 255).astype(np.uint8))
    return np.stack(out)


def _iou_xywh(a, b):
    lo = np.maximum(a[..., :2], b[..., :2])
    hi = np.minimum(a[..., :2] + a[..., 2:], b[..., :2] + b[..., 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter)


def test_detect_multi_trained_checkpoint():
    """The committed s/416 checkpoint on two 360 px views with a worm each."""
    jdet = jy.YoloV8Detector.load(CHECKPOINT, imgsz=416)
    tdet = ty.YoloV8Detector.load(CHECKPOINT, imgsz=416, device="cpu")
    views = _worm_views([(100.3, 150.7), (250.0, 60.2)])
    want = [np.asarray(a) for a in jax.jit(lambda f: jdet.detect_multi(f, max_det=20, iou=0.7))(views)]
    got = [t.numpy() for t in tdet.detect_multi(torch.from_numpy(views), max_det=20, iou=0.7)]
    np.testing.assert_array_equal(got[2], want[2])
    v = want[2]
    assert v.any()
    assert (_iou_xywh(got[0][v], want[0][v]) >= 0.99).all()
    np.testing.assert_allclose(got[1][v], want[1][v], rtol=1e-4)
    assert (got[0][~v] == 0).all() and (got[1][~v] == 0).all()
