"""The shipped detector's quality gates, as plain functions.

Port of the JAX package's five flagship gates, from the bodies of its tests
(``tests/test_trained_detector.py``, ``tests/test_yolov8.py::
test_full_network_parity_flagship_scale``, ``tests/test_yolov8_int8.py::
test_int8_drift_flagship_scale``), at the deployed configuration: YOLOv8s at
416 px on 360 px camera views.  Each gate returns its numbers, the hand
kernels it launched, the thresholds (the JAX tests' own) and whether it
passed; ``run_gates`` writes them to ``GATES_TORCH.json``.

- :func:`map50_heldout`: AP@0.5 of the trained checkpoint on a held-out
  rendered set (:func:`heldout_set`, seed disjoint from training).
- :func:`trained_int8_drift`: int8 post-training quantization of the trained
  weights; the folded-stem int8 detector's top-1 centre against the bf16
  detector's on held-out rendered views.
- :func:`closed_loop_tracking`: the trained detector (bf16, folded stem)
  and the seeded ResMLP driving the synthetic live loop at the deployment
  geometry.
- :func:`int8_drift_s416`: the int8 drift on random s weights.
- :func:`s416_parity`: the s/416 detector on the given device against the
  same weights in float32 on the CPU, anchor-matched (the JAX package's gate
  held its port of the reference network against Flax; a CPU test holds
  :func:`anchor_matched` between this package and the JAX package).

On the card every gate runs there (no fallback to the CPU or to a kernel's
plain version): the two int8 gates must launch the int8 convolution kernel
(K2) and no gate may launch the crop+letterbox kernel (K1), whose work the
folded stem takes over.
"""

from __future__ import annotations

import contextlib
import copy
import operator

import numpy as np
import torch

IMGSZ = 416
CAM = 360
ARENA = (1400, 1600)  # (h, w) of the gate experiment and of the drift views

# the JAX tests' bars: {number: (comparison, limit)}
DRIFT_BAR = {"median_drift_px": ("<=", 1.0), "within_8px_share": (">=", 0.75)}
THRESHOLDS = {
    "map50_heldout": {"ap50": (">=", 0.80)},
    "trained_int8_drift": dict(DRIFT_BAR),
    "closed_loop_tracking": {
        "detection_rate": (">=", 0.95),
        "median_center_err_px": ("<=", 4.0),
        "in_camera_share_after_cycle_3": (">=", 0.95),
        "median_worm_deviation_px": ("<=", 60.0),
    },
    "int8_drift_s416": dict(DRIFT_BAR),
    "s416_parity": {"max_top_score_diff": ("<", 2e-3), "min_candidate_iou": (">=", 0.99)},
}
_COMPARE = {"<": operator.lt, "<=": operator.le, ">=": operator.ge}


@contextlib.contextmanager
def counted_launches():
    """Yields a dict that holds, once the block ends, how many times each
    hand kernel launched inside it."""
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views

    k1, k2 = crop_letterbox_views.launches, conv_s8.launches
    out: dict = {}
    yield out
    out.update(crop_letterbox=crop_letterbox_views.launches - k1, conv_s8=conv_s8.launches - k2)


def verdict(name: str, numbers: dict, launches: dict, device, int8: bool = False) -> dict:
    """``numbers`` against the gate's thresholds (a NaN fails).  On the card
    a gate that launched K1, or an int8 gate that never launched K2,
    raises."""
    if torch.device(device).type == "cuda":
        if launches["crop_letterbox"]:
            raise AssertionError(f"{name} launched crop_letterbox {launches['crop_letterbox']} times")
        if int8 and not launches["conv_s8"]:
            raise AssertionError(f"{name} ran its int8 detector without a conv_s8 launch")
    bar = THRESHOLDS[name]
    failed = sorted(k for k, (op, limit) in bar.items() if not _COMPARE[op](numbers[k], limit))
    return {
        **numbers,
        "launches": launches,
        "thresholds": {k: f"{op} {limit}" for k, (op, limit) in bar.items()},
        "failed": failed,
        "pass": not failed,
    }


# ---------------------------------------------------------------------------
# held-out accuracy
# ---------------------------------------------------------------------------


def heldout_set(n: int = 24, seed: int = 12345, imgsz: int = IMGSZ, max_gt: int = 4):
    """``n`` freshly rendered labeled images (the training set was rendered
    with seed 7), letterboxed to ``imgsz`` as the training loader does:
    (n, s, s, 3) float32 in [0, 1], (n, max_gt, 4) xyxy boxes in pixels and
    their (n, max_gt) mask."""
    from wtracker_tpu_torch.neural.yolo_recipe import resize_gray_uint8
    from wtracker_tpu_torch.tools.make_synthetic_dataset import DEFAULT_GEOMETRIES, render_image

    rng = np.random.default_rng(seed)
    images = np.zeros((n, imgsz, imgsz, 3), np.float32)
    gts = np.zeros((n, max_gt, 4), np.float32)
    masks = np.zeros((n, max_gt), bool)
    for i in range(n):
        scene_exact = rng.uniform() < 0.5
        hw = (360, 360) if scene_exact else DEFAULT_GEOMETRIES[int(rng.integers(1, len(DEFAULT_GEOMETRIES)))]
        img, boxes = render_image(rng, hw, scene_exact)
        sh, sw = img.shape
        scale = min(imgsz / sh, imgsz / sw)
        nh, nw = round(sh * scale), round(sw * scale)
        pt, pl = (imgsz - nh) // 2, (imgsz - nw) // 2
        canvas = np.full((imgsz, imgsz), 114, np.uint8)
        canvas[pt : pt + nh, pl : pl + nw] = resize_gray_uint8(img, nh, nw) if (nh, nw) != (sh, sw) else img
        for j, (x0, y0, x1, y1) in enumerate(boxes[:max_gt]):
            gts[i, j] = (x0 * scale + pl, y0 * scale + pt, x1 * scale + pl, y1 * scale + pt)
            masks[i, j] = True
        images[i] = canvas[..., None].astype(np.float32) / 255.0
    return images, gts, masks


def map50_heldout(checkpoint: str, device="cuda", n: int = 24, seed: int = 12345, imgsz: int = IMGSZ) -> dict:
    """AP@0.5 of the float32 checkpoint on :func:`heldout_set` (conf 0.001,
    NMS IoU 0.7, 8 detections an image): at least 0.80."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural.yolo_recipe import evaluate_map50

    model = YoloV8Detector.load(checkpoint, imgsz=imgsz, device=device).model
    images, gt, mask = heldout_set(n, seed, imgsz)
    with counted_launches() as launches:
        ap = evaluate_map50(model, images, gt, mask, (imgsz, imgsz), conf=0.001, iou=0.7, max_det=8)
    return verdict("map50_heldout", {"images": n, "ap50": ap}, launches, device)


# ---------------------------------------------------------------------------
# int8 drift
# ---------------------------------------------------------------------------


def drift_views(traj_seed: int, n: int, cam: int = CAM, device="cuda") -> torch.Tensor:
    """(n, cam, cam) float32 views of ``SyntheticScene`` along the first n
    frames of a 64-frame trajectory, centred on the worm, inside the
    arena."""
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

    traj = make_trajectory(64, ARENA, seed=traj_seed)
    xy = torch.tensor(traj[:n], dtype=torch.float32, device=device)
    hi = torch.tensor([ARENA[1] - cam, ARENA[0] - cam], dtype=torch.float32, device=device)
    tls = torch.minimum((xy - cam / 2).clamp_min(0), hi)
    return SyntheticScene().render_views(xy, tls, (cam, cam), torch.arange(n, device=device))


def drift_boxes(model32, q, views: torch.Tensor, imgsz: int = IMGSZ) -> tuple[np.ndarray, np.ndarray]:
    """Top-1 xywh boxes at conf 0 of the bf16 detector (standard letterbox)
    and of the quantized detector ``q`` (folded stem), on ``views``."""
    from wtracker_tpu_torch.models.yolov8 import detect_top1
    from wtracker_tpu_torch.models.yolov8_int8 import make_detect_fns

    size = (imgsz, imgsz)
    bf16 = copy.deepcopy(model32).to(torch.bfloat16)
    detect_int8, _ = make_detect_fns(q, src_hw=tuple(views.shape[1:3]), imgsz=size, device=views.device)
    with torch.inference_mode():
        ref = detect_top1(bf16, views, size, 0.0)
        got = detect_int8(None, views, size, 0.0)
    return ref.cpu().numpy(), got.cpu().numpy()


def drift_numbers(ref: np.ndarray, got: np.ndarray) -> dict:
    """Top-1 centre drift of ``got`` from ``ref`` (a missing box is NaN and
    fails the bar)."""
    drift = np.hypot(*((ref[:, :2] + ref[:, 2:] / 2) - (got[:, :2] + got[:, 2:] / 2)).T)
    return {
        "median_drift_px": float(np.median(drift)),
        "within_8px_share": float((drift < 8.0).mean()),
        "max_drift_px": float(drift.max()),
    }


def _int8_drift(name, model32, device, calib, heldout, cam, imgsz, traj_seed) -> dict:
    from wtracker_tpu_torch.models.yolov8_int8 import quantize_detector

    views = drift_views(traj_seed, calib + heldout, cam, device)
    with counted_launches() as launches:
        q = quantize_detector(model32, views[:calib], (imgsz, imgsz))
        ref, got = drift_boxes(model32, q, views[calib:], imgsz)
    numbers = {"calibration_views": calib, "views": heldout, **drift_numbers(ref, got)}
    return verdict(name, numbers, launches, device, int8=True)


def trained_int8_drift(
    checkpoint: str, device="cuda", calib: int = 32, heldout: int = 16, cam: int = CAM, imgsz: int = IMGSZ,
    traj_seed: int = 21,
) -> dict:
    """int8 quantization of the trained checkpoint, calibrated on ``calib``
    views: top-1 centre drift from bf16 on ``heldout`` other views, median
    at most 1 px and at least 75 % of views within 8 px."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    model32 = YoloV8Detector.load(checkpoint, imgsz=imgsz, device=device).fuse().model
    return _int8_drift("trained_int8_drift", model32, device, calib, heldout, cam, imgsz, traj_seed)


def int8_drift_s416(
    device="cuda", scale: str = "s", seed: int = 0, calib: int = 32, heldout: int = 16, cam: int = CAM,
    imgsz: int = IMGSZ, traj_seed: int = 11,
) -> dict:
    """:func:`trained_int8_drift`'s bar on random weights (Flax's init from
    ``seed``, BN-fused)."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    model32 = YoloV8Detector.init_random(nc=1, scale=scale, imgsz=imgsz, seed=seed, device=device).fuse().model
    return _int8_drift("int8_drift_s416", model32, device, calib, heldout, cam, imgsz, traj_seed)


# ---------------------------------------------------------------------------
# closed-loop tracking
# ---------------------------------------------------------------------------


def deployment_params():
    """The engine parameters of the deployment geometry (the gate experiment
    and the JAX bench's): 60 fps, 1400x1600 px arena at 90 px/mm, a 4 mm
    (360 px) camera, timing 200/40/50 ms (12 + 3 frames a cycle), headless
    frame bounds."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams, headless_frame_shape

    exp = ExperimentConfig("gate", 400, 60, ARENA, 90, (700, 700))
    timing = TimingConfig(
        experiment_config=exp, imaging_time_ms=200.0, pred_time_ms=40.0, moving_time_ms=50.0,
        camera_size_mm=(4.0, 4.0), micro_size_mm=(0.32, 0.32),
    )
    return EngineParams.from_timing(timing, headless_frame_shape(timing, exp.orig_resolution))


def closed_loop_logs(params, model, predictor, trajs: np.ndarray, cycles: int, imgsz: int, init, device="cuda"):
    """``make_stream_batch_fused`` over ``trajs`` (S, F, 2) with the
    detector ``model`` (the folded stem where it folds) and ``predictor``,
    ``cycles`` logged cycles from ``init`` (S, 2)."""
    from wtracker_tpu_torch.sim.engine import run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    cfg = LiveLoopConfig(imgsz=(imgsz, imgsz), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0)
    ctl = make_stream_batch_fused(params, cfg, SyntheticScene(), trajs, model, predictor, device=device)
    return run_engine_streams(params, ctl, init, cycles, delayed_log=True, device=device)


def tracking_quality(params, logs, trajs: np.ndarray) -> dict:
    """Detection rate and median centre error of the logged worm boxes
    against the true track, and, after cycle 3, the share of frames with the
    worm inside the camera view and its median distance from the platform,
    on (C, S, L) logs."""
    pos = logs.positions.cpu().numpy().astype(np.float64)  # (C, S, L, 2)
    wrm = logs.worm_bboxes.cpu().numpy()
    n_cycles, S, L, _ = pos.shape
    fidx = (np.arange(n_cycles)[:, None] * L + np.arange(L)[None, :]).reshape(-1)
    gt = trajs[:, fidx, :].reshape(S, n_cycles, L, 2).transpose(1, 0, 2, 3)
    ok = np.isfinite(wrm).all(axis=-1)
    err = np.hypot(*(wrm[..., :2] + wrm[..., 2:] / 2 - gt).transpose(3, 0, 1, 2))[ok]
    dev = np.hypot(*(gt[3:] - pos[3:]).transpose(3, 0, 1, 2))
    return {
        "detection_rate": float(ok.mean()),
        "median_center_err_px": float(np.median(err)) if ok.any() else float("nan"),
        "in_camera_share_after_cycle_3": float((dev < params.cam_w / 2).mean()),
        "median_worm_deviation_px": float(np.median(dev)),
    }


def closed_loop_tracking(checkpoint: str, device="cuda", streams: int = 1, cycles: int = 6, imgsz: int = IMGSZ) -> dict:
    """The trained detector (BN-fused, bf16) and the seeded ResMLP in the
    live loop of the gate experiment, S=``streams``, ``cycles`` cycles:
    >= 95 % detected, median centre error <= 4 px, the worm in the camera in
    >= 95 % of frames after cycle 3, median deviation <= 60 px."""
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.sim.synthetic import make_trajectory

    params = deployment_params()
    model = YoloV8Detector.load(checkpoint, imgsz=imgsz, device=device).fuse().to(torch.bfloat16).model
    predictor = make_rmlp_predictor(IOConfig([0, -3, -6, -9, -12], [3]), device=device)
    trajs = np.stack([make_trajectory(400, ARENA, seed=30 + i) for i in range(streams)])
    with counted_launches() as launches:
        logs = closed_loop_logs(params, model, predictor, trajs, cycles, imgsz, np.tile([700, 700], (streams, 1)), device)
    numbers = {"streams": streams, "cycles": cycles, **tracking_quality(params, logs, trajs)}
    return verdict("closed_loop_tracking", numbers, launches, device)


# ---------------------------------------------------------------------------
# s/416 parity
# ---------------------------------------------------------------------------


def random_detector(scale: str = "s", seed: int = 7):
    """A float32 YOLOv8 on the CPU: Flax's init from ``seed`` with non-trivial
    BatchNorm statistics and affine terms drawn from numpy's ``seed``."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    model = YoloV8Detector.init_random(nc=1, scale=scale, seed=seed, device="cpu").model
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.2, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.5, c)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
    return model


def detector_logits(model, frames: torch.Tensor, imgsz: int = IMGSZ) -> tuple[list, list]:
    """Per-level NHWC (box, class) logits of letterboxed uint8 ``frames``."""
    from wtracker_tpu_torch.models.yolov8 import preprocess_batch

    x, _ = preprocess_batch(frames, (imgsz, imgsz), dtype=model.compute_dtype)
    with torch.inference_mode():
        box, cls = model(x)
    return [t.float().cpu() for t in box], [t.float().cpu() for t in cls]


def anchor_matched(ref: tuple, got: tuple, imgsz: int = IMGSZ, reg_max: int = 16, top: int = 100) -> dict:
    """The JAX package's anchor-matched comparison of two detectors' decoded
    outputs, ``(box_logits, cls_logits)`` NHWC per level (numpy or tensors):
    the best score of each image, and the IoU of the boxes at the ``top``
    highest-scoring anchors of the reference run (near-ties between
    unrelated anchors cannot flip it); also the largest logit difference."""
    from wtracker_tpu_torch.models.yolov8 import decode_predictions
    from wtracker_tpu_torch.ops.boxes import box_iou

    def tensors(out):
        return [[torch.as_tensor(np.asarray(t, np.float32)) for t in part] for part in out]

    ref, got = tensors(ref), tensors(got)
    logit_diff = max(float((a - b).abs().max()) for a, b in zip(ref[0] + ref[1], got[0] + got[1]))
    rb, rs = decode_predictions(ref[0], ref[1], (imgsz, imgsz), reg_max)
    gb, gs = decode_predictions(got[0], got[1], (imgsz, imgsz), reg_max)
    rtop, gtop = rs.amax(dim=-1), gs.amax(dim=-1)
    score_diff, min_iou = 0.0, float("inf")
    for b in range(rb.shape[0]):
        score_diff = max(score_diff, abs(float(gtop[b].max()) - float(rtop[b].max())))
        cand = torch.argsort(rtop[b])[-top:]
        min_iou = min(min_iou, float(box_iou(gb[b, cand], rb[b, cand]).min()))
    return {"max_top_score_diff": score_diff, "min_candidate_iou": min_iou, "max_abs_logit_diff": logit_diff}


def s416_parity(device="cuda", scale: str = "s", seed: int = 7, views: int = 2, cam: int = CAM, imgsz: int = IMGSZ) -> dict:
    """:func:`random_detector` on ``device`` against the same weights in
    float32 on the CPU, on ``views`` random uint8 camera views letterboxed
    to ``imgsz``: the best score within 2e-3 and every candidate IoU at
    least 0.99 (:func:`anchor_matched`)."""
    from wtracker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)  # float32 on the card: TF32 off
    model = random_detector(scale, seed).eval()
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 255, size=(views, cam, cam), dtype=np.uint8))
    ref = detector_logits(model, frames, imgsz)
    on_device = copy.deepcopy(model).to(dev)
    with counted_launches() as launches:
        got = detector_logits(on_device, frames.to(dev), imgsz)
    numbers = {"views": views, "device": str(dev), **anchor_matched(ref, got, imgsz, model.reg_max)}
    return verdict("s416_parity", numbers, launches, device)
