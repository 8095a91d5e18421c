"""Live-detection loop settings and the shared movement decision.

Port of the parts of :mod:`wtracker_tpu.sim.engine_live` that the real-video
loop (:mod:`wtracker_tpu_torch.sim.engine_video`) runs: :class:`LiveLoopConfig`,
the detect-function choice and :func:`_batched_move_from_history` (the
reference MLPController math with the CsvController fallback).  The
synthetic-renderer loop of that module (``make_decision_step``,
``hybrid_yolo_mlp_controller``, ``make_stream_batch*``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wtracker_tpu_torch.models.yolov8 import detect_top1


def _resolve_detect(detect_fn, config: "LiveLoopConfig"):
    """Pick the cycle's detect function: explicit hook > standard path.

    The JAX package's third choice, the folded stem (the stem conv computed
    inside the letterbox matmuls), is its default for BN-fused weights; it is
    not ported yet (ROADMAP.md, Queue 1), so auto resolves to the standard
    letterbox → conv path and ``fold_stem=True`` raises.
    """
    if detect_fn is not None:
        return detect_fn
    if config.fold_stem:
        raise NotImplementedError(
            "fold_stem=True: the folded-stem detector is not ported yet; "
            "use fold_stem=None or False for the standard letterbox -> conv path"
        )
    return detect_top1


@dataclass(frozen=True)
class LiveLoopConfig:
    """Static settings of the live YOLO+MLP loop."""

    imgsz: tuple[int, int] = (416, 416)
    conf: float = 0.1
    ring_size: int = 64
    """Detection-history depth (must exceed the oldest MLP input offset plus
    one cycle)."""
    log_mode: bool = True
    """Also detect moving-phase frames so every log row has a worm bbox."""
    max_dist_per_pred: float = 40.0
    """Clip bound on the MLP displacement prediction, in px."""
    use_fused_preproc: bool | None = None
    """Video path only: crop + resize + normalize in one hand-written CUDA
    kernel (:func:`wtracker_tpu_torch.ops.preproc.crop_letterbox_views`);
    the counterpart of the JAX package's ``use_pallas_preproc``.  ``None``
    (default) = auto: on for a CUDA device with a square camera and imgsz;
    ``True``/``False`` force it (``True`` still requires square shapes)."""
    fold_stem: bool | None = None
    """Folded-stem detector (not ported yet): ``None`` and ``False`` run the
    standard letterbox → conv path, ``True`` raises."""


def _batched_move_from_history(mlp_model, feats_abs, last_det, cam_center, max_dist):
    """Shared (S,·) movement decision: MLP on relative bbox history, falling
    back to centering the freshest detection, else staying put.

    ``feats_abs`` is the (S, k, 4) float32 absolute bbox history at the
    predictor's ``input_frames`` offsets (newest first); ``last_det`` the
    (S, 4) kickoff-frame detection; ``cam_center`` the (S, 2) float32 camera
    center.  Returns the (S, 2) int32 move.  Everything stays on the device:
    the NaN checks select with ``torch.where`` instead of branching.
    """
    S = feats_abs.shape[0]
    mlp_valid = torch.isfinite(feats_abs).all(dim=2).all(dim=1)

    rel = feats_abs[:, 0, :2] - cam_center
    origin = feats_abs[:, 0:1, :2]
    feats = torch.cat([feats_abs[:, :, :2] - origin, feats_abs[:, :, 2:]], dim=2).reshape(S, -1)
    feats = torch.where(mlp_valid[:, None], feats, 0.0)

    pred = mlp_model(feats.to(torch.float32))
    pred = pred.clamp(-max_dist, max_dist)
    mlp_move = torch.round(pred[:, :2] + rel)

    det_valid = torch.isfinite(last_det).all(dim=1)
    det_center = last_det[:, :2] + last_det[:, 2:] / 2
    det_move = torch.round(det_center - cam_center)

    move = torch.where(mlp_valid[:, None], mlp_move, torch.where(det_valid[:, None], det_move, 0.0))
    return move.to(torch.int32)
