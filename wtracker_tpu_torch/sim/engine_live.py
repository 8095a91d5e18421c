"""Live-detection closed loop: YOLO → ResMLP inside the cycle engine.

Port of :mod:`wtracker_tpu.sim.engine_live`, the JAX package's flagship
path, scaled out to many streams.  Each cycle step simulates one cycle of
the platform:

1. render the imaging-phase camera views (:class:`SyntheticScene`, on the
   device; the real-video loop crops them instead,
   :mod:`wtracker_tpu_torch.sim.engine_video`);
2. detect the worm head in every view with the YOLOv8 detector, batched
   across streams × frames;
3. append the detections (absolute coordinates) to a per-stream ring;
4. predict the worm's displacement with the ResMLP from the ring history at
   the predictor's ``input_frames`` offsets (the reference MLPController
   math), falling back to centring the freshest detection (CsvController
   math) while the history is incomplete;
5. spread the move over the moving phase with the sine motor;
6. (log mode) detect the moving-phase views too, so every log row carries a
   worm bbox.

The detector and predictor modules hold their weights, so the JAX package's
``detector_variables`` arguments, its weights in ``consts`` and its runner
``cache_key`` have no counterpart here.  State tensors are never updated in
place: each cycle makes new ones.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from wtracker_tpu_torch.models.yolov8 import YoloV8, can_fold_stem, detect_top1, make_folded_detect
from wtracker_tpu_torch.sim.engine import CycleController, DecideCtx, EngineParams
from wtracker_tpu_torch.sim.synthetic import SyntheticScene
from wtracker_tpu_torch.utils.device import resolve_device


def _resolve_detect(detect_fn, config: "LiveLoopConfig", detector_model: YoloV8, view_hw: tuple[int, int]):
    """Pick the cycle's detect function: explicit hook > folded stem > standard.

    The folded stem applies to a BN-fused detector at a camera → imgsz
    letterbox without padding; ``fold_stem=None`` takes it wherever it
    applies, ``True`` raises where it does not, ``False`` never takes it.
    """
    if detect_fn is not None:
        return detect_fn
    if config.fold_stem is False:
        return detect_top1
    folded = None
    if can_fold_stem(detector_model):
        folded = make_folded_detect(detector_model, view_hw, config.imgsz)
    if folded is None:
        if config.fold_stem:
            raise ValueError(
                "fold_stem=True needs BN-fused detector variables and a "
                f"padding-free letterbox, got camera {view_hw} -> imgsz {config.imgsz}"
            )
        return detect_top1
    return folded


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
    ``True``/``False`` force it (``True`` still requires square shapes).
    A folded-stem detector turns it off: it takes raw views."""
    detect_chunks: int = 1
    """Split each cycle's flat render+detect batch into this many sequential
    sub-batches (when it divides the batch).  Per-view math is independent,
    so the boxes do not change; the activations of one sub-batch are what
    has to fit in device memory.  1 = one batch."""
    fold_stem: bool | None = None
    """Compute the detector's stem conv as part of the letterbox matmuls
    (:func:`wtracker_tpu_torch.models.yolov8.make_folded_detect`).  ``None``
    (default) = auto: on whenever the detector is BN-fused and the
    camera → imgsz letterbox has no padding; ``True`` raises if that does
    not hold; ``False`` forces the standard letterbox → conv path."""


def _model_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's first parameter, or of its first buffer (the
    int8 detector, :class:`~wtracker_tpu_torch.models.yolov8_int8.Int8Detector`,
    holds its weights as buffers)."""
    return next(itertools.chain(module.parameters(), module.buffers())).device


def _check_models_on(dev: torch.device, detector_model: YoloV8, predictor) -> None:
    """The modules hold the weights, so they must already be on ``dev``."""
    for name, module in (("detector", detector_model), ("predictor", predictor.model)):
        if _model_device(module) != dev:
            raise ValueError(f"{name} is on {_model_device(module)}, expected {dev}")


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


def _shift_boxes(boxes: torch.Tensor, tls: torch.Tensor) -> torch.Tensor:
    """View-coordinate xywh boxes → arena coordinates (a new tensor)."""
    return torch.cat([boxes[:, :2] + tls.to(boxes.dtype), boxes[:, 2:]], dim=1)


def make_decision_step(
    config: LiveLoopConfig,
    detector_model: YoloV8,
    predictor,
    view_hw: tuple[int, int],
    detect_fn=None,
):
    """The deployment decision, standalone: detect the predictor's input
    frames, assemble relative features, run the MLP, emit the platform move.

    This is the work the real instrument must finish inside ``pred_time_ms``
    between the imaging-phase end and the movement start (the reference's
    MLPController runs YOLO over the ``input_frames`` offsets and the MLP at
    decision time).

    Returns ``decide(views, cam_tl) -> (S, 2) int32``: ``views`` is the
    (S, k, H, W) stack of camera frames at the ``input_frames`` offsets
    (newest first, uint8 or float), ``cam_tl`` the (S, 2) float camera
    top-left in arena coordinates, both on the detector's device.
    """
    dev = _model_device(detector_model)
    _check_models_on(dev, detector_model, predictor)
    _detect = _resolve_detect(detect_fn, config, detector_model, view_hw)
    k = len(predictor.io_config.input_frames)
    mlp_model = predictor.model
    H, W = view_hw
    cam_mid = torch.tensor([W / 2, H / 2], dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def decide(views: torch.Tensor, cam_tl: torch.Tensor) -> torch.Tensor:
        S = views.shape[0]
        boxes = _detect(detector_model, views.reshape(S * k, H, W), config.imgsz, config.conf)
        feats_abs = _shift_boxes(boxes, cam_tl.repeat_interleave(k, dim=0)).reshape(S, k, 4).to(torch.float32)
        cam_center = cam_tl.to(torch.float32) + cam_mid
        return _batched_move_from_history(
            mlp_model, feats_abs, feats_abs[:, 0, :], cam_center, config.max_dist_per_pred
        )

    return decide


class _LoopParts:
    """What every live controller builds from the same arguments: the
    detect choice, the constants on the device, the movement decision, and
    render → detect → arena coordinates in (optionally chunked) batches.
    The video controllers crop recorded frames and pass ``scene=None``."""

    def __init__(self, params, config, scene, detector_model, predictor, detect_fn, device):
        self.dev = dev = resolve_device(device)
        _check_models_on(dev, detector_model, predictor)
        self.view_hw = (params.cam_h, params.cam_w)
        self.detect = _resolve_detect(detect_fn, config, detector_model, self.view_hw)
        self.config, self.scene, self.detector_model = config, scene, detector_model
        self.mlp_model = predictor.model
        self.input_frames = torch.tensor(predictor.io_config.input_frames, dtype=torch.int64, device=dev)
        self.cam_half = torch.tensor([params.cam_w // 2, params.cam_h // 2], dtype=torch.int32, device=dev)
        self.cam_mid = torch.tensor([params.cam_w / 2, params.cam_h / 2], dtype=torch.float32, device=dev)
        self.arange_im = torch.arange(params.imaging_n, dtype=torch.int64, device=dev)
        self.arange_mv = torch.arange(params.moving_n, dtype=torch.int64, device=dev)

    def render_detect(self, worm_xy: torch.Tensor, cam_tls: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
        """(N, 2) worms, (N, 2) int32 camera top-lefts, (N,) frames → (N, 4)
        arena-coordinate boxes (NaN rows: no detection)."""
        views = self.scene.render_views(worm_xy, cam_tls.to(torch.float32), self.view_hw, fidx)
        boxes = self.detect(self.detector_model, views, self.config.imgsz, self.config.conf)
        return _shift_boxes(boxes, cam_tls)

    def detect_flat(self, worm_xy: torch.Tensor, cam_tls: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
        """:meth:`render_detect` in ``detect_chunks`` sequential sub-batches."""
        return _sub_batches(self.render_detect, self.config.detect_chunks, worm_xy, cam_tls, fidx)

    def stream_table(self, gt_trajs: np.ndarray) -> torch.Tensor:
        """The (S, F, 2) trajectories on the device, uploaded once at build
        time (never per run)."""
        return torch.tensor(np.asarray(gt_trajs), dtype=torch.float32, device=self.dev)

    def move(self, ring: torch.Tensor, kickoff: int, cam_tl: torch.Tensor) -> torch.Tensor:
        """(S, R, 4) rings → (S, 2) int32 moves at the cycle's kickoff frame."""
        R = ring.shape[1]
        f_in = kickoff + self.input_frames
        feats_abs = torch.where((f_in >= 0)[None, :, None], ring[:, f_in % R, :], torch.nan)
        cam_center = cam_tl.to(torch.float32) + self.cam_mid
        return _batched_move_from_history(
            self.mlp_model, feats_abs, ring[:, kickoff % R, :], cam_center, self.config.max_dist_per_pred
        )


def _sub_batches(fn, k: int, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` in ``k`` sequential sub-batches along the first axis, the
    outputs concatenated (one batch when ``k`` does not divide the count):
    what the JAX package's ``lax.map`` over ``detect_chunks`` gives."""
    n = xs[0].shape[0]
    if k <= 1 or n % k:
        return fn(*xs)
    m = n // k
    return torch.cat([fn(*(x[i : i + m] for x in xs)) for i in range(0, n, m)])


def _ring_set(ring: torch.Tensor, slots: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """A copy of the (S, R, 4) ``ring`` with ``boxes`` (S, n, 4) at ``slots``
    (n,): the carry is never updated in place."""
    ring = ring.clone()
    ring[:, slots] = boxes
    return ring


def hybrid_yolo_mlp_controller(
    params: EngineParams,
    config: LiveLoopConfig,
    scene: SyntheticScene,
    gt_traj: np.ndarray,
    detector_model: YoloV8,
    predictor,
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """The live controller for one stream.

    Args:
        gt_traj: (F, 2) ground-truth worm trajectory of the rendered scene;
            the state carries it, so :func:`make_stream_batch` stacks one
            per stream.
        predictor: a :class:`~wtracker_tpu_torch.models.resmlp.WormPredictor`;
            its ``input_frames`` offsets select ring entries as features.
        device: where the loop runs; the modules must already be there.
    """
    parts = _LoopParts(params, config, scene, detector_model, predictor, detect_fn, device)
    gt = parts.stream_table(gt_traj)

    def init():
        return {
            "ring": torch.full((config.ring_size, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "stash": torch.full((params.imaging_n, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "gt": gt,
        }

    return CycleController(init, *_single_stream_fns(params, config, parts))


def _single_stream_fns(params: EngineParams, config: LiveLoopConfig, parts: _LoopParts):
    """``decide`` and ``predict_all`` over one stream's state
    (``ring`` (R, 4), ``stash`` (imaging_n, 4), ``gt`` (F, 2))."""
    R, L, IM, MV = config.ring_size, params.cycle_n, params.imaging_n, params.moving_n

    def decide(consts, state, ctx: DecideCtx):
        idx = ctx.cycle * L + parts.arange_im
        cam_tl = ctx.position - parts.cam_half
        worm_xy = state["gt"][idx.clamp(0, state["gt"].shape[0] - 1)]
        boxes_abs = parts.render_detect(worm_xy, cam_tl.expand(IM, 2), idx)
        ring = _ring_set(state["ring"][None], idx % R, boxes_abs[None])
        kickoff = ctx.cycle * L + IM - params.pred_n
        dxdy = parts.move(ring, kickoff, cam_tl[None])[0]
        return {"ring": ring[0], "stash": boxes_abs, "gt": state["gt"]}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)
        if not config.log_mode:
            moving = torch.full((MV, 4), torch.nan, dtype=torch.float64, device=parts.dev)
        else:
            idx = cycle_idx * L + IM + parts.arange_mv
            worm_xy = state["gt"][idx.clamp(0, state["gt"].shape[0] - 1)]
            moving = parts.render_detect(worm_xy, positions[IM:] - parts.cam_half, idx).to(torch.float64)
        return torch.cat([imaging, moving], dim=0)

    return decide, predict_all


def make_stream_batch(
    params: EngineParams,
    config: LiveLoopConfig,
    scene: SyntheticScene,
    gt_trajs: np.ndarray,
    detector_model: YoloV8,
    predictor,
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """:func:`hybrid_yolo_mlp_controller` with per-stream state, for
    :func:`~wtracker_tpu_torch.sim.engine.run_engine_streams` (each stream
    steps over its slice of the state).

    Args:
        gt_trajs: (S, F, 2) per-stream ground-truth trajectories.
    """
    parts = _LoopParts(params, config, scene, detector_model, predictor, detect_fn, device)
    S = gt_trajs.shape[0]
    gt0 = parts.stream_table(gt_trajs)

    def init():
        return {
            "ring": torch.full((S, config.ring_size, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "stash": torch.full((S, params.imaging_n, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "gt": gt0,
        }

    return CycleController(init, *_single_stream_fns(params, config, parts))


def make_stream_batch_flat(
    params: EngineParams,
    config: LiveLoopConfig,
    scene: SyntheticScene,
    gt_trajs: np.ndarray,
    detector_model: YoloV8,
    predictor,
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Batched-controller variant: one flat S·frames detection batch per phase.

    For ``run_engine_streams(..., batched_controller=True)``: decide and
    predict_all own the stream axis, so the detector sees (S·imaging_n, h, w)
    batches.  Semantics identical to :func:`make_stream_batch`.
    """
    parts = _LoopParts(params, config, scene, detector_model, predictor, detect_fn, device)
    S = gt_trajs.shape[0]
    R, L, IM, MV = config.ring_size, params.cycle_n, params.imaging_n, params.moving_n
    gt0 = parts.stream_table(gt_trajs)

    def init():
        return {
            "ring": torch.full((S, R, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "stash": torch.full((S, IM, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "gt": gt0,
        }

    def decide(consts, state, ctx: DecideCtx):
        gt = state["gt"]
        idx = ctx.cycle * L + parts.arange_im  # (IM,)
        worm_xy = gt[:, idx.clamp(0, gt.shape[1] - 1), :].reshape(S * IM, 2)
        cam_tl = ctx.position - parts.cam_half  # (S, 2)
        boxes = parts.detect_flat(worm_xy, cam_tl.repeat_interleave(IM, dim=0), idx.repeat(S)).reshape(S, IM, 4)
        ring = _ring_set(state["ring"], idx % R, boxes)
        dxdy = parts.move(ring, ctx.cycle * L + IM - params.pred_n, cam_tl)
        return {"ring": ring, "stash": boxes, "gt": gt}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)  # (S, IM, 4)
        if not config.log_mode:
            moving = torch.full((S, MV, 4), torch.nan, dtype=torch.float64, device=parts.dev)
        else:
            gt = state["gt"]
            idx = cycle_idx * L + IM + parts.arange_mv
            worm_xy = gt[:, idx.clamp(0, gt.shape[1] - 1), :].reshape(S * MV, 2)
            cam_tls = (positions[:, IM:, :] - parts.cam_half).reshape(S * MV, 2)
            moving = parts.detect_flat(worm_xy, cam_tls, idx.repeat(S)).reshape(S, MV, 4).to(torch.float64)
        return torch.cat([imaging, moving], dim=1)

    return CycleController(init=init, decide=decide, predict_all=predict_all)


def make_stream_batch_fused(
    params: EngineParams,
    config: LiveLoopConfig,
    scene: SyntheticScene,
    gt_trajs: np.ndarray,
    detector_model: YoloV8,
    predictor,
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """One detector batch per cycle: moving(C−1) + imaging(C).

    For ``run_engine_streams(..., delayed_log=True)``.  Each cycle the
    detector sees one flat (S·cycle_n, h, w) batch — the previous cycle's
    moving-phase views (positions known from the carry) plus the current
    imaging phase.  Log rows come one cycle late; the detections are those of
    :func:`make_stream_batch_flat`.
    """
    parts = _LoopParts(params, config, scene, detector_model, predictor, detect_fn, device)
    S = gt_trajs.shape[0]
    R, L, IM, MV = config.ring_size, params.cycle_n, params.imaging_n, params.moving_n
    gt0 = parts.stream_table(gt_trajs)

    def init():
        return {
            "ring": torch.full((S, R, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "log_rows": torch.full((S, L, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "img_stash": torch.full((S, IM, 4), torch.nan, dtype=torch.float32, device=parts.dev),
            "gt": gt0,
        }

    def decide(consts, state, ctx: DecideCtx):
        gt = state["gt"]
        F = gt.shape[1]

        # frame indices: previous cycle's moving phase + current imaging phase
        mov_idx = (ctx.cycle - 1) * L + IM + parts.arange_mv  # (MV,), < 0 at cycle 0
        img_idx = ctx.cycle * L + parts.arange_im
        mov_tls = ctx.prev_positions[:, IM:, :] - parts.cam_half  # (S, MV, 2)
        img_tl = ctx.position - parts.cam_half  # (S, 2)

        idx_all = torch.cat([mov_idx.repeat(S), img_idx.repeat(S)])
        worm_all = torch.cat(
            [gt[:, mov_idx.clamp(0, F - 1), :].reshape(S * MV, 2), gt[:, img_idx.clamp(0, F - 1), :].reshape(S * IM, 2)]
        )
        tls_all = torch.cat([mov_tls.reshape(S * MV, 2), img_tl.repeat_interleave(IM, dim=0)])

        boxes = parts.detect_flat(worm_all, tls_all, idx_all)
        mov_boxes = boxes[: S * MV].reshape(S, MV, 4)
        img_boxes = boxes[S * MV :].reshape(S, IM, 4)

        # the just-completed cycle's log rows: its imaging stash + moving dets
        if config.log_mode:
            log_rows = torch.cat([state["img_stash"], mov_boxes], dim=1)
        else:
            log_rows = torch.cat([state["img_stash"], torch.full_like(mov_boxes, torch.nan)], dim=1)

        ring = _ring_set(state["ring"], img_idx % R, img_boxes)
        dxdy = parts.move(ring, ctx.cycle * L + IM - params.pred_n, img_tl)
        return {"ring": ring, "log_rows": log_rows, "img_stash": img_boxes, "gt": gt}, dxdy

    def predict_all(consts, state, cycle_idx, prev_positions):
        return state["log_rows"].to(torch.float64)

    return CycleController(init=init, decide=decide, predict_all=predict_all)
