"""Mixed-geometry experiment sweeps: one engine run over streams whose arenas
differ.

Port of :mod:`wtracker_tpu.sim.engine_hetero`.  The reference's five
experiments (``configs/exp0``–``exp4``) share one timing regime but differ in
resolution (1380–1600 px), camera pixel size (px_per_mm 88–92, so 352–368
px cameras), init position and frame count.  The reference runs them one at
a time; here they run as one stream batch:

* every stream clamps the platform to its *own* arena bounds
  (``consts["stream_bounds"]``, honoured by the engine's stream motor);
* the playback and decision math uses per-stream camera sizes;
* shorter experiments are NaN-padded to the longest one and trimmed per
  stream when the logs are split.

Timing must quantize to one cycle shape across the streams (the same frame
counts per phase and motor weights); :func:`bucket_by_cycle_shape` splits a
sweep into such groups.  Each experiment's log equals its own single-stream
run byte for byte.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wtracker_tpu_torch.ops.image import letterbox_indexed, make_letterbox_matrices
from wtracker_tpu_torch.models.yolov8 import top1_source_boxes
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine import (
    CycleController,
    CycleLog,
    DecideCtx,
    EngineParams,
    _csv_predict_all,
    _FrameOffsets,
    _table,
    headless_frame_shape,
    logs_to_frame,
)
from wtracker_tpu_torch.sim.engine_live import (
    _batched_move_from_history,
    _check_models_on,
    _ring_set,
    _shift_boxes,
    _sub_batches,
)
from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.profiling import span


class StreamGeometry(NamedTuple):
    """Per-stream arena/view geometry of a mixed sweep (host arrays)."""

    cam_size: np.ndarray  # (S, 2) int32 (w, h)
    mic_size: np.ndarray  # (S, 2) int32 (w, h)
    bounds: np.ndarray  # (S, 2) int32 (w, h) platform clamp bounds
    num_frames: np.ndarray  # (S,) int — per-stream experiment length


def bucket_by_cycle_shape(timings: list[TimingConfig]) -> list[list[int]]:
    """Group experiment indices by quantized cycle shape (imaging, pred,
    moving frames): one engine run needs one schedule.  Buckets come back in
    first-seen order, each keeping input order."""
    buckets: dict[tuple, list[int]] = {}
    for i, t in enumerate(timings):
        key = (t.imaging_frame_num, t.pred_frame_num, t.moving_frame_num)
        buckets.setdefault(key, []).append(i)
    return list(buckets.values())


def geometry_from_configs(
    timings: list[TimingConfig], experiments: list[ExperimentConfig]
) -> tuple[EngineParams, StreamGeometry]:
    """Common EngineParams + per-stream geometry for a mixed sweep.

    Raises ``ValueError`` if the timings do not quantize to one cycle shape
    (then the sweep must be split into timing groups).
    """
    assert len(timings) == len(experiments) > 0
    p0 = EngineParams.from_timing(timings[0], headless_frame_shape(timings[0], experiments[0].orig_resolution))

    cams, mics, bounds, lengths = [], [], [], []
    for t, e in zip(timings, experiments):
        schedule = (t.imaging_frame_num, t.pred_frame_num, t.moving_frame_num)
        if schedule != (p0.imaging_n, p0.pred_n, p0.moving_n):
            raise ValueError(
                f"experiment {e.name!r} quantizes to cycle shape {schedule}, "
                f"others to {(p0.imaging_n, p0.pred_n, p0.moving_n)} — split the sweep by timing"
            )
        h, w = headless_frame_shape(t, e.orig_resolution)
        cams.append(t.camera_size_px)
        mics.append(t.micro_size_px)
        bounds.append((w, h))
        lengths.append(e.num_frames)

    geometry = StreamGeometry(
        cam_size=np.asarray(cams, dtype=np.int32),
        mic_size=np.asarray(mics, dtype=np.int32),
        bounds=np.asarray(bounds, dtype=np.int32),
        num_frames=np.asarray(lengths, dtype=np.int64),
    )
    # the common params keep the first stream's view sizes (unused by the
    # hetero controllers) and the largest bounds
    params = EngineParams(
        imaging_n=p0.imaging_n,
        pred_n=p0.pred_n,
        moving_n=p0.moving_n,
        cam_w=p0.cam_w,
        cam_h=p0.cam_h,
        mic_w=p0.mic_w,
        mic_h=p0.mic_h,
        frame_w=int(geometry.bounds[:, 0].max()),
        frame_h=int(geometry.bounds[:, 1].max()),
        motor_weights=p0.motor_weights,
    )
    return params, geometry


def slice_geometry(geometry: StreamGeometry, lo: int, hi: int) -> StreamGeometry:
    """Streams ``[lo, hi)`` of a sweep's geometry (a mesh slot's share)."""
    return StreamGeometry(*(a[lo:hi] for a in geometry))


def pad_worm_tables(tables: list[np.ndarray]) -> np.ndarray:
    """Stack per-experiment (Nᵢ, 4) worm tables into (S, max N, 4), NaN-padded
    — out-of-range rows behave exactly like out-of-range frame queries."""
    n = max(len(t) for t in tables)
    out = np.full((len(tables), n, 4), np.nan)
    for i, t in enumerate(tables):
        out[i, : len(t)] = np.asarray(t, dtype=float)
    return out


def _decision_positions(params: EngineParams, ctx: DecideCtx) -> torch.Tensor:
    """Per-stream platform position behind the decision query's camera bbox
    — the deque-ring quirk of CsvController.predict (the engine's
    ``_decision_cam_topleft``) over a stream batch."""
    g_offset = 2 * params.imaging_n - params.pred_n + 1 - params.cycle_n
    if g_offset >= 0 or ctx.cycle == 0:
        return ctx.position
    return ctx.prev_positions[:, params.cycle_n + g_offset]


def _stream_consts(geometry: StreamGeometry, dev: torch.device) -> dict:
    """Per-stream (S, 2) int32 half camera sizes and int32 clamp bounds."""
    return {
        "cam_half": torch.tensor(geometry.cam_size // 2, dtype=torch.int32, device=dev),
        "stream_bounds": torch.tensor(geometry.bounds, dtype=torch.int32, device=dev),
    }


def _view_geometry(geom_id, cam_wh, n: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Geometry ids (S, n) and int32 (w, h) content extents (S, n, 2) of S
    streams × n views, stream-major (a mesh slot slices the leading axis)."""
    ids = torch.tensor(np.repeat(np.asarray(geom_id)[:, None], n, axis=1), device=dev)
    return ids, torch.tensor(np.repeat(np.asarray(cam_wh)[:, None], n, axis=1), dtype=torch.int32, device=dev)


def _flat_views(views: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-view geometry of :func:`_view_geometry`, one row a view."""
    ids, wh = views
    return ids.reshape(-1), wh.reshape(-1, 2)


def csv_controller_hetero(
    csv_data: np.ndarray, params: EngineParams, geometry: StreamGeometry, device: str | torch.device = "cuda"
) -> CycleController:
    """Stream-batched ground-truth playback over heterogeneous arenas.

    ``csv_data`` is (S, N, 4) (see :func:`pad_worm_tables`); per-stream
    camera sizes drive the decision and logging coordinate math, and the
    engine's stream motor clamps to ``geometry.bounds``.  For
    ``run_engine_streams(..., batched_controller=True)``.
    """
    dev = resolve_device(device)
    consts = {
        "csv": _table(csv_data, dev),
        "cam_mid": _table(geometry.cam_size, dev) / 2,  # (S, 2)
        **_stream_consts(geometry, dev),
    }
    query = _FrameOffsets([0], dev)

    def decide(consts, state, ctx: DecideCtx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bbox = query.rows(consts["csv"], f - params.pred_n, dim=1)[:, 0]  # (S, 4)
        cam_tl = (_decision_positions(params, ctx) - consts["cam_half"]).to(torch.float64)
        rel_xy = bbox[:, :2] - cam_tl
        center = rel_xy + bbox[:, 2:] / 2
        target = center - consts["cam_mid"]
        valid = torch.isfinite(bbox).all(dim=1)
        return state, torch.where(valid[:, None], torch.round(target), 0.0).to(torch.int32)

    predict_all = _csv_predict_all(params, lambda c: c["cam_half"][:, None, :], dev, dim=1)
    return CycleController(init=lambda: (), decide=decide, predict_all=predict_all, consts=consts)


def yolo_mlp_controller_hetero(
    params: EngineParams,
    geometry: StreamGeometry,
    config,
    scene,
    gt_trajs: np.ndarray,
    detector_model,
    predictor,
    canvas_hw: tuple[int, int] | None = None,
    forward_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Live YOLO+MLP tracking across streams with heterogeneous cameras, as
    one stream batch (for ``run_engine_streams(..., batched_controller=True)``):

    * every view renders into a shared canvas of the largest camera size,
      with the worm window clamped to the stream's own camera extent (the
      content equals a native-size render,
      :meth:`~wtracker_tpu_torch.sim.synthetic.SyntheticScene.render_views`
      ``content_whs``);
    * each view letterboxes by its own geometry's matrices
      (:func:`~wtracker_tpu_torch.ops.image.letterbox_indexed`), so the
      detector sees one (B, imgsz, imgsz, 3) batch and runs its standard
      forward (no folded stem, no crop+letterbox kernel);
    * the decision and logging math uses per-stream camera sizes, and the
      platform clamps to per-stream arena bounds;
    * every per-stream tensor is in ``consts`` or the state, so
      ``run_engine_sharded(..., batched_controller=True)`` runs the
      controller on a mesh whose slots share its device, each slot on its
      slice of the streams.

    Args:
        config: a :class:`~wtracker_tpu_torch.sim.engine_live.LiveLoopConfig`
            (``detect_chunks`` splits each phase's views into sequential
            sub-batches).
        gt_trajs: (S, F, 2) per-stream ground-truth trajectories.
        canvas_hw: render canvas override (default: the largest camera).
        forward_fn: ``x -> (box_logits, cls_logits)`` in place of the
            detector's forward on the letterboxed batch (decode and
            per-geometry un-letterboxing stay shared).
        device: where the loop runs; the modules must already be there.
    """
    dev = resolve_device(device)
    _check_models_on(dev, detector_model, predictor)
    S = gt_trajs.shape[0]
    R, L, IM, MV = config.ring_size, params.cycle_n, params.imaging_n, params.moving_n
    mlp_model = predictor.model
    forward = forward_fn or detector_model

    cam_wh = np.asarray(geometry.cam_size)  # (S, 2) as (w, h)
    if canvas_hw is None:
        canvas_hw = (int(cam_wh[:, 1].max()), int(cam_wh[:, 0].max()))

    # unique camera geometries -> letterbox operators + per-stream ids
    unique_hw: list[tuple[int, int]] = []
    geom_id = np.zeros(S, dtype=np.int64)
    for i, (w, h) in enumerate(map(tuple, cam_wh)):
        hw = (int(h), int(w))
        if hw not in unique_hw:
            unique_hw.append(hw)
        geom_id[i] = unique_hw.index(hw)
    mat_y, mat_x, cov_y, cov_x, geoms = make_letterbox_matrices(
        unique_hw, canvas_hw, config.imgsz, dtype=detector_model.compute_dtype, device=dev
    )
    scales = torch.tensor([g[0] for g in geoms], dtype=torch.float32, device=dev)
    pads = torch.tensor([[g[2], g[1]] for g in geoms], dtype=torch.float32, device=dev)  # (G, 2) as (left, top)

    # every per-stream tensor is in consts (or the state), so that a mesh
    # slot running this controller on its share of the streams slices them
    consts = {
        "cam_mid": torch.tensor(cam_wh, dtype=torch.float32, device=dev) / 2,  # (S, 2)
        # geometry ids and (w, h) content extents of each stream's views,
        # shaped (S, n) and (S, n, 2) for the IM imaging and MV moving views
        "views_im": _view_geometry(geom_id, cam_wh, IM, dev),
        "views_mv": _view_geometry(geom_id, cam_wh, MV, dev),
        **_stream_consts(geometry, dev),
    }
    gt0 = torch.tensor(np.asarray(gt_trajs), dtype=torch.float32, device=dev)
    input_frames = torch.tensor(predictor.io_config.input_frames, dtype=torch.int64, device=dev)
    arange_im = torch.arange(IM, device=dev)
    arange_mv = torch.arange(MV, device=dev)

    def render_detect(worm_xy, cam_tls, fidx, gids, content_whs):
        with span("wt.detect"):
            views = scene.render_views(worm_xy, cam_tls.to(torch.float32), canvas_hw, fidx, content_whs=content_whs)
            x = letterbox_indexed(views, gids, mat_y, mat_x, cov_y, cov_x, dtype=detector_model.compute_dtype)
            box_logits, cls_logits = forward(x)
            pad = pads[gids]
            out = top1_source_boxes(
                box_logits, cls_logits, config.imgsz, detector_model.reg_max, (scales[gids], pad[:, 1], pad[:, 0]),
                config.conf,
            )
            return _shift_boxes(out, cam_tls)

    def detect_flat(idx, cam_tls, gt, views):
        n_streams, n = gt.shape[0], idx.shape[0]
        worm_xy = gt[:, idx.clamp(0, gt.shape[1] - 1), :].reshape(n_streams * n, 2)
        return _sub_batches(render_detect, config.detect_chunks, worm_xy, cam_tls, idx.repeat(n_streams), *views)

    def init():
        return {
            "ring": torch.full((S, R, 4), torch.nan, dtype=torch.float32, device=dev),
            "stash": torch.full((S, IM, 4), torch.nan, dtype=torch.float32, device=dev),
            "gt": gt0,
        }

    def decide(consts, state, ctx: DecideCtx):
        idx = ctx.cycle * L + arange_im
        cam_tl = ctx.position - consts["cam_half"]  # (S, 2)
        boxes = detect_flat(idx, cam_tl.repeat_interleave(IM, dim=0), state["gt"], _flat_views(consts["views_im"]))
        boxes = boxes.reshape(-1, IM, 4)
        with span("wt.predict"):
            ring = _ring_set(state["ring"], idx % R, boxes)
            kickoff = ctx.cycle * L + IM - params.pred_n
            f_in = kickoff + input_frames
            feats_abs = torch.where((f_in >= 0)[None, :, None], ring[:, f_in % R, :], torch.nan)
            cam_center = cam_tl.to(torch.float32) + consts["cam_mid"]
            dxdy = _batched_move_from_history(
                mlp_model, feats_abs, ring[:, kickoff % R, :], cam_center, config.max_dist_per_pred
            )
        return {"ring": ring, "stash": boxes, "gt": state["gt"]}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)
        n_streams = imaging.shape[0]
        if not config.log_mode:
            moving = torch.full((n_streams, MV, 4), torch.nan, dtype=torch.float64, device=dev)
        else:
            idx = cycle_idx * L + IM + arange_mv
            cam_tls = (positions[:, IM:, :] - consts["cam_half"][:, None, :]).reshape(n_streams * MV, 2)
            moving = detect_flat(idx, cam_tls, state["gt"], _flat_views(consts["views_mv"]))
            moving = moving.reshape(n_streams, MV, 4).to(torch.float64)
        return torch.cat([imaging, moving], dim=1)

    return CycleController(init=init, decide=decide, predict_all=predict_all, consts=consts)


def run_sweep_hetero(
    params: EngineParams,
    geometry: StreamGeometry,
    controller,
    init_positions: np.ndarray,
    mesh=None,
    device: str | torch.device = "cuda",
):
    """Run the mixed sweep and split the logs back per experiment.

    Returns a list of per-experiment DataFrames (17-column bboxes.csv
    schema), each trimmed to its own experiment length.  ``mesh=None`` runs
    the streams on ``device`` (a mesh of that one slot); a stream mesh
    (:func:`~wtracker_tpu_torch.parallel.mesh.run_engine_sharded`) shards
    them, each slot clamping its streams to their own ``stream_bounds``.
    ``controller`` is a factory ``(device, lo, hi) -> CycleController``
    over streams ``[lo, hi)`` (e.g. a closure over
    :func:`csv_controller_hetero` with :func:`slice_geometry`), or a
    :func:`csv_controller_hetero` on a mesh whose slots share its device
    (it keeps its per-stream data in ``consts``, which each slot slices).
    """
    from wtracker_tpu_torch.parallel.mesh import make_mesh, run_engine_sharded

    n_cycles = params.n_logged_cycles(int(geometry.num_frames.max()))
    mesh = make_mesh(devices=[device]) if mesh is None else mesh
    logs = run_engine_sharded(params, controller, init_positions, n_cycles, mesh, batched_controller=True)

    frames = []
    for i in range(len(geometry.num_frames)):
        per = CycleLog(positions=logs.positions[:, i], worm_bboxes=logs.worm_bboxes[:, i])
        df = logs_to_frame(params, per, cam_size=tuple(geometry.cam_size[i]), mic_size=tuple(geometry.mic_size[i]))
        own_cycles = params.n_logged_cycles(int(geometry.num_frames[i]))
        frames.append(df.iloc[: own_cycles * params.cycle_n].reset_index(drop=True))
    return frames
