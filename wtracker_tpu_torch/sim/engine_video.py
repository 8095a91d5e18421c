"""Live YOLO+MLP closed loop over real video frames (chunked device residency).

Port of :func:`wtracker_tpu.sim.engine_video.video_live_controller` (full-frame
mode) and :func:`~wtracker_tpu.sim.engine_video.run_video_live`.  Frames
stream through the device in fixed-size chunks:

* a chunk of decoded uint8 frames lives on the device as ``consts["frames"]``;
* each cycle crops its camera views out of the chunk and detects them, either
  through the hand-written crop+letterbox kernel
  (:func:`wtracker_tpu_torch.ops.preproc.crop_letterbox_views`, the
  counterpart of the JAX package's Pallas branch) or through the plain
  :func:`~wtracker_tpu_torch.ops.image.crop_views` →
  :func:`~wtracker_tpu_torch.models.yolov8.detect_top1` branch;
* a host thread reads the next chunk into the other of two buffers while the
  device works on the current one, and the engine resumes from its carry
  chunk after chunk.

Platform positions are clamped so crops stay inside the frame.  The kernel
reads a crop at any offset, so the chunk is stored unpadded (the JAX package
pads it to the Pallas kernel's tile grid).  ROI streaming
(``_run_video_live_roi``) and the multi-stream ``video_stream_controller``
are not ported yet.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable

import numpy as np
import torch

from wtracker_tpu_torch.models.yolov8 import YoloV8, detect_top1_preprocessed, letterbox_params
from wtracker_tpu_torch.ops.image import crop_views
from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
from wtracker_tpu_torch.sim.engine import (
    CycleController,
    CycleLog,
    DecideCtx,
    EngineParams,
    init_carry,
    run_engine,
)
from wtracker_tpu_torch.sim.engine_live import (
    LiveLoopConfig,
    _batched_move_from_history,
    _check_models_on,
    _resolve_detect,
)
from wtracker_tpu_torch.utils.device import resolve_device


def video_live_controller(
    params: EngineParams,
    config: LiveLoopConfig,
    detector_model: YoloV8,
    predictor,
    chunk_shape: tuple[int, int, int],
    detect_fn=None,
    detect_preprocessed_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Single-stream live controller reading views from a resident frame chunk.

    ``consts`` carries ``{"frames": (C, H, W) uint8, "frame0": int}``, the
    resident chunk and the absolute index of its first frame; set them per
    chunk with ``controller._replace(consts=...)``.  The detector
    and predictor modules hold their weights and must already be on
    ``device``.

    ``detect_fn(model, views, imgsz, conf)`` /
    ``detect_preprocessed_fn(model, x, geometry, imgsz, conf)`` swap the
    detector implementation.  When only ``detect_fn`` is given, the fused
    preprocessing branch is off (it needs the preprocessed-input form); so it
    is for a folded-stem detector (``config.fold_stem``), which takes the raw
    views.
    """
    dev = resolve_device(device)
    _check_models_on(dev, detector_model, predictor)

    R = config.ring_size
    L = params.cycle_n
    IM, MV = params.imaging_n, params.moving_n
    input_frames = torch.tensor(predictor.io_config.input_frames, dtype=torch.int64, device=dev)
    mlp_model = predictor.model

    cam_half = torch.tensor([params.cam_w // 2, params.cam_h // 2], dtype=torch.int32, device=dev)
    cam_mid = torch.tensor([params.cam_w / 2, params.cam_h / 2], dtype=torch.float32, device=dev)
    arange_im = torch.arange(IM, dtype=torch.int64, device=dev)
    arange_mv = torch.arange(MV, dtype=torch.int64, device=dev)
    view_hw = (params.cam_h, params.cam_w)
    _, H, W = chunk_shape

    _detect = _resolve_detect(detect_fn, config, detector_model, view_hw)
    square = params.cam_w == params.cam_h and config.imgsz[0] == config.imgsz[1]
    if config.use_fused_preproc is None:  # auto: the kernel runs on the card
        use_fused = square and dev.type == "cuda"
    else:
        use_fused = config.use_fused_preproc and square
    if getattr(_detect, "folds_preproc", False):
        # a folded-stem detector letterboxes inside its stem matmuls: the
        # kernel branch would route around the fold
        use_fused = False
    elif detect_fn is not None and detect_preprocessed_fn is None:
        use_fused = False  # custom detector without a preprocessed-input form
    _detect_pre = detect_preprocessed_fn or detect_top1_preprocessed
    scale, _, _, pad_top, pad_left = letterbox_params(view_hw, config.imgsz)

    # an empty placeholder: the caller swaps in each (≤ C, H, W) chunk
    consts = {"frames": torch.empty((0, H, W), dtype=torch.uint8, device=dev), "frame0": 0}

    def crop_and_detect(consts, frame_idx, cam_tls):
        """frame_idx (N,) absolute; cam_tls (N, 2) arena coords → (N, 4) abs."""
        frames = consts["frames"]
        local = (frame_idx - consts["frame0"]).clamp(0, frames.shape[0] - 1)
        # clamp crops fully inside the frame
        tls = torch.stack(
            [cam_tls[:, 0].clamp(0, W - params.cam_w), cam_tls[:, 1].clamp(0, H - params.cam_h)], dim=1
        ).to(torch.int32)
        if use_fused:
            x = crop_letterbox_views(
                frames, local.to(torch.int32), tls, params.cam_w, config.imgsz[0],
                out_dtype=detector_model.compute_dtype,
            )
            boxes = _detect_pre(detector_model, x, (scale, pad_top, pad_left), config.imgsz, config.conf)
        else:
            views = crop_views(frames, tls, view_hw, frame_idx=local)
            boxes = _detect(detector_model, views, config.imgsz, config.conf)
        return torch.cat([boxes[:, :2] + tls.to(boxes.dtype), boxes[:, 2:]], dim=1)

    def init():
        return {
            "ring": torch.full((R, 4), torch.nan, dtype=torch.float32, device=dev),
            "stash": torch.full((IM, 4), torch.nan, dtype=torch.float32, device=dev),
        }

    def decide(consts, state, ctx: DecideCtx):
        idx = ctx.cycle * L + arange_im
        cam_tl = ctx.position - cam_half
        boxes_abs = crop_and_detect(consts, idx, cam_tl.expand(IM, 2))
        ring = state["ring"].index_put((idx % R,), boxes_abs)  # a new ring: the carry is never mutated

        kickoff = ctx.cycle * L + IM - params.pred_n
        f_in = kickoff + input_frames
        feats_abs = torch.where((f_in >= 0)[:, None], ring[f_in % R], torch.nan)  # (k, 4)
        cam_center = cam_tl.to(torch.float32) + cam_mid
        dxdy = _batched_move_from_history(
            mlp_model, feats_abs[None], ring[kickoff % R][None], cam_center[None], config.max_dist_per_pred
        )[0]
        return {"ring": ring, "stash": boxes_abs}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)
        if not config.log_mode:
            moving = torch.full((MV, 4), torch.nan, dtype=torch.float64, device=dev)
        else:
            idx = cycle_idx * L + IM + arange_mv
            moving = crop_and_detect(consts, idx, positions[IM:] - cam_half).to(torch.float64)
        return torch.cat([imaging, moving], dim=0)

    return CycleController(init=init, decide=decide, predict_all=predict_all, consts=consts)


def run_video_live(
    params: EngineParams,
    config: LiveLoopConfig,
    frame_source: Callable[..., np.ndarray],
    num_frames: int,
    detector_model: YoloV8,
    predictor,
    init_position: tuple[int, int],
    cycles_per_chunk: int = 64,
    detect_fn=None,
    detect_preprocessed_fn=None,
    roi_window: int | tuple[int, int] | None = None,
    device: str | torch.device = "cuda",
) -> CycleLog:
    """Run the live loop over a whole recording, chunk by chunk.

    Args:
        frame_source: ``(start_frame, count) -> (count, H, W) uint8``; a
            source with a third ``out`` parameter decodes straight into the
            loop's buffer.
        num_frames: total frames of the experiment.
        detector_model / predictor: on ``device`` already (the JAX package's
            ``detector_variables`` argument lives inside the module here).
        cycles_per_chunk: chunk size in cycles (device memory per chunk =
            ``cycles_per_chunk · cycle_n · H · W`` bytes).
        roi_window: ROI streaming is not ported yet; anything but ``None``
            raises.

    Returns the stacked logs over all complete cycles, on the host: the logs
    leave the device once per chunk.
    """
    if roi_window is not None:
        raise NotImplementedError("ROI streaming (roi_window) is not ported yet")
    dev = resolve_device(device)
    L = params.cycle_n
    n_cycles = params.n_logged_cycles(num_frames)
    chunk_frames = cycles_per_chunk * L

    probe = frame_source(0, 1)
    H, W = probe.shape[1:3]
    controller = video_live_controller(
        params, config, detector_model, predictor, (chunk_frames, H, W),
        detect_fn=detect_fn, detect_preprocessed_fn=detect_preprocessed_fn, device=dev,
    )
    carry = init_carry(params, controller, init_position, dev)

    try:
        accepts_out = len(inspect.signature(frame_source).parameters) >= 3
    except (TypeError, ValueError):
        accepts_out = False
    # ping-pong host buffers: the thread fills one while the loop uploads the other
    bufs = [np.empty((chunk_frames, H, W), np.uint8) for _ in range(2)] if accepts_out else None

    pending: dict = {}

    def _prefetch(start: int, count: int, slot: int) -> threading.Thread:
        def worker():
            try:
                if accepts_out:
                    frames = frame_source(start, count, bufs[slot][:count])
                else:
                    frames = frame_source(start, count)
                pending["frames"] = np.ascontiguousarray(frames)
            except BaseException as e:  # re-raised on join by the consumer
                pending["error"] = e

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        return t

    thread = _prefetch(0, min(chunk_frames, num_frames), 0)
    positions, bboxes = [], []
    for i, start_cycle in enumerate(range(0, n_cycles, cycles_per_chunk)):
        n = min(cycles_per_chunk, n_cycles - start_cycle)
        thread.join()
        if "error" in pending:
            raise pending.pop("error")
        frames = pending.pop("frames")

        # start reading the next chunk before this one's upload and loop
        nxt = (start_cycle + cycles_per_chunk) * L
        if nxt < n_cycles * L:
            thread = _prefetch(nxt, min(chunk_frames, num_frames - nxt), (i + 1) % 2)

        # the upload copies out of the host buffer before it returns (pageable
        # memory), so the thread may refill this buffer two chunks later
        chunk = torch.from_numpy(frames).to(dev)
        ctl = controller._replace(consts={"frames": chunk, "frame0": start_cycle * L})
        logs, carry = run_engine(
            params, ctl, init_position, n, start_cycle=start_cycle, carry=carry, return_carry=True, device=dev
        )
        positions.append(logs.positions.cpu())
        bboxes.append(logs.worm_bboxes.cpu())
        del chunk, ctl

    return CycleLog(positions=torch.cat(positions), worm_bboxes=torch.cat(bboxes))
