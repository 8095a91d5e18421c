"""Live YOLO+MLP closed loop over real video frames (chunked device residency).

Port of :mod:`wtracker_tpu.sim.engine_video`: :func:`video_live_controller`
and :func:`run_video_live` (whole frames, or ROI streaming with
``roi_window``), and the multi-recording :func:`video_stream_controller` with
:func:`run_video_live_sharded`.  Frames stream through the device in
fixed-size chunks:

* a chunk of decoded uint8 frames (with ROI streaming, of one window per
  frame) lives on the device as ``consts["frames"]``;
* each cycle crops its camera views out of the chunk and detects them, either
  through the hand-written crop+letterbox kernel
  (:func:`wtracker_tpu_torch.ops.preproc.crop_letterbox_views`, the
  counterpart of the JAX package's Pallas branch) or through the plain
  :func:`~wtracker_tpu_torch.ops.image.crop_views` →
  :func:`~wtracker_tpu_torch.models.yolov8.detect_top1` branch;
* a host thread reads the next chunk into the other of two host buffers
  while the device works on the current one, and the engine resumes from
  its carry chunk after chunk.

Platform positions are clamped so crops stay inside the frame.  The kernel
reads a crop at any offset, so a chunk is stored unpadded (the JAX package
pads it to the Pallas kernel's tile grid).  Chunks are uploaded from
pageable host memory: the copy has left the host buffer when ``.to(device)``
returns, so a buffer may be refilled as soon as its chunk is dispatched.
``run_video_live_sharded`` runs its streams on one device; a device mesh is
not ported.
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
    _scan,
    init_carry,
    init_stream_carry,
    make_batched_cycle_step,
    run_engine,
)
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, _LoopParts, _ring_set, _shift_boxes, _sub_batches
from wtracker_tpu_torch.utils.device import resolve_device

_SCRATCH: dict = {}


def _scratch_buffer(key: tuple, shape: tuple[int, ...]) -> np.ndarray:
    """Process-lifetime uint8 host buffer, keyed by (role, slot, *shape).

    First-touch page faults of a fresh allocation can cost more than the
    decode that fills it, so the loops reuse their streaming buffers across
    runs and pay that once per process.  The pool stays bounded: a buffer of
    the same role and slot but another shape is dropped."""
    buf = _SCRATCH.get(key)
    if buf is None:
        for k in [k for k in _SCRATCH if k[:2] == key[:2] and k != key]:
            del _SCRATCH[k]
        buf = np.empty(shape, np.uint8)
        buf[:] = 0  # fault the pages in now, outside any timed region
        _SCRATCH[key] = buf
    return buf


def _host_logs(parts: list[CycleLog]) -> CycleLog:
    """Chunk logs (on the device) concatenated along cycles, on the host."""
    return CycleLog(
        positions=torch.cat([p.positions for p in parts]).cpu(),
        worm_bboxes=torch.cat([p.worm_bboxes for p in parts]).cpu(),
    )


def _prefetcher(fetch: Callable):
    """``prefetch(*args) -> thread`` running ``fetch(*args)`` in a thread;
    ``take(thread)`` joins it and returns the result, re-raising its error."""
    pending: dict = {}

    def prefetch(*args) -> threading.Thread:
        def worker():
            try:
                pending["frames"] = fetch(*args)
            except BaseException as e:  # re-raised on join by the consumer
                pending["error"] = e

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        return t

    def take(thread: threading.Thread) -> np.ndarray:
        thread.join()
        if "error" in pending:
            raise pending.pop("error")
        return pending.pop("frames")

    return prefetch, take


def video_live_controller(
    params: EngineParams,
    config: LiveLoopConfig,
    detector_model: YoloV8,
    predictor,
    chunk_shape: tuple[int, int, int],
    detect_fn=None,
    detect_preprocessed_fn=None,
    roi_full_hw: tuple[int, int] | None = None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Single-stream live controller reading views from a resident frame chunk.

    ``consts`` carries ``{"frames": (C, H, W) uint8, "frame0": int}``, the
    resident chunk and the absolute index of its first frame; set them per
    chunk with ``controller._replace(consts=...)``.  The detector
    and predictor modules hold their weights and must already be on
    ``device``.

    ROI streaming (``roi_full_hw=(full_h, full_w)``): the chunk holds one
    window of the recording per frame, ``chunk_shape`` is the window chunk,
    and consts gain ``"win_tl"`` (C, 2) int32, each window's arena origin in
    (x, y) order.  Crops are clamped to the full frame, then placed relative
    to their frame's window; a crop that a mispredicted window cannot hold is
    clamped inside it, and the host (:func:`run_video_live`) sees that from
    the logged positions and replays the chunk with corrected windows.

    ``detect_fn(model, views, imgsz, conf)`` /
    ``detect_preprocessed_fn(model, x, geometry, imgsz, conf)`` swap the
    detector implementation.  When only ``detect_fn`` is given, the fused
    preprocessing branch is off (it needs the preprocessed-input form); so it
    is for a folded-stem detector (``config.fold_stem``), which takes the raw
    views.
    """
    parts = _LoopParts(params, config, None, detector_model, predictor, detect_fn, device)
    dev = parts.dev
    R = config.ring_size
    L = params.cycle_n
    IM, MV = params.imaging_n, params.moving_n
    view_hw = parts.view_hw
    _, H, W = chunk_shape
    # arena bounds of the crop clamp: the recording's frame (ROI streaming) or
    # the resident chunk's (whole frames)
    FH, FW = roi_full_hw if roi_full_hw is not None else (H, W)
    roi = roi_full_hw is not None
    win_max = torch.tensor([W - params.cam_w, H - params.cam_h], dtype=torch.int32, device=dev)

    _detect = parts.detect
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

    # empty placeholders: the caller swaps in each (≤ C, H, W) chunk
    consts = {"frames": torch.empty((0, H, W), dtype=torch.uint8, device=dev), "frame0": 0}
    if roi:
        consts["win_tl"] = torch.empty((0, 2), dtype=torch.int32, device=dev)

    def crop_and_detect(consts, frame_idx, cam_tls):
        """frame_idx (N,) absolute; cam_tls (N, 2) arena coords → (N, 4) abs."""
        frames = consts["frames"]
        local = (frame_idx - consts["frame0"]).clamp(0, frames.shape[0] - 1)
        # clamp crops fully inside the frame
        tls = torch.stack(
            [cam_tls[:, 0].clamp(0, FW - params.cam_w), cam_tls[:, 1].clamp(0, FH - params.cam_h)], dim=1
        ).to(torch.int32)
        if roi:
            # window-relative origin; the in-window clamp keeps the crop legal
            # on a mispredicted window (the host replays such chunks)
            crop_tls = torch.minimum((tls - consts["win_tl"][local]).clamp_min(0), win_max)
        else:
            crop_tls = tls
        if use_fused:
            x = crop_letterbox_views(
                frames, local.to(torch.int32), crop_tls, params.cam_w, config.imgsz[0],
                out_dtype=detector_model.compute_dtype,
            )
            boxes = _detect_pre(detector_model, x, (scale, pad_top, pad_left), config.imgsz, config.conf)
        else:
            views = crop_views(frames, crop_tls, view_hw, frame_idx=local)
            boxes = _detect(detector_model, views, config.imgsz, config.conf)
        return _shift_boxes(boxes, tls)

    def init():
        return {
            "ring": torch.full((R, 4), torch.nan, dtype=torch.float32, device=dev),
            "stash": torch.full((IM, 4), torch.nan, dtype=torch.float32, device=dev),
        }

    def decide(consts, state, ctx: DecideCtx):
        idx = ctx.cycle * L + parts.arange_im
        cam_tl = ctx.position - parts.cam_half
        boxes_abs = crop_and_detect(consts, idx, cam_tl.expand(IM, 2))
        ring = state["ring"].index_put((idx % R,), boxes_abs)  # a new ring: the carry is never mutated
        dxdy = parts.move(ring[None], ctx.cycle * L + IM - params.pred_n, cam_tl[None])[0]
        return {"ring": ring, "stash": boxes_abs}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)
        if not config.log_mode:
            moving = torch.full((MV, 4), torch.nan, dtype=torch.float64, device=dev)
        else:
            idx = cycle_idx * L + IM + parts.arange_mv
            moving = crop_and_detect(consts, idx, positions[IM:] - parts.cam_half).to(torch.float64)
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
    window_source: Callable | None = None,
    roi_window: int | tuple[int, int] | None = None,
    roi_chunk_cycles: int = 8,
    roi_speed_cap: float = 25.0,
    roi_stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> CycleLog:
    """Run the live loop over a whole recording, chunk by chunk.

    Args:
        frame_source: ``(start_frame, count) -> (count, H, W) uint8``; a
            source with a third ``out`` parameter decodes straight into the
            loop's buffer (``FrameReader.read_batch`` does).
        num_frames: total frames of the experiment.
        detector_model / predictor: on ``device`` already (the JAX package's
            ``detector_variables`` argument lives inside the module here).
        cycles_per_chunk: chunk size in cycles (device memory per chunk =
            ``cycles_per_chunk · cycle_n · H · W`` bytes).
        roi_window: ROI streaming: read and upload one ``roi_window``-sized
            window per frame (int or ``(win_h, win_w)``) instead of the whole
            frame.  Window origins are speculated ahead of the loop from the
            platform's trajectory; a chunk whose window missed a crop is found
            from the logged positions and replayed with corrected windows, so
            the result is identical to the whole-frame loop's.  Requires
            ``window_source``.
        window_source: ``(start_frame, count, top_lefts (N, 2) xy, out=None)
            -> (count, win_h, win_w) uint8``, e.g. a closure over
            :meth:`FrameReader.read_window_batch`; it must fill ``out``.
        roi_chunk_cycles: ROI chunk size in cycles (short chunks keep the
            speculation's lookahead, two chunks, short).
        roi_speed_cap: speculation velocity cap, px/cycle per axis.
        roi_stats: optional dict that receives the ROI counters ``chunks``,
            ``replays`` and ``max_chunk_replays``.

    Returns the stacked logs over all complete cycles, on the host.
    """
    dev = resolve_device(device)
    if roi_window is not None:
        if window_source is None:
            raise ValueError("roi_window requires window_source")
        win_hw = (roi_window, roi_window) if isinstance(roi_window, int) else tuple(roi_window)
        return _run_video_live_roi(
            params, config, frame_source, window_source, num_frames, detector_model, predictor,
            init_position, win_hw, roi_chunk_cycles, roi_speed_cap, detect_fn, detect_preprocessed_fn,
            roi_stats, dev,
        )
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
    if accepts_out:
        bufs = [_scratch_buffer(("video-raw", i, chunk_frames, H, W), (chunk_frames, H, W)) for i in range(2)]

    def fetch(start: int, count: int, slot: int) -> np.ndarray:
        if accepts_out:
            return np.ascontiguousarray(frame_source(start, count, bufs[slot][:count]))
        return np.ascontiguousarray(frame_source(start, count))

    prefetch, take = _prefetcher(fetch)
    thread = prefetch(0, min(chunk_frames, num_frames), 0)
    logs_parts = []
    for i, start_cycle in enumerate(range(0, n_cycles, cycles_per_chunk)):
        n = min(cycles_per_chunk, n_cycles - start_cycle)
        frames = take(thread)

        # start reading the next chunk before this one's upload and loop
        nxt = (start_cycle + cycles_per_chunk) * L
        if nxt < n_cycles * L:
            thread = prefetch(nxt, min(chunk_frames, num_frames - nxt), (i + 1) % 2)

        ctl = controller._replace(consts={"frames": torch.from_numpy(frames).to(dev), "frame0": start_cycle * L})
        logs, carry = run_engine(
            params, ctl, init_position, n, start_cycle=start_cycle, carry=carry, return_carry=True, device=dev
        )
        logs_parts.append(logs)
        del ctl

    return _host_logs(logs_parts)


def _run_video_live_roi(
    params: EngineParams,
    config: LiveLoopConfig,
    frame_source: Callable,
    window_source: Callable,
    num_frames: int,
    detector_model: YoloV8,
    predictor,
    init_position: tuple[int, int],
    win_hw: tuple[int, int],
    chunk_cycles: int,
    speed_cap: float,
    detect_fn,
    detect_preprocessed_fn,
    roi_stats: dict | None,
    dev: torch.device,
) -> CycleLog:
    """ROI streaming: speculated per-frame windows + exact replay recovery.

    The tracker only ever crops a camera-sized view, so reading and uploading
    whole frames wastes ``full_area / window_area`` of every byte.  Windows
    for a chunk are speculated by constant-velocity extrapolation of the
    platform trajectory *one chunk ahead* (so the read still overlaps the
    device's work); after each chunk's loop the logged positions prove
    whether every crop was inside its window.  A miss replays the chunk from
    its entry carry with corrected windows (cycles with verified positions
    get exactly-centred windows, later cycles a fresh speculation), so the
    output is identical to the whole-frame loop's however bad the
    speculation was.  A replay may restart from the entry carry because the
    engine never updates a carry in place.
    """
    L = params.cycle_n
    IM = params.imaging_n
    n_cycles = params.n_logged_cycles(num_frames)
    F = chunk_cycles * L
    win_h, win_w = win_hw

    probe = frame_source(0, 1)
    H, W = probe.shape[1:3]
    if not (params.cam_h <= win_h <= H and params.cam_w <= win_w <= W):
        raise ValueError(f"roi_window {win_hw} must cover the camera view and fit the frame")

    controller = video_live_controller(
        params, config, detector_model, predictor, (F, win_h, win_w), detect_fn=detect_fn,
        detect_preprocessed_fn=detect_preprocessed_fn, roi_full_hw=(H, W), device=dev,
    )

    cam_half = np.array([params.cam_w // 2, params.cam_h // 2], dtype=np.int64)
    cam_max = np.array([W - params.cam_w, H - params.cam_h], dtype=np.int64)
    win_half = np.array([win_w // 2, win_h // 2], dtype=np.int64)
    win_max = np.array([W - win_w, H - win_h], dtype=np.int64)
    slack = np.array([win_w - params.cam_w, win_h - params.cam_h], dtype=np.int64)

    # verified per-frame platform positions (filled as chunks pass their check)
    known = np.zeros((n_cycles, L, 2), dtype=np.int64)

    def _vel(hist, anchor_cycle: int) -> np.ndarray:
        """px/cycle from up to 4 verified cycles back; capped (a velocity read
        across an arena bounce would otherwise fling the speculation)."""
        k = min(4, anchor_cycle)
        if k <= 0:
            return np.zeros(2)
        v = (hist(anchor_cycle) - hist(anchor_cycle - k)) / k
        return np.clip(v, -speed_cap, speed_cap)

    def _center(pos: np.ndarray) -> np.ndarray:
        """Window origins centred on positions, clipped into the frame."""
        return np.clip(np.round(pos).astype(np.int64) - win_half, 0, win_max)

    def speculate(first_cycle: int, n: int, anchor_cycle: int, hist) -> np.ndarray:
        """(n·L, 2) int32 window origins for cycles [first_cycle, first_cycle+n)."""
        if anchor_cycle < 0:
            pred = np.tile(np.asarray(init_position, dtype=np.float64), (n, 1))
        else:
            p = hist(anchor_cycle).astype(np.float64)
            v = _vel(hist, anchor_cycle)
            cs = np.arange(first_cycle, first_cycle + n, dtype=np.float64)
            pred = p + v * (cs - anchor_cycle)[:, None]
        return np.repeat(_center(pred), L, axis=0).astype(np.int32)

    def check(pos: np.ndarray, wtl: np.ndarray) -> tuple[int, int] | None:
        """First (cycle, row) whose crop fell outside its window, else None.

        Mirrors the device's crop origin math exactly: arena top-left =
        clip(position − cam_half, 0, frame − cam)."""
        ctl = np.clip(pos.reshape(-1, 2).astype(np.int64) - cam_half, 0, cam_max)
        d = ctl - wtl[: ctl.shape[0]].astype(np.int64)
        bad = ((d < 0) | (d > slack)).any(axis=1)
        if not bad.any():
            return None
        flat = int(np.argmax(bad))
        return flat // L, flat % L

    known_hist = lambda c: known[c, 0]

    # host slots: ping/pong prefetch + a replay target (a replay can run
    # while the next chunk's prefetch owns the other slot)
    raw_bufs = [_scratch_buffer(("video-roi-raw", i, F, win_h, win_w), (F, win_h, win_w)) for i in range(3)]

    def _fetch(start: int, count: int, wtl: np.ndarray, slot: int) -> np.ndarray:
        buf = raw_bufs[slot][:count]
        window_source(start, count, wtl[:count], out=buf)
        return buf

    prefetch, take = _prefetcher(_fetch)

    def _dispatch(c0: int, n: int, wtl: np.ndarray, frames: np.ndarray, carry0):
        ctl = controller._replace(
            consts={
                "frames": torch.from_numpy(frames).to(dev),
                "frame0": c0 * L,
                "win_tl": torch.from_numpy(np.ascontiguousarray(wtl, dtype=np.int32)).to(dev),
            }
        )
        return run_engine(params, ctl, init_position, n, start_cycle=c0, carry=carry0, return_carry=True, device=dev)

    stats = {"chunks": 0, "replays": 0, "max_chunk_replays": 0}

    def _verify(ch: dict) -> bool:
        """Wait for the chunk's loop, replay until every crop was in-window.

        Progress per replay is guaranteed: positions are verified through the
        failing crop (an imaging-row miss taints only *later* rows — the move
        that produced the failing row's position was decided on earlier,
        in-window crops), verified cycles get exactly-centred windows, and a
        centred window always contains its crop.  So the first-miss index
        strictly increases and the loop terminates; in practice each replay
        verifies a whole prefix, so even adversarial trajectories (a fast
        worm and minimal window slack) settle in a couple of replays per
        chunk (``max_chunk_replays``).
        """
        c0, n = ch["c0"], ch["n"]
        chunk_replays = 0
        replayed = False
        for _ in range(n * L + 1):
            pos = ch["logs"].positions.cpu().numpy()  # (n, L, 2): waits for the chunk's loop
            miss = check(pos, ch["wtl"])
            if miss is None:
                break
            replayed = True
            stats["replays"] += 1
            chunk_replays += 1
            j, row = miss
            # positions are true through cycle j's imaging rows always, and
            # through ALL of cycle j when the miss was only in a moving-phase
            # (log) crop — those never feed the controller state
            j_true = j + 1 if row >= IM else j
            new = np.empty((n * L, 2), np.int32)
            new[: j_true * L] = _center(pos[:j_true].reshape(-1, 2))
            if j_true < n:
                hist = lambda c: known[c, 0] if c < c0 else pos[c - c0, 0]
                anchor = c0 + j_true - 1 if j_true > 0 else c0 - 1
                if row < IM:
                    # cycle j's imaging position is true: anchor there
                    anchor = c0 + j
                new[j_true * L :] = speculate(c0 + j_true, n - j_true, anchor, hist)
            frames = _fetch(c0 * L, n * L, new, 2)
            logs, carry1 = _dispatch(c0, n, new, frames, ch["carry0"])
            ch.update(wtl=new, logs=logs, carry1=carry1)
        else:  # pragma: no cover — unreachable, see the progress argument above
            raise RuntimeError("ROI window recovery did not converge")
        stats["max_chunk_replays"] = max(stats["max_chunk_replays"], chunk_replays)
        known[c0 : c0 + n] = pos
        return replayed

    chunks = [(c0, min(chunk_cycles, n_cycles - c0)) for c0 in range(0, n_cycles, chunk_cycles)]
    carry = init_carry(params, controller, init_position, dev)
    out_logs: list = [None] * len(chunks)
    prev: dict | None = None

    wtl_i = speculate(0, chunks[0][1], -1, known_hist)
    thread = prefetch(0, chunks[0][1] * L, wtl_i, 0)

    for i, (c0, n) in enumerate(chunks):
        stats["chunks"] += 1
        frames_i = take(thread)

        if prev is not None:
            # chunk i-1 was dispatched last round: its check waits on the
            # device only now, after chunk i's frames have been read
            replayed = _verify(prev)
            carry = prev["carry1"]
            out_logs[prev["i"]] = prev["logs"]
            if replayed:
                # this chunk's prefetched windows grew from a stale anchor:
                # refetch synchronously from the now-verified trajectory
                wtl_i = speculate(c0, n, c0 - 1, known_hist)
                frames_i = _fetch(c0 * L, n * L, wtl_i, 2)

        if i + 1 < len(chunks):
            c0n, nn = chunks[i + 1]
            wtl_next = speculate(c0n, nn, c0 - 1, known_hist)
            thread = prefetch(c0n * L, nn * L, wtl_next, (i + 1) % 2)

        logs, carry1 = _dispatch(c0, n, wtl_i, frames_i, carry)
        prev = {"i": i, "c0": c0, "n": n, "wtl": wtl_i, "logs": logs, "carry0": carry, "carry1": carry1}
        carry = carry1
        if i + 1 < len(chunks):
            wtl_i = wtl_next

    _verify(prev)
    out_logs[prev["i"]] = prev["logs"]
    if roi_stats is not None:
        roi_stats.update(stats)
    return _host_logs(out_logs)


def video_stream_controller(
    params: EngineParams,
    config: LiveLoopConfig,
    detector_model: YoloV8,
    predictor,
    chunk_shape: tuple[int, int, int, int],
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Stream-batched live controller over S resident recording chunks.

    ``consts["frames"]`` is (S, C, H, W), one chunk per recording, and
    ``decide``/``predict_all`` own the stream axis (for
    :func:`~wtracker_tpu_torch.sim.engine.make_batched_cycle_step`), so each
    cycle's crops of all streams form one flat (S·n, cam_h, cam_w) detector
    batch, split into ``config.detect_chunks`` sequential sub-batches.  The
    folded stem applies as in the single-stream loop; the crop+letterbox
    kernel and ROI streaming do not (as in the JAX package).
    """
    parts = _LoopParts(params, config, None, detector_model, predictor, detect_fn, device)
    dev = parts.dev
    R = config.ring_size
    L = params.cycle_n
    IM, MV = params.imaging_n, params.moving_n
    S, _, H, W = chunk_shape
    stream_base = torch.arange(S, dtype=torch.int64, device=dev)[:, None]

    def detect(views):
        return parts.detect(detector_model, views, config.imgsz, config.conf)

    consts = {"frames": torch.empty((S, 0, H, W), dtype=torch.uint8, device=dev), "frame0": 0}

    def crop_and_detect(consts, frame_idx, cam_tls):
        """frame_idx (N,) absolute (shared across streams); cam_tls (S·N, 2)
        arena coords → (S·N, 4) absolute boxes."""
        frames = consts["frames"]
        c = frames.shape[1]
        local = (frame_idx - consts["frame0"]).clamp(0, c - 1)
        # view s·N + i is frame local[i] of stream s in the flat (S·C, H, W) chunk
        fidx = (stream_base * c + local[None, :]).reshape(-1)
        tls = torch.stack(
            [cam_tls[:, 0].clamp(0, W - params.cam_w), cam_tls[:, 1].clamp(0, H - params.cam_h)], dim=1
        ).to(torch.int32)
        views = crop_views(frames.reshape(S * c, H, W), tls, parts.view_hw, frame_idx=fidx)
        return _shift_boxes(_sub_batches(detect, config.detect_chunks, views), tls)

    def init():
        return {
            "ring": torch.full((S, R, 4), torch.nan, dtype=torch.float32, device=dev),
            "stash": torch.full((S, IM, 4), torch.nan, dtype=torch.float32, device=dev),
        }

    def decide(consts, state, ctx: DecideCtx):
        idx = ctx.cycle * L + parts.arange_im  # (IM,)
        cam_tl = ctx.position - parts.cam_half  # (S, 2)
        boxes = crop_and_detect(consts, idx, cam_tl.repeat_interleave(IM, dim=0)).reshape(S, IM, 4)
        ring = _ring_set(state["ring"], idx % R, boxes)
        dxdy = parts.move(ring, ctx.cycle * L + IM - params.pred_n, cam_tl)
        return {"ring": ring, "stash": boxes}, dxdy

    def predict_all(consts, state, cycle_idx, positions):
        imaging = state["stash"].to(torch.float64)
        if not config.log_mode:
            moving = torch.full((S, MV, 4), torch.nan, dtype=torch.float64, device=dev)
        else:
            idx = cycle_idx * L + IM + parts.arange_mv
            cam_tls = (positions[:, IM:, :] - parts.cam_half).reshape(S * MV, 2)
            moving = crop_and_detect(consts, idx, cam_tls).reshape(S, MV, 4).to(torch.float64)
        return torch.cat([imaging, moving], dim=1)

    return CycleController(init=init, decide=decide, predict_all=predict_all, consts=consts)


def run_video_live_sharded(
    params: EngineParams,
    config: LiveLoopConfig,
    frame_sources: list,
    num_frames: int,
    detector_model: YoloV8,
    predictor,
    init_positions,
    cycles_per_chunk: int = 64,
    mesh=None,
    detect_fn=None,
    device: str | torch.device = "cuda",
) -> CycleLog:
    """Track S recordings at once, their crops batched into one detector
    batch a phase.

    Args:
        frame_sources: S callables ``(start_frame, count) -> (count, H, W)
            uint8``, one per recording (all of one geometry and length).
        init_positions: (S, 2) initial platform centres.
        mesh: must be ``None``: the streams run on ``device``.  Sharding them
            over a device mesh is not ported yet.

    The host walks chunks as :func:`run_video_live` does (prefetch the next
    chunk of all S streams while the device works on the current one, resume
    from the returned carry), with an (S, C, H, W) resident chunk.  Logs come
    back on the host with leading axes ``(n_cycles, S, cycle_n)``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_video_live_sharded over a device mesh is not ported yet (ROADMAP Queue 1 item 8: "
            "parallel/mesh.py); pass mesh=None to run the streams on one device"
        )
    dev = resolve_device(device)
    S = len(frame_sources)
    if np.asarray(init_positions).shape != (S, 2):
        raise ValueError(f"init_positions must be ({S}, 2)")
    L = params.cycle_n
    n_cycles = params.n_logged_cycles(num_frames)
    chunk_frames = cycles_per_chunk * L

    probe = frame_sources[0](0, 1)
    H, W = probe.shape[1:3]
    controller = video_stream_controller(
        params, config, detector_model, predictor, (S, chunk_frames, H, W), detect_fn=detect_fn, device=dev
    )
    bufs = [_scratch_buffer(("video-sharded", i, S, chunk_frames, H, W), (S, chunk_frames, H, W)) for i in range(2)]

    def fetch(start: int, count: int, slot: int) -> np.ndarray:
        buf = bufs[slot]
        for s, src in enumerate(frame_sources):
            buf[s, :count] = src(start, count)
        if count < chunk_frames:
            buf[:, count:] = 0
        return buf

    prefetch, take = _prefetcher(fetch)
    thread = prefetch(0, min(chunk_frames, num_frames), 0)

    init_pos = np.asarray(init_positions, dtype=np.int32)
    carry = None
    logs_parts = []
    for i, start_cycle in enumerate(range(0, n_cycles, cycles_per_chunk)):
        n = min(cycles_per_chunk, n_cycles - start_cycle)
        frames = take(thread)

        nxt = (start_cycle + cycles_per_chunk) * L
        if nxt < n_cycles * L:
            thread = prefetch(nxt, min(chunk_frames, num_frames - nxt), (i + 1) % 2)

        ctl = controller._replace(consts={"frames": torch.from_numpy(frames).to(dev), "frame0": start_cycle * L})
        logs, carry = _sharded_fallback_run(params, ctl, init_pos, n, start_cycle, carry, dev)
        logs_parts.append(logs)
        del ctl

    return _host_logs(logs_parts)


def _sharded_fallback_run(params, ctl, init_pos, n, start_cycle, carry, device):
    """Cycles ``[start_cycle, start_cycle + n)`` of the batched video
    controller on one device, from ``carry`` (a fresh one at ``init_pos``
    when ``None``): the logs and the final carry.  The single-device form of
    :func:`run_video_live_sharded`."""
    if carry is None:
        carry = init_stream_carry(params, ctl, init_pos, device)
    carry, logs = _scan(make_batched_cycle_step(params, ctl), ctl.consts, carry, range(start_cycle, start_cycle + n))
    return logs, carry
