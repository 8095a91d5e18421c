"""The port's ROI streaming against its whole-frame loop and the JAX package's.

Reference: ``wtracker_tpu.sim.engine_video.run_video_live(roi_window=...)``
(its plain crop → letterbox branch: no Pallas on the CPU, and the unfused
weights do not fold the stem) on the recording fixture of
``tests/test_torch_engine_video.py`` (300x360, square 1.2 mm camera of
108 px, YOLOv8 scale "n" at 64 px, float32), and the JAX package's
pathological zigzag recording.  The port runs both of its preprocessing
branches (the zigzag's rectangular camera leaves only the plain one); on the
CPU its kernel wrapper takes the plain version.  Against
the port's whole-frame loop the ROI loop must be bit-identical, replays
included; against the JAX ROI loop positions must match exactly, boxes to
1e-3 px, and the window statistics (chunks, replays, worst chunk) exactly,
since all speculation is host numpy on equal positions.
"""

import numpy as np
import pytest
import torch

from tests.synthetic import TIMING_KWARGS
from tests.test_torch_engine_video import F, H, INIT, LOOP_KW, W, _timing, models, video  # noqa: F401 (fixtures)
from wtracker_tpu.sim import engine as jax_engine
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.engine_video import run_video_live as jax_run_video_live
from wtracker_tpu_torch.sim import engine
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
from wtracker_tpu_torch.sim.engine_video import run_video_live

torch.set_num_threads(2)

CAM = 108  # round(90 px/mm * 1.2 mm)
# (roi_window, roi_chunk_cycles): an ample window, and one with 3 and 4 px of
# slack that the platform's moves escape
WINDOWS = {"ample": (168, 4), "tight": ((CAM + 3, CAM + 4), 4)}
BRANCHES = {"kernel-wrapper": True, "crop-letterbox": False}
# the zigzag's window: 4 px of slack around its (99, 108) camera
ZIGZAG_ROI = dict(roi_window=(99 + 4, 108 + 4), roi_chunk_cycles=4)


def _window_source(frames):
    """In-memory window_source with FrameReader.read_window_batch's contract."""

    def source(start, count, top_lefts, out=None):
        assert out is not None  # both loops stream into their own buffers
        win_h, win_w = out.shape[1:3]
        for i, (x, y) in enumerate(np.asarray(top_lefts, dtype=int)):
            out[i] = frames[start + i, y : y + win_h, x : x + win_w]
        return out

    return source


def _port_run(frames, models, params, init, use_fused_preproc, max_dist=20.0, **kw):
    _, (tmodel, tpred) = models
    cfg = LiveLoopConfig(**{**LOOP_KW, "max_dist_per_pred": max_dist}, use_fused_preproc=use_fused_preproc)
    logs = run_video_live(
        params, cfg, lambda s, n: frames[s : s + n], len(frames), tmodel, tpred, init,
        window_source=_window_source(frames), device="cpu", **kw,
    )
    return logs.positions.numpy(), logs.worm_bboxes.numpy()


def _jax_run(frames, models, params, init, max_dist=20.0, **kw):
    (jmodel, jvars, jpred), _ = models
    cfg = JaxLiveLoopConfig(**{**LOOP_KW, "max_dist_per_pred": max_dist}, use_pallas_preproc=False)
    logs = jax_run_video_live(
        params, cfg, lambda s, n: frames[s : s + n], len(frames), jmodel, jvars, jpred, init,
        window_source=_window_source(frames), **kw,
    )
    return np.asarray(logs.positions), np.asarray(logs.worm_bboxes)


@pytest.fixture(scope="module")
def params():
    return engine.EngineParams.from_timing(_timing(ExperimentConfig, TimingConfig), (H, W))


@pytest.fixture(scope="module")
def port_full(video, models, params):
    """The port's whole-frame loop on each branch."""
    return {b: _port_run(video, models, params, INIT, fused, cycles_per_chunk=16) for b, fused in BRANCHES.items()}


@pytest.fixture(scope="module")
def jax_roi(video, models):
    """The JAX package's ROI loop at each window, with its statistics."""
    params = jax_engine.EngineParams.from_timing(_timing(JaxExperimentConfig, JaxTimingConfig), (H, W))
    out = {}
    for name, (window, chunk_cycles) in WINDOWS.items():
        stats = {}
        logs = _jax_run(video, models, params, INIT, roi_window=window, roi_chunk_cycles=chunk_cycles, roi_stats=stats)
        out[name] = (*logs, stats)
    return out


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("branch", BRANCHES)
def test_roi_matches_whole_frames_and_jax(video, models, params, port_full, jax_roi, branch, window):
    roi_window, chunk_cycles = WINDOWS[window]
    stats = {}
    pos, boxes = _port_run(
        video, models, params, INIT, BRANCHES[branch], roi_window=roi_window, roi_chunk_cycles=chunk_cycles,
        roi_stats=stats,
    )
    assert pos.shape == (32, 8, 2) and np.isfinite(boxes).all()  # conf=0 -> always a box
    np.testing.assert_array_equal(pos, port_full[branch][0])
    np.testing.assert_array_equal(boxes, port_full[branch][1])

    want_pos, want_boxes, want_stats = jax_roi[window]
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_allclose(boxes, want_boxes, atol=1e-3)
    assert stats == want_stats
    assert stats["chunks"] == 32 // chunk_cycles
    if window == "tight":
        assert stats["replays"] > 0  # the tight window must actually have missed


def _zigzag():
    """tests/test_engine_video.py's adversarial recording: a worm sprinting
    in zigzags at ~6 px/frame, direction flipping every 24 frames."""
    h, w, f = 300, 360, 256
    pos = np.empty((f, 2))
    pos[0] = (80, 80)
    d = np.array([6.0, 4.5])
    for i in range(1, f):
        if i % 24 == 0:
            d = -d if i % 48 == 0 else np.array([-d[0], d[1]])
        pos[i] = pos[i - 1] + d
        for a, lim in ((0, w), (1, h)):
            if not (40 <= pos[i, a] <= lim - 40):
                d[a] = -d[a]
                pos[i, a] = pos[i - 1, a] + d[a]
    rng = np.random.default_rng(5)
    frames = np.repeat(rng.integers(20, 40, (h, w), dtype=np.uint8)[None], f, axis=0)
    for i in range(f):
        x, y = int(pos[i, 0]), int(pos[i, 1])
        frames[i, max(y - 4, 0) : y + 4, max(x - 6, 0) : x + 6] = 220
    return frames


def _zigzag_params(mod_engine, mod_exp, mod_timing, frames):
    """The JAX test's geometry: a (108, 99) camera, so only the plain branch."""
    exp = mod_exp("vid", len(frames), 60, frames.shape[1:], 90, (80, 80))
    timing = mod_timing(experiment_config=exp, **TIMING_KWARGS)
    return mod_engine.EngineParams.from_timing(timing, frames.shape[1:])


@pytest.fixture(scope="module")
def zigzag(models):
    frames = _zigzag()
    params = _zigzag_params(jax_engine, JaxExperimentConfig, JaxTimingConfig, frames)
    stats = {}
    logs = _jax_run(frames, models, params, (80, 80), max_dist=60.0, roi_stats=stats, **ZIGZAG_ROI)
    return frames, (*logs, stats)


def test_roi_zigzag_replays_are_bounded_and_match_jax(models, zigzag):
    """Constant-velocity speculation misses at every direction change; the
    run still equals the whole-frame loop exactly, with a bounded number of
    replays per chunk, and the JAX package's replays one for one."""
    frames, (want_pos, want_boxes, want_stats) = zigzag
    params = _zigzag_params(engine, ExperimentConfig, TimingConfig, frames)
    full = _port_run(frames, models, params, (80, 80), None, max_dist=60.0, cycles_per_chunk=16)
    stats = {}
    pos, boxes = _port_run(frames, models, params, (80, 80), None, max_dist=60.0, roi_stats=stats, **ZIGZAG_ROI)
    np.testing.assert_array_equal(pos, full[0])
    np.testing.assert_array_equal(boxes, full[1])
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_allclose(boxes, want_boxes, atol=1e-3)
    assert stats == want_stats
    assert stats["replays"] > 0, "the adversarial setup must actually force misses"
    # each replay verifies at least one more cycle: <= 2 per chunk cycle
    assert stats["max_chunk_replays"] <= 2 * ZIGZAG_ROI["roi_chunk_cycles"], stats
    assert stats["replays"] <= 2 * stats["chunks"], stats


def test_roi_refuses_bad_arguments(video, models, params):
    _, (tmodel, tpred) = models
    cfg = LiveLoopConfig(**LOOP_KW)
    source = lambda s, n: video[s : s + n]
    with pytest.raises(ValueError, match="window_source"):
        run_video_live(params, cfg, source, F, tmodel, tpred, INIT, roi_window=168, device="cpu")
    for window in (CAM - 1, (CAM, CAM - 1), (H + 1, W)):  # smaller than the camera, or than the frame
        with pytest.raises(ValueError, match="must cover the camera view"):
            run_video_live(
                params, cfg, source, F, tmodel, tpred, INIT, roi_window=window,
                window_source=_window_source(video), device="cpu",
            )
