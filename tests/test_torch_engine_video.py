"""The port's real-video closed loop against the JAX package's.

Reference: ``wtracker_tpu.sim.engine_video.run_video_live`` with
``use_pallas_preproc=True`` (the Pallas crop+letterbox kernel, run in
interpret mode on the CPU) and ``fold_stem=False``, on the recording fixture
of ``tests/test_engine_video.py`` (300x360, square 1.2 mm camera, YOLOv8
scale "n" at 64 px, float32).  The port runs the same loop on the CPU, where
its kernel wrapper takes the plain version.  Platform positions must match
exactly; worm boxes to 1e-3 px.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_yolov8 import _decisive_class_head
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.models.yolov8 import YoloV8 as JaxYoloV8
from wtracker_tpu.models.yolov8 import fuse_conv_bn as jax_fuse_conv_bn
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim import engine as jax_engine
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.engine_video import run_video_live as jax_run_video_live
from wtracker_tpu.sim.synthetic import make_trajectory as jax_make_trajectory
from wtracker_tpu_torch.convert import resmlp_from_flax, yolov8_from_flax
from wtracker_tpu_torch.models.resmlp import RMLP, WormPredictor
from wtracker_tpu_torch.models.yolov8 import YoloV8, fuse_conv_bn
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim import engine, engine_video
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, _resolve_detect
from wtracker_tpu_torch.sim.engine_video import run_video_live
from wtracker_tpu_torch.sim.synthetic import make_trajectory

torch.set_num_threads(2)

# 264 frames = 32 logged cycles of 8 frames: two full chunks of 16 cycles
H, W, F = 300, 360, 264
INIT = (180, 150)
LOOP_KW = dict(imgsz=(64, 64), conf=0.0, ring_size=32, log_mode=True, max_dist_per_pred=20.0)


@pytest.fixture(scope="module")
def video():
    """Noisy background + bright worm blob, as in tests/test_engine_video.py."""
    rng = np.random.default_rng(0)
    traj = make_trajectory(F, (H, W), seed=3, margin=50)
    np.testing.assert_array_equal(traj, jax_make_trajectory(F, (H, W), seed=3, margin=50))
    bg = rng.integers(20, 40, (H, W), dtype=np.uint8)
    frames = np.repeat(bg[None], F, axis=0)
    for i in range(F):
        x, y = int(traj[i, 0]), int(traj[i, 1])
        frames[i, max(y - 4, 0) : y + 4, max(x - 6, 0) : x + 6] = 220
    return frames


def _timing(mod_exp, mod_timing):
    exp = mod_exp("vid", F, 60, (H, W), 90, INIT)
    return mod_timing(
        experiment_config=exp, imaging_time_ms=75.0, pred_time_ms=30.0, moving_time_ms=50.0,
        camera_size_mm=(1.2, 1.2), micro_size_mm=(0.25, 0.25),
    )


@pytest.fixture(scope="module")
def models():
    """The JAX test's models, and the same weights carried into the port."""
    jmodel = JaxYoloV8(nc=1, scale="n")
    jvars = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(jax.random.PRNGKey(0))
    jvars = _decisive_class_head(jvars)
    jpred = jax_make_predictor(
        JaxIOConfig(input_frames=[0, -2, -4], pred_frames=[3]), block_in_dim=8, block_dims=(8,), n_blocks=1
    )
    tmodel = YoloV8(nc=1, scale="n")
    tmodel.load_state_dict(yolov8_from_flax(jax.tree.map(np.asarray, jvars)))
    rmlp = RMLP(block_in_dim=8, block_dims=(8,), block_nonlins=("relu",), n_blocks=1, out_dim=2, in_dim=12)
    rmlp.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables)))
    tpred = WormPredictor(rmlp.eval(), IOConfig([0, -2, -4], [3]))
    return (jmodel, jvars, jpred), (tmodel.eval(), tpred)


@pytest.fixture(scope="module")
def jax_logs(video, models):
    (jmodel, jvars, jpred), _ = models
    params = jax_engine.EngineParams.from_timing(_timing(JaxExperimentConfig, JaxTimingConfig), (H, W))
    cfg = JaxLiveLoopConfig(**LOOP_KW, use_pallas_preproc=True, fold_stem=False)
    with pltpu.force_tpu_interpret_mode():
        logs = jax_run_video_live(
            params, cfg, lambda s, n: video[s : s + n], F, jmodel, jvars, jpred, INIT, cycles_per_chunk=16
        )
    return np.asarray(logs.positions), np.asarray(logs.worm_bboxes)


def _port_run(video, models, cycles_per_chunk, model=None, **cfg_kw):
    _, (tmodel, tpred) = models
    params = engine.EngineParams.from_timing(_timing(ExperimentConfig, TimingConfig), (H, W))
    cfg = LiveLoopConfig(**LOOP_KW, **cfg_kw)
    logs = run_video_live(
        params, cfg, lambda s, n: video[s : s + n], F, model or tmodel, tpred, INIT,
        cycles_per_chunk=cycles_per_chunk, device="cpu",
    )
    return logs.positions.numpy(), logs.worm_bboxes.numpy()


@pytest.mark.parametrize("use_fused_preproc", [True, False], ids=["kernel-wrapper", "crop-letterbox"])
def test_video_loop_matches_jax(video, models, jax_logs, use_fused_preproc):
    """Both preprocessing branches of the port against the JAX Pallas loop."""
    pos, boxes = _port_run(video, models, 16, use_fused_preproc=use_fused_preproc)
    want_pos, want_boxes = jax_logs
    assert pos.dtype == np.int32 and boxes.dtype == np.float64
    assert pos.shape == want_pos.shape == (32, 8, 2)
    assert np.isfinite(boxes).all()  # conf=0 -> always a box
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_allclose(boxes, want_boxes, atol=1e-3)


def test_video_loop_chunked_equals_one_chunk(video, models):
    a = _port_run(video, models, 16, use_fused_preproc=True)
    b = _port_run(video, models, 64, use_fused_preproc=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_logs_to_frame_matches_jax(video, models, jax_logs):
    """The 17-column bboxes.csv text of the port's logs equals the JAX
    package's on the same logs."""
    params_t = engine.EngineParams.from_timing(_timing(ExperimentConfig, TimingConfig), (H, W))
    params_j = jax_engine.EngineParams.from_timing(_timing(JaxExperimentConfig, JaxTimingConfig), (H, W))
    pos, boxes = jax_logs
    boxes = boxes.copy()
    boxes[3, 2] = np.nan  # the missing-detection quirk writes 0.0
    got = engine.logs_to_frame(params_t, engine.CycleLog(torch.from_numpy(pos), torch.from_numpy(boxes)))
    want = jax_engine.logs_to_frame(params_j, jax_engine.CycleLog(pos, boxes))
    assert list(got.columns) == list(want.columns) and len(got.columns) == 17
    assert got.to_csv(index=False) == want.to_csv(index=False)


def test_video_loop_refuses_unported_options(video, models):
    _, (tmodel, tpred) = models
    params = engine.EngineParams.from_timing(_timing(ExperimentConfig, TimingConfig), (H, W))
    source = lambda s, n: video[s : s + n]
    # the fold needs BN-fused weights, as in the JAX package
    with pytest.raises(ValueError, match="fold_stem=True needs BN-fused"):
        run_video_live(params, LiveLoopConfig(**LOOP_KW, fold_stem=True), source, F, tmodel, tpred, INIT, device="cpu")
    with pytest.raises(ValueError, match="detector is on"):
        run_video_live(params, LiveLoopConfig(**LOOP_KW), source, F, tmodel, tpred, INIT, device="meta")


def test_video_loop_folded_stem_matches_jax(video, models, monkeypatch):
    """BN-fused weights at the padding-free 108 -> 64 geometry: the default
    (``fold_stem=None``) folds the stem in both packages, and the port's loop
    then leaves the kernel branch off even when it is asked for."""
    (jmodel, jvars, jpred), (tmodel, tpred) = models
    params_j = jax_engine.EngineParams.from_timing(_timing(JaxExperimentConfig, JaxTimingConfig), (H, W))
    with pytest.MonkeyPatch.context() as mp:  # the JAX loop must fold, so its Pallas branch stays off
        mp.setattr("wtracker_tpu.ops.pallas_preproc.crop_letterbox_views", None)
        want = jax_run_video_live(
            params_j, JaxLiveLoopConfig(**LOOP_KW, use_pallas_preproc=True), lambda s, n: video[s : s + n], F,
            JaxYoloV8(nc=1, scale="n", fused=True), jax_fuse_conv_bn(jvars), jpred, INIT, cycles_per_chunk=16,
        )

    calls = []
    monkeypatch.setattr(engine_video, "crop_letterbox_views", lambda *a, **k: calls.append(a))
    fused = fuse_conv_bn(tmodel)
    pos, boxes = _port_run(video, models, 16, model=fused, use_fused_preproc=True)
    assert not calls
    assert _resolve_detect(None, LiveLoopConfig(**LOOP_KW), fused, (108, 108)).folds_preproc
    assert np.isfinite(boxes).all()
    np.testing.assert_array_equal(pos, np.asarray(want.positions))
    np.testing.assert_allclose(boxes, np.asarray(want.worm_bboxes), atol=1e-3)
