"""The port's detector gates (``wtracker_tpu_torch/tools/gates.py``) against
the JAX package's gate tests, on the trained checkpoint, on the CPU.

Reference: ``tests/test_trained_detector.py`` (held-out AP, closed-loop
tracking; the trained int8 drift is in ``tests/test_torch_tools_int8.py``)
and ``tests/test_yolov8.py::test_full_network_parity_flagship_scale``
(anchor-matched decoded boxes).
Each case feeds both packages the same arrays and holds:

- the held-out AP@0.5 on 4 images at 416 px: JAX's ``evaluate_map50``'s,
  and every detection of the 4 images within 1e-3 px and 1e-5 in score;
- the closed loop (float32, S=1 x 4 cycles at a 48 px camera): positions
  exactly, boxes within 1e-3 px (``tests/test_torch_engine_live.py``'s
  bar), and so the tracking numbers;
- the anchor-matched comparison on 2 views at 416 px: the port against
  JAX's Flax model on the same random s weights, inside the gate's bar.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.neural import yolo_recipe as jr
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.ops.image import letterbox as jax_letterbox
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import engine_live as jl
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
from wtracker_tpu_torch.convert import resmlp_from_flax
from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.neural.yolo_recipe import detections_for_map
from wtracker_tpu_torch.sim import engine as te
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.synthetic import make_trajectory
from wtracker_tpu_torch.tools import gates

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "models", "yolov8s_worm416.npz")
IMGSZ = 416
BOX_ATOL = 1e-3


@pytest.fixture(scope="module")
def jax_trained():
    return jy.YoloV8Detector.load(CKPT, imgsz=(IMGSZ, IMGSZ))


def test_map50_heldout_equals_jax(jax_trained):
    port = gates.map50_heldout(CKPT, "cpu", n=4)
    images, gt, mask = gates.heldout_set(4)
    want = jr.evaluate_map50(jax_trained.model, jax_trained.variables, images, gt, mask, (IMGSZ, IMGSZ),
                             conf=0.001, iou=0.7, max_det=8)
    assert port["pass"] and port["launches"] == {"crop_letterbox": 0, "conv_s8": 0}
    assert abs(port["ap50"] - want) <= 1e-9

    model = YoloV8Detector.load(CKPT, imgsz=IMGSZ, device="cpu").model
    boxes, scores, valid = detections_for_map(model, images, (IMGSZ, IMGSZ), 0.001, 0.7, 8)
    jboxes, jscores, jvalid = (np.asarray(a) for a in jr._detections_for_map(
        jax_trained.model, jax_trained.variables, images, (IMGSZ, IMGSZ), 0.001, 0.7, 8))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(boxes[valid], jboxes[jvalid], atol=BOX_ATOL)
    np.testing.assert_allclose(scores[valid], jscores[jvalid], atol=1e-5)


EXP48 = dict(name="gate", num_frames=600, frames_per_sec=60, orig_resolution=(200, 200), px_per_mm=90,
             init_position=(100, 100))
TIMING48 = dict(imaging_time_ms=100.0, pred_time_ms=40.0, moving_time_ms=50.0, camera_size_mm=(48 / 90, 48 / 90),
                micro_size_mm=(0.2, 0.2))


def _params(exp_cls, timing_cls, engine):
    timing = timing_cls(experiment_config=exp_cls(**EXP48), **TIMING48)
    return engine.EngineParams.from_timing(timing, engine.headless_frame_shape(timing, EXP48["orig_resolution"]))


def test_closed_loop_logs_equal_jax(jax_trained):
    imgsz, cycles = 64, 4  # the tracking numbers skip 3 warm-up cycles
    params_t, params_j = _params(ExperimentConfig, TimingConfig, te), _params(JaxExperimentConfig, JaxTimingConfig, je)
    assert (params_t.cam_w, params_t.cycle_n) == (48, 9)
    trajs = np.stack([make_trajectory(600, EXP48["orig_resolution"], seed=30)])
    init = np.tile([100, 100], (1, 1))

    jpred = jax_make_predictor(JaxIOConfig([0, -3, -6, -9, -12], [3]))
    jmodel = jy.YoloV8(nc=1, scale="s", fused=True)
    jvars = jy.fuse_conv_bn(jax_trained.variables)
    cfg = jl.LiveLoopConfig(imgsz=(imgsz, imgsz), conf=0.1, ring_size=64, log_mode=True, max_dist_per_pred=54.0)
    ctl = jl.make_stream_batch_fused(params_j, cfg, JaxScene(), trajs, jmodel, jvars, jpred)
    want = je.run_engine_streams(params_j, ctl, init, cycles, delayed_log=True)

    model = YoloV8Detector.load(CKPT, imgsz=imgsz, device="cpu").fuse().model
    predictor = make_rmlp_predictor(IOConfig([0, -3, -6, -9, -12], [3]), device="cpu")
    predictor.model.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables)))
    got = gates.closed_loop_logs(params_t, model, predictor, trajs, cycles, imgsz, init, "cpu")

    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes), atol=BOX_ATOL)
    assert np.isfinite(got.worm_bboxes.numpy()).mean() > 0.5  # the trained detector finds the worm here
    port = gates.tracking_quality(params_t, got, trajs)
    jax_logs = SimpleNamespace(**{k: torch.from_numpy(np.asarray(getattr(want, k))) for k in ("positions", "worm_bboxes")})
    jax_numbers = gates.tracking_quality(params_t, jax_logs, trajs)
    for key in ("detection_rate", "in_camera_share_after_cycle_3"):
        assert port[key] == jax_numbers[key]
    for key in ("median_center_err_px", "median_worm_deviation_px"):
        assert abs(port[key] - jax_numbers[key]) <= BOX_ATOL


def test_s416_parity_holds_the_port_against_flax(tmp_path):
    model = gates.random_detector("s", 7).eval()
    YoloV8Detector(model, (IMGSZ, IMGSZ)).save(str(tmp_path / "s.npz"))
    jdet = jy.YoloV8Detector.load(str(tmp_path / "s.npz"), imgsz=(IMGSZ, IMGSZ))
    frames = np.random.default_rng(5).integers(0, 255, size=(2, gates.CAM, gates.CAM), dtype=np.uint8)
    x, _ = jax_letterbox(jnp.asarray(frames), (IMGSZ, IMGSZ))
    want = jax.jit(lambda v, x: jdet.model.apply(v, x, train=False))(jdet.variables, x)

    got = gates.detector_logits(model, torch.from_numpy(frames))
    numbers = gates.anchor_matched(want, got, IMGSZ)
    result = gates.verdict("s416_parity", numbers, {"crop_letterbox": 0, "conv_s8": 0}, "cpu")
    assert result["pass"], result
    assert numbers["max_abs_logit_diff"] <= 2e-3  # the JAX gate's per-level logit bar
