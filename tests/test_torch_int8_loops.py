"""The int8 detector inside the port's loops, against the JAX package's.

Reference: ``tests/test_yolov8_int8.py::test_int8_live_loop_runs`` (the
live loop with the int8 detect hook) and ``wtracker_tpu/sim/engine_hetero.py``
(``yolo_mlp_controller_hetero`` with ``forward_fn``).  One int8 artifact,
quantized by the port from a seeded YOLOv8 "n" at 64 px, drives both
packages: the logs must agree, positions exactly and boxes within 1e-3 px.
The JAX loops run op by op (``jax.disable_jit``): XLA's jit fuses the int8
epilogue into a fused multiply-add, which moves the bf16 class logits by an
ulp and can flip a near-tied top-1 anchor (``tests/test_torch_conv_s8.py``
bounds that difference).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.models import yolov8_int8 as ji
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.models import yolov8_int8 as ti

torch.set_num_threads(2)

IMGSZ = (64, 64)
BOX_ATOL = 1e-3


@pytest.fixture(scope="module")
def artifacts():
    """A port artifact of a seeded nano detector (calibrated on rendered
    scene views), and the same artifact as the JAX package's type."""
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

    torch.manual_seed(0)
    model = ty.fuse_conv_bn(ty.YoloV8(nc=1, scale="n").eval())
    xy = torch.from_numpy(make_trajectory(16, (160, 160), seed=7).astype(np.float32))
    views = SyntheticScene().render_views(xy, (xy - 32).clamp(0, 160 - 64), (64, 64), torch.arange(16))
    q = ti.quantize_detector(model, views, IMGSZ)
    return q, ji.QuantizedYolo(q.nc, q.scale, dict(q.absmax), q.qweights, q.reg_max)


def _live_setup(mod_config, mod_timing, mod_engine):
    from tests.synthetic import EXP_KWARGS, TIMING_KWARGS

    exp = mod_config.ExperimentConfig(**EXP_KWARGS)
    timing = mod_timing(experiment_config=exp, **TIMING_KWARGS)
    return mod_engine.EngineParams.from_timing(timing, mod_engine.headless_frame_shape(timing, exp.orig_resolution))


def test_int8_live_loop_matches_jax(artifacts):
    """The JAX test's int8 live loop (``make_stream_batch_fused`` with the int8
    detect hook), 2 streams, 3 cycles, in both packages."""
    from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
    from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
    from wtracker_tpu.sim import config as jc
    from wtracker_tpu.sim import engine as je
    from wtracker_tpu.sim import engine_live as jl
    from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
    from wtracker_tpu.sim.synthetic import make_trajectory
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.sim import config as tc
    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim import engine_live as tl
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    q, jq = artifacts
    qw = q.device_weights("cpu")
    jmodel = jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.bfloat16, fused=True)
    S = 2
    trajs = np.stack([make_trajectory(200, (160, 160), seed=i) for i in range(S)])
    init = np.tile([80, 80], (S, 1))
    kw = dict(imgsz=IMGSZ, conf=0.0, ring_size=32, log_mode=True, max_dist_per_pred=20.0)

    params_j = _live_setup(jc, jc.TimingConfig, je)
    jdetect = lambda m, v, views, imgsz, conf: ji.detect_top1_int8(jq, v, views, imgsz, conf)  # noqa: E731
    ctl_j = jl.make_stream_batch_fused(
        params_j, jl.LiveLoopConfig(**kw), JaxScene(), trajs, jmodel, jq.device_weights(),
        predictor=jax_make_predictor(JaxIOConfig([0, -2, -4], [3])), detect_fn=jdetect,
    )
    with jax.disable_jit():
        want = je.run_engine_streams(params_j, ctl_j, init, 3, delayed_log=True)

    params_t = _live_setup(tc, tc.TimingConfig, te)
    detect, _ = ti.make_detect_fns(q, qw=qw)
    ctl_t = tl.make_stream_batch_fused(
        params_t, tl.LiveLoopConfig(**kw), SyntheticScene(), trajs, ti.Int8Detector(q, qw),
        make_rmlp_predictor(IOConfig([0, -2, -4], [3]), device="cpu"), detect_fn=detect, device="cpu",
    )
    got = te.run_engine_streams(params_t, ctl_t, init, 3, delayed_log=True, device="cpu")
    assert got.positions.shape == (3, S, params_t.cycle_n, 2)
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes), rtol=0, atol=BOX_ATOL)
    assert np.isfinite(got.worm_bboxes.numpy()[1:]).any()


def test_hetero_forward_fn_matches_jax(artifacts):
    """``yolo_mlp_controller_hetero(forward_fn=partial(q.apply, qw))`` over
    two camera geometries (one stream each, 2 cycles), against the JAX loop
    with the same hook."""
    from tests.test_torch_engine_hetero import LOOP_KW, _configs
    from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
    from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
    from wtracker_tpu.sim import config as jc
    from wtracker_tpu.sim import engine as je
    from wtracker_tpu.sim import engine_hetero as jh
    from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
    from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
    from wtracker_tpu.sim.synthetic import make_trajectory
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.sim import config as tc
    from wtracker_tpu_torch.sim import engine as te
    from wtracker_tpu_torch.sim import engine_hetero as th
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    q, jq = artifacts
    qw = q.device_weights("cpu")
    sel = [0, 1]
    runs = {}
    for name, mod_c, mod_h in (("jax", jc, jh), ("torch", tc, th)):
        exps, timings = _configs(mod_c.ExperimentConfig, mod_c.TimingConfig)
        params, g2 = mod_h.geometry_from_configs(timings, exps)
        runs[name] = params, mod_h.StreamGeometry(*(a[sel] for a in g2)), np.stack([exps[g].init_position for g in sel])
    params_t, geom_t, init = runs["torch"]
    trajs = np.stack([make_trajectory(300, tuple(geom_t.bounds[i][::-1]), seed=10 + i) for i in range(len(sel))])

    params_j, geom_j, _ = runs["jax"]
    jmodel = jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.bfloat16, fused=True)
    ctl_j = jh.yolo_mlp_controller_hetero(
        params_j, geom_j, JaxLiveLoopConfig(**LOOP_KW), JaxScene(), trajs, jmodel, jq.device_weights(),
        jax_make_predictor(JaxIOConfig([0, -2, -4], [3])), forward_fn=jq.apply,
    )
    with jax.disable_jit():
        want = je.run_engine_streams(params_j, ctl_j, init, 2, batched_controller=True)

    ctl_t = th.yolo_mlp_controller_hetero(
        params_t, geom_t, LiveLoopConfig(**LOOP_KW), SyntheticScene(), trajs, ti.Int8Detector(q, qw),
        make_rmlp_predictor(IOConfig([0, -2, -4], [3]), device="cpu"), forward_fn=partial(q.apply, qw), device="cpu",
    )
    got = te.run_engine_streams(params_t, ctl_t, init, 2, batched_controller=True, device="cpu")
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes), rtol=0, atol=BOX_ATOL)
    assert np.isfinite(got.worm_bboxes.numpy()).any()
