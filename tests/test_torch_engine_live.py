"""The port's synthetic live loop against the JAX package's.

Reference: ``wtracker_tpu/sim/synthetic.py`` (``SyntheticScene``),
``wtracker_tpu/sim/engine.py`` (``run_engine``, ``run_engine_streams``,
``logs_to_frame``) and ``wtracker_tpu/sim/engine_live.py``
(``hybrid_yolo_mlp_controller``, ``make_stream_batch``, ``_flat``,
``_fused``, ``make_decision_step``).  YOLOv8 scale "n" at 64 px, float32,
weights carried across with ``yolov8_from_flax`` / ``resmlp_from_flax``.
Rendered views agree within 1e-3 on the [0, 255] scale (sin, cos and exp
differ by ulps between the two libraries); platform positions and decision
moves are exact; worm boxes agree within 1e-3 px.
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS
from tests.test_torch_yolov8 import _decisive_class_head
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.models.yolov8 import YoloV8 as JaxYoloV8
from wtracker_tpu.models.yolov8 import fuse_conv_bn as jax_fuse_conv_bn
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import engine_live as jl
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
from wtracker_tpu_torch.convert import resmlp_from_flax, yolov8_from_flax
from wtracker_tpu_torch.models.resmlp import RMLP, WormPredictor, make_rmlp_predictor
from wtracker_tpu_torch.models.yolov8 import YoloV8
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim import engine as te
from wtracker_tpu_torch.sim import engine_live as tl
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

torch.set_num_threads(2)

LOOP_KW = dict(imgsz=(64, 64), conf=0.0, ring_size=32, log_mode=True, max_dist_per_pred=20.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_yolo(jvars, fused: bool) -> YoloV8:
    model = YoloV8(nc=1, scale="n", fused=fused)
    model.load_state_dict(yolov8_from_flax(_np(jvars)))
    return model.eval()


def _init_yolo(seed: int):
    jraw = JaxYoloV8(nc=1, scale="n")
    jvars = jax.jit(lambda k: jraw.init(k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(jax.random.PRNGKey(seed))
    return _decisive_class_head(jvars)


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------


def _render_inputs(view_hw, n=6, seed=0):
    """Worms near the centre, at each border and outside the view."""
    h, w = view_hw
    rng = np.random.default_rng(seed)
    cam = rng.uniform(0, 400, (n, 2)).round().astype(np.float32)
    off = np.array([[w / 2, h / 2], [2.0, h / 2], [w - 1.5, 3.0], [w + 9.0, h + 4.0], [-7.0, -5.0], [w / 3, h - 0.5]])
    worm = (cam + off[:n] + rng.uniform(-0.5, 0.5, (n, 2))).astype(np.float32)
    fidx = (np.arange(n) * 37 - 5).astype(np.int32)  # a negative index too, as cycle 0 of the fused loop gives
    return worm, cam, fidx


@pytest.mark.parametrize("view_hw", [(64, 80), (360, 360)], ids=["64x80", "360x360"])
@pytest.mark.parametrize("content", [False, True], ids=["canvas", "content-wh"])
def test_render_views_match_jax(view_hw, content):
    worm, cam, fidx = _render_inputs(view_hw)
    h, w = view_hw
    cwh = np.array([[w - 20, h - 14]] * 3 + [[w, h]] * 3, np.int32) if content else None
    want = np.asarray(
        JaxScene().render_views(
            jnp.asarray(worm), jnp.asarray(cam), view_hw, jnp.asarray(fidx), None if cwh is None else jnp.asarray(cwh)
        )
    )
    got = SyntheticScene().render_views(
        torch.from_numpy(worm), torch.from_numpy(cam), view_hw, torch.from_numpy(fidx),
        None if cwh is None else torch.from_numpy(cwh),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (6, h, w)
    assert want.max() > 150  # a worm is in view
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    one = SyntheticScene().render_view(
        torch.from_numpy(worm[1]), torch.from_numpy(cam[1]), view_hw, int(fidx[1]),
        None if cwh is None else torch.from_numpy(cwh[1]),
    )
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


def test_gt_bboxes_match_jax():
    xy = np.random.default_rng(1).uniform(0, 500, (3, 5, 2)).astype(np.float32)
    want = np.asarray(JaxScene().gt_bboxes(jnp.asarray(xy)))
    got = SyntheticScene().gt_bboxes(torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)


# ---------------------------------------------------------------------------
# single-stream loop (the fixture of tests/test_engine_live.py)
# ---------------------------------------------------------------------------


def _params(mod_exp, mod_timing, mod_engine, exp_kw, timing_kw):
    exp = mod_exp(**exp_kw)
    timing = mod_timing(experiment_config=exp, **timing_kw)
    return exp, mod_engine.EngineParams.from_timing(timing, mod_engine.headless_frame_shape(timing, exp.orig_resolution))


@pytest.fixture(scope="module")
def tiny():
    """The JAX test's unfused detector and tiny predictor, and the port's copies."""
    jvars = _init_yolo(0)
    jpred = jax_make_predictor(
        JaxIOConfig(input_frames=[0, -2, -4], pred_frames=[3]), block_in_dim=8, block_dims=(8,), n_blocks=1, seed=0
    )
    rmlp = RMLP(block_in_dim=8, block_dims=(8,), block_nonlins=("relu",), n_blocks=1, out_dim=2, in_dim=12)
    rmlp.load_state_dict(resmlp_from_flax(_np(jpred.variables)))
    return (JaxYoloV8(nc=1, scale="n"), jvars, jpred), (_port_yolo(jvars, False), WormPredictor(rmlp.eval(), IOConfig([0, -2, -4], [3])))


def test_hybrid_controller_run_engine_matches_jax(tiny):
    (jmodel, jvars, jpred), (tmodel, tpred) = tiny
    exp_j, params_j = _params(JaxExperimentConfig, JaxTimingConfig, je, EXP_KWARGS, TIMING_KWARGS)
    exp_t, params_t = _params(ExperimentConfig, TimingConfig, te, EXP_KWARGS, TIMING_KWARGS)
    traj = make_trajectory(400, (500, 600), seed=0)
    ctl_j = jl.hybrid_yolo_mlp_controller(params_j, jl.LiveLoopConfig(**LOOP_KW), JaxScene(), traj, jmodel, jvars, jpred)
    want = je.run_engine(params_j, ctl_j, exp_j.init_position, 8)
    ctl_t = tl.hybrid_yolo_mlp_controller(
        params_t, tl.LiveLoopConfig(**LOOP_KW), SyntheticScene(), traj, tmodel, tpred, device="cpu"
    )
    got = te.run_engine(params_t, ctl_t, exp_t.init_position, 8, device="cpu")
    assert got.positions.shape == (8, params_t.cycle_n, 2) and got.worm_bboxes.dtype == torch.float64
    assert torch.isfinite(got.worm_bboxes).all()
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes), atol=1e-3)


# ---------------------------------------------------------------------------
# stream loops, fused weights, folded stem (the fixture of
# tests/test_yolov8.py::test_engine_live_fold_stem_matches_standard)
# ---------------------------------------------------------------------------

EXP48 = dict(name="t", num_frames=600, frames_per_sec=60, orig_resolution=(200, 200), px_per_mm=90, init_position=(100, 100))
TIMING48 = dict(
    imaging_time_ms=100.0, pred_time_ms=40.0, moving_time_ms=50.0, camera_size_mm=(48 / 90, 48 / 90), micro_size_mm=(0.2, 0.2)
)
S = 3
N_CYCLES = 4


@pytest.fixture(scope="module")
def cam48():
    _, params_j = _params(JaxExperimentConfig, JaxTimingConfig, je, EXP48, TIMING48)
    _, params_t = _params(ExperimentConfig, TimingConfig, te, EXP48, TIMING48)
    assert (params_t.cam_w, params_t.cam_h, params_t.cycle_n) == (48, 48, 9)
    jvars = jax_fuse_conv_bn(_init_yolo(1))
    jpred = jax_make_predictor(JaxIOConfig([0, -3, -6], [3]), seed=2)
    tpred = make_rmlp_predictor(IOConfig([0, -3, -6], [3]), device="cpu")
    tpred.model.load_state_dict(resmlp_from_flax(_np(jpred.variables)))
    trajs = np.stack([make_trajectory(600, (200, 200), seed=40 + i) for i in range(S)])
    return (params_j, JaxYoloV8(nc=1, scale="n", fused=True), jvars, jpred), (params_t, _port_yolo(jvars, True), tpred), trajs


def _run_pair(cam48, factory: str, run_kw: dict, n_streams: int = S, **cfg_kw):
    (params_j, jmodel, jvars, jpred), (params_t, tmodel, tpred), trajs = cam48
    trajs = trajs[:n_streams]
    init = np.tile([100, 100], (n_streams, 1))
    ctl_j = getattr(jl, factory)(params_j, jl.LiveLoopConfig(**{**LOOP_KW, **cfg_kw}), JaxScene(), trajs, jmodel, jvars, jpred)
    want = je.run_engine_streams(params_j, ctl_j, init, N_CYCLES, **run_kw)
    ctl_t = getattr(tl, factory)(
        params_t, tl.LiveLoopConfig(**{**LOOP_KW, **cfg_kw}), SyntheticScene(), trajs, tmodel, tpred, device="cpu"
    )
    got = te.run_engine_streams(params_t, ctl_t, init, N_CYCLES, device="cpu", **run_kw)
    return got, want


@pytest.mark.parametrize(
    "factory, run_kw, cfg_kw",
    [
        ("make_stream_batch", {}, {"log_mode": False}),
        ("make_stream_batch_flat", {"batched_controller": True}, {}),
        ("make_stream_batch_fused", {"delayed_log": True}, {}),
    ],
    ids=["vmap", "flat", "fused"],
)
def test_stream_batch_matches_jax(cam48, factory, run_kw, cfg_kw):
    (_, _, _, _), (params_t, tmodel, _), _ = cam48
    assert tl._resolve_detect(None, tl.LiveLoopConfig(**LOOP_KW), tmodel, (48, 48)).folds_preproc
    got, want = _run_pair(cam48, factory, run_kw, **cfg_kw)
    assert tuple(got.positions.shape) == (N_CYCLES, S, params_t.cycle_n, 2) == want.positions.shape
    assert got.positions.dtype == torch.int32 and got.worm_bboxes.dtype == torch.float64
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    b_got, b_want = got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes)
    np.testing.assert_array_equal(np.isnan(b_got), np.isnan(b_want))
    assert np.isfinite(b_got).any()
    np.testing.assert_allclose(b_got, b_want, atol=1e-3)

    # the bboxes.csv of each stream.  The two formatters print the same
    # arrays as the same text; the two runs' files agree in every column but
    # the worm box, whose last printed float32 digits differ within 1e-3 px.
    wrm = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]
    for s in range(S):
        frame_t = te.logs_to_frame(params_t, te.CycleLog(got.positions[:, s], got.worm_bboxes[:, s]))
        frame_j = je.logs_to_frame(cam48[0][0], je.CycleLog(want.positions[:, s], want.worm_bboxes[:, s]))
        pos_j, box_j = np.array(want.positions[:, s]), np.array(want.worm_bboxes[:, s])
        same_arrays = te.logs_to_frame(params_t, te.CycleLog(torch.from_numpy(pos_j), torch.from_numpy(box_j)))
        assert same_arrays.to_csv(index=False) == frame_j.to_csv(index=False)
        csv_t, csv_j = (pd.read_csv(io.StringIO(f.to_csv(index=False))) for f in (frame_t, frame_j))
        pd.testing.assert_frame_equal(csv_t.drop(columns=wrm), csv_j.drop(columns=wrm))
        np.testing.assert_allclose(csv_t[wrm].to_numpy(), csv_j[wrm].to_numpy(), atol=1e-3)


def test_per_stream_step_keeps_unchanged_leaves():
    """A state leaf that every stream hands back as given (the trajectory
    table) stays the stacked tensor, uncopied; changed leaves are restacked."""
    _, params = _params(ExperimentConfig, TimingConfig, te, EXP48, TIMING48)
    L = params.cycle_n
    gt = torch.arange(3 * 10 * 2, dtype=torch.float32).reshape(3, 10, 2)
    ctl = te.CycleController(
        init=None,
        decide=lambda consts, st, ctx: ({"n": st["n"] + 1, "gt": st["gt"]}, torch.tensor([2, -1], dtype=torch.int32)),
        predict_all=lambda consts, st, cycle, positions: torch.full((L, 4), float(cycle), dtype=torch.float64),
    )
    pos = torch.full((3, 2), 100, dtype=torch.int32)
    carry = (pos, pos[:, None].expand(3, L, 2).clone(), {"n": torch.zeros(3), "gt": gt})
    (p, positions, state), log = te._make_per_stream_step(params, ctl)((), carry, 0)
    assert state["gt"] is gt and state["n"].tolist() == [1.0, 1.0, 1.0]
    assert p.tolist() == [[102, 99]] * 3
    assert tuple(positions.shape) == (3, L, 2) and tuple(log.worm_bboxes.shape) == (3, L, 4)


def test_detect_chunks_split_gives_the_same_logs(cam48):
    """detect_chunks=2 splits each cycle's 36 views into two batches of 18."""
    (_, _, _, _), (params_t, tmodel, tpred), _ = cam48
    trajs = np.stack([make_trajectory(600, (200, 200), seed=40 + i) for i in range(4)])
    logs = []
    for chunks in (1, 2):
        ctl = tl.make_stream_batch_fused(
            params_t, tl.LiveLoopConfig(**LOOP_KW, detect_chunks=chunks), SyntheticScene(), trajs, tmodel, tpred, device="cpu"
        )
        logs.append(te.run_engine_streams(params_t, ctl, np.tile([100, 100], (4, 1)), N_CYCLES, delayed_log=True, device="cpu"))
    np.testing.assert_array_equal(logs[0].positions.numpy(), logs[1].positions.numpy())
    np.testing.assert_array_equal(logs[0].worm_bboxes.numpy(), logs[1].worm_bboxes.numpy())


# ---------------------------------------------------------------------------
# the 40 ms decision step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_streams", [1, 3])
def test_decision_step_matches_jax(cam48, n_streams):
    """Inputs as bench.py builds them: k views per stream around the worm."""
    (params_j, jmodel, jvars, jpred), (params_t, tmodel, tpred), _ = cam48
    view_hw = (48, 48)
    k = len(jpred.io_config.input_frames)
    rng = np.random.default_rng(0)
    cam_tl = rng.uniform(10, 140, (n_streams, 2)).round().astype(np.float32)
    worm = (cam_tl[:, None] + [24.0, 24.0] + rng.uniform(-8, 8, (n_streams, k, 2))).astype(np.float32)
    views = np.array(
        JaxScene().render_views(
            jnp.asarray(worm.reshape(-1, 2)), jnp.repeat(jnp.asarray(cam_tl), k, axis=0), view_hw, jnp.arange(n_streams * k)
        )
    ).reshape(n_streams, k, *view_hw)

    for conf in (0.0, 2.0):  # 2.0: no detection anywhere -> stay put
        cfg = dict(LOOP_KW, conf=conf)
        step_j = jl.make_decision_step(jl.LiveLoopConfig(**cfg), jmodel, jvars, jpred, view_hw)
        want = np.asarray(jax.jit(step_j)(jvars, jpred.variables, jnp.asarray(views), jnp.asarray(cam_tl)))
        decide = tl.make_decision_step(tl.LiveLoopConfig(**cfg), tmodel, tpred, view_hw)
        got = decide(torch.from_numpy(views), torch.from_numpy(cam_tl))
        assert got.dtype == torch.int32 and tuple(got.shape) == (n_streams, 2)
        np.testing.assert_array_equal(got.numpy(), want)
        if conf > 1:
            assert not got.any()
        else:
            assert got.abs().sum() > 0
