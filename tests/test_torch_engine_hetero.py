"""The port's mixed-geometry sweeps against the JAX package's.

Reference: ``wtracker_tpu/sim/engine_hetero.py`` (``geometry_from_configs``,
``bucket_by_cycle_shape``, ``pad_worm_tables``, ``csv_controller_hetero``,
``run_sweep_hetero``, ``yolo_mlp_controller_hetero``) and
``wtracker_tpu/ops/image.py`` (``make_letterbox_matrices``,
``letterbox_indexed``, ``replicate_pad``), on the two-experiment fixture of
``tests/test_engine_hetero.py`` (cameras of 108×99 and 110×101 px, arenas
and lengths that differ).  Bars: the sweep's per-experiment ``bboxes.csv``
text equals the JAX sweep's and the port's single-stream runs byte for
byte; letterbox operators exactly, letterboxed views within 1e-6; the live
loop (YOLOv8 "n" at 64 px with a decisive class head, float32, the JAX
test's tiny predictor) with equal positions and boxes within 1e-3 px.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic import make_worm_csv
from tests.test_engine_hetero import EXPS, TIMING
from tests.test_torch_yolov8 import _decisive_class_head
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.models.yolov8 import YoloV8 as JaxYoloV8
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.ops import image as ji
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import engine_hetero as jh
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
from wtracker_tpu_torch.convert import resmlp_from_flax, yolov8_from_flax
from wtracker_tpu_torch.models.resmlp import RMLP, WormPredictor
from wtracker_tpu_torch.models.yolov8 import YoloV8
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.ops import image as ti
from wtracker_tpu_torch.parallel.mesh import make_mesh
from wtracker_tpu_torch.sim import engine as te
from wtracker_tpu_torch.sim import engine_hetero as th
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

torch.set_num_threads(2)

LOOP_KW = dict(imgsz=(64, 64), conf=0.0, ring_size=32, log_mode=True, max_dist_per_pred=20.0)


def _configs(exp_cls, timing_cls, timing=TIMING, exps=EXPS):
    e = [exp_cls(**x) for x in exps]
    return e, [timing_cls(experiment_config=x, **timing) for x in e]


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hetero")
    import pandas as pd

    out = []
    for i, e in enumerate(EXPS):
        make_worm_csv(str(tmp / f"worm{i}.csv"), num_frames=e["num_frames"], seed=11 + i)
        out.append(pd.read_csv(tmp / f"worm{i}.csv")[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(float))
    return out


def test_geometry_and_buckets_match_jax():
    params_j, geom_j = jh.geometry_from_configs(*_configs(JaxExperimentConfig, JaxTimingConfig)[::-1])
    params_t, geom_t = th.geometry_from_configs(*_configs(ExperimentConfig, TimingConfig)[::-1])
    assert vars(params_t) == vars(params_j)
    for a, b in zip(geom_t, geom_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(geom_t.cam_size[0], geom_t.cam_size[1])  # genuinely mixed

    e = ExperimentConfig(**EXPS[0])
    t_a = TimingConfig(experiment_config=e, **TIMING)
    t_b = TimingConfig(experiment_config=e, **{**TIMING, "imaging_time_ms": 400.0})
    assert th.bucket_by_cycle_shape([t_a, t_b, t_a]) == [[0, 2], [1]]
    assert th.bucket_by_cycle_shape([t_a]) == [[0]]


def test_mismatched_timing_raises():
    exps = [ExperimentConfig(**e) for e in EXPS]
    t0 = TimingConfig(experiment_config=exps[0], **TIMING)
    t1 = TimingConfig(experiment_config=exps[1], **{**TIMING, "imaging_time_ms": 400.0})
    with pytest.raises(ValueError, match="cycle shape"):
        th.geometry_from_configs([t0, t1], exps)


def test_sweep_matches_jax_and_single_runs(tracks):
    exps_j, timings_j = _configs(JaxExperimentConfig, JaxTimingConfig)
    exps_t, timings_t = _configs(ExperimentConfig, TimingConfig)
    params_j, geom_j = jh.geometry_from_configs(timings_j, exps_j)
    params_t, geom_t = th.geometry_from_configs(timings_t, exps_t)
    np.testing.assert_array_equal(th.pad_worm_tables(tracks), jh.pad_worm_tables(tracks))
    init = np.asarray([e.init_position for e in exps_t])

    want = jh.run_sweep_hetero(params_j, geom_j, jh.csv_controller_hetero(jh.pad_worm_tables(tracks), params_j, geom_j), init)
    ctl = th.csv_controller_hetero(th.pad_worm_tables(tracks), params_t, geom_t, device="cpu")
    got = th.run_sweep_hetero(params_t, geom_t, ctl, init, device="cpu")
    for i, (exp, timing, table) in enumerate(zip(exps_t, timings_t, tracks)):
        text = got[i].to_csv(index=False)
        assert text == want[i].to_csv(index=False), f"exp{i} differs from the JAX sweep"
        own = te.EngineParams.from_timing(timing, te.headless_frame_shape(timing, exp.orig_resolution))
        solo = te.run_engine(
            own, te.csv_controller(table, own, device="cpu"), exp.init_position, own.n_logged_cycles(exp.num_frames), device="cpu"
        )
        assert text == te.logs_to_frame(own, solo).to_csv(index=False), f"exp{i} differs from its single run"


def test_sweep_on_a_mesh_raises(tracks):
    exps, timings = _configs(ExperimentConfig, TimingConfig)
    params, geom = th.geometry_from_configs(timings, exps)
    ctl = th.csv_controller_hetero(th.pad_worm_tables(tracks), params, geom, device="cpu")
    init = np.asarray([e.init_position for e in exps])
    # the mesh is ported (tests/test_torch_parallel.py); what it refuses:
    # streams that do not split evenly, and a plain controller on a mesh
    # whose slots are on other devices than its tensors
    with pytest.raises(ValueError, match="not a multiple of the mesh size 3"):
        th.run_sweep_hetero(params, geom, ctl, init, mesh=make_mesh(devices=["cpu"] * 3), device="cpu")
    with pytest.raises(ValueError, match="pass a factory"):
        th.run_sweep_hetero(params, geom, ctl, init, mesh=make_mesh(devices=["cpu", "meta"]), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_letterbox_indexed_matches_jax(dtype):
    src_hws, canvas, imgsz = [(99, 108), (101, 110), (60, 40)], (101, 110), (64, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ji.make_letterbox_matrices(src_hws, canvas, imgsz, dtype=jdt)
    got = ti.make_letterbox_matrices(src_hws, canvas, imgsz, dtype=tdt, device="cpu")
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, dtype=np.float32))
    assert got[4] == want[4]
    with pytest.raises(ValueError, match="exceeds the canvas"):
        ti.make_letterbox_matrices([(120, 50)], canvas, imgsz, device="cpu")

    views = np.random.default_rng(0).uniform(0, 255, (6, *canvas)).astype(np.float32)
    ids = np.array([0, 1, 2, 1, 0, 2])
    out_j = np.asarray(ji.letterbox_indexed(jnp.asarray(views), jnp.asarray(ids), *want[:4], dtype=jdt), np.float32)
    out_t = ti.letterbox_indexed(torch.from_numpy(views), torch.from_numpy(ids), *got[:4], dtype=tdt)
    assert out_t.shape == (6, 64, 64, 3) and out_t.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-6)
        # one geometry equals the plain letterbox of its native-size content
        plain, _ = ti.letterbox(torch.from_numpy(views[2:3, :60, :40]), imgsz)
        np.testing.assert_allclose(out_t[2:3].numpy(), plain.numpy(), atol=1e-6)
    else:  # an accumulation-order ulp may cross a bfloat16 rounding step
        np.testing.assert_allclose(out_t.float().numpy(), out_j, atol=2 ** -8)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3)])
def test_replicate_pad_matches_jax(shape):
    frame = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    got = ti.replicate_pad(torch.from_numpy(frame), (3, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ji.replicate_pad(jnp.asarray(frame), (3, 2))))
    assert got.dtype == torch.uint8


# ---------------------------------------------------------------------------
# the live YOLO+MLP loop over mixed geometries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live():
    jmodel = JaxYoloV8(nc=1, scale="n")
    jvars = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(jax.random.PRNGKey(0))
    jvars = _decisive_class_head(jvars)
    tmodel = YoloV8(nc=1, scale="n")
    tmodel.load_state_dict(yolov8_from_flax(jax.tree.map(np.asarray, jvars)))
    jpred = jax_make_predictor(JaxIOConfig([0, -2, -4], [3]), block_in_dim=8, block_dims=(8,), n_blocks=1, seed=0)
    rmlp = RMLP(block_in_dim=8, block_dims=(8,), block_nonlins=("relu",), n_blocks=1, out_dim=2, in_dim=12)
    rmlp.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables)))
    tpred = WormPredictor(rmlp.eval(), IOConfig([0, -2, -4], [3]))

    sel = [0, 0, 1, 1]  # two streams per geometry
    out = {}
    for name, exp_cls, timing_cls, mod in (("jax", JaxExperimentConfig, JaxTimingConfig, jh), ("torch", ExperimentConfig, TimingConfig, th)):
        exps, timings = _configs(exp_cls, timing_cls)
        params, g2 = mod.geometry_from_configs(timings, exps)
        geometry = mod.StreamGeometry(*(a[sel] for a in g2))
        out[name] = params, geometry, np.stack([np.asarray(exps[g].init_position) for g in sel])
    geometry = out["torch"][1]
    trajs = np.stack([make_trajectory(300, tuple(geometry.bounds[i][::-1]), seed=10 + i) for i in range(4)])
    return out, (jmodel, jvars, jpred), (tmodel.eval(), tpred), trajs


def test_live_hetero_loop_matches_jax(live):
    out, (jmodel, jvars, jpred), (tmodel, tpred), trajs = live
    params_j, geom_j, init = out["jax"]
    params_t, geom_t, _ = out["torch"]
    ctl_j = jh.yolo_mlp_controller_hetero(
        params_j, geom_j, JaxLiveLoopConfig(**LOOP_KW), JaxScene(), trajs, jmodel, jvars, jpred
    )
    want = je.run_engine_streams(params_j, ctl_j, init, 4, batched_controller=True)

    runs = []
    for chunks in (1, 2):
        ctl_t = th.yolo_mlp_controller_hetero(
            params_t, geom_t, LiveLoopConfig(**LOOP_KW, detect_chunks=chunks), SyntheticScene(), trajs, tmodel, tpred,
            device="cpu",
        )
        runs.append(te.run_engine_streams(params_t, ctl_t, init, 4, batched_controller=True, device="cpu"))
    got = runs[0]
    assert got.positions.shape == (4, 4, params_t.cycle_n, 2) and got.worm_bboxes.dtype == torch.float64
    assert torch.isfinite(got.worm_bboxes).all()
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes), atol=1e-3)
    assert len(np.unique(got.positions.numpy()[:, :, 0], axis=0)) > 1  # the platforms moved
    # detect_chunks splits each phase's views into sub-batches: the same numbers
    np.testing.assert_array_equal(runs[1].positions.numpy(), got.positions.numpy())
    np.testing.assert_allclose(runs[1].worm_bboxes.numpy(), got.worm_bboxes.numpy(), atol=1e-4)

    # a forward override sees the letterboxed batch
    seen = []
    ctl_f = th.yolo_mlp_controller_hetero(
        params_t, geom_t, LiveLoopConfig(**LOOP_KW), SyntheticScene(), trajs, tmodel, tpred,
        forward_fn=lambda x: seen.append(tuple(x.shape)) or tmodel(x), device="cpu",
    )
    hooked = te.run_engine_streams(params_t, ctl_f, init, 2, batched_controller=True, device="cpu")
    np.testing.assert_array_equal(hooked.positions.numpy(), got.positions.numpy()[:2])
    assert seen[:2] == [(4 * params_t.imaging_n, 64, 64, 3), (4 * params_t.moving_n, 64, 64, 3)]
