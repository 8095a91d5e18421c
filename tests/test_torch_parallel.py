"""The port's stream axis (``parallel/mesh.py``) against the JAX package's.

Reference: ``wtracker_tpu/parallel/mesh.py`` (``make_mesh``,
``pad_streams``, ``run_engine_sharded``) on the 8 CPU devices that
``tests/conftest.py`` forces, and ``wtracker_tpu/sim/engine_hetero.py``
(``run_sweep_hetero(mesh=)``).  The port's meshes are 2 and 8 slots on the
CPU.  The cases of ``tests/test_parallel.py``:

* the per-stream csv controller sharded: positions and worm boxes equal
  JAX's sharded run bit for bit (a plain controller sliced per slot and a
  per-slot factory alike), and the port's one-device run;
* S not a multiple of the mesh: JAX's ``ValueError`` words;
* ``pad_streams`` (JAX's arrays exactly), then the padded batch sharded;
* ``carry``/``return_carry``: two calls give one call's logs;
* the folded-stem live loop (YOLOv8 "n" at 64 px, ``delayed_log``) through
  per-slot factories: positions exact and boxes within 1e-3 px of JAX's
  sharded run (the stream tests' bars), the per-stream live loop equal to
  the port's one-device run;
* the mixed-geometry sweep on a mesh: JAX's ``bboxes.csv`` text;
* the live mixed-geometry loop (``yolo_mlp_controller_hetero``, the fixture's
  nano detector at 64 px) on two slots, a stream (and a camera size) a slot,
  2 cycles, as ``__graft_entry__.py``'s dry run shards it, the controller
  sliced per slot and from a per-slot factory: positions exact and boxes
  within 1e-3 px of JAX's sharded run, and equal to the port's one-device
  run.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from tests.test_engine_hetero import EXPS, TIMING
from tests.test_torch_engine_live import EXP48, LOOP_KW, N_CYCLES, TIMING48, _params, _port_yolo
from tests.test_torch_yolov8 import _decisive_class_head
from wtracker_tpu.models.resmlp import RMLP as JaxRMLP
from wtracker_tpu.models.resmlp import WormPredictor as JaxWormPredictor
from wtracker_tpu.models.yolov8 import YoloV8 as JaxYoloV8
from wtracker_tpu.models.yolov8 import fuse_conv_bn as jax_fuse_conv_bn
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.parallel import mesh as jm
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import engine_hetero as jh
from wtracker_tpu.sim import engine_live as jl
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
from wtracker_tpu_torch.convert import _unflatten, state_dict_to_flax_flat
from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.parallel import mesh as tm
from wtracker_tpu_torch.sim import engine as te
from wtracker_tpu_torch.sim import engine_hetero as th
from wtracker_tpu_torch.sim import engine_live as tl
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory

torch.set_num_threads(2)


def _engine_params(exp_cls, timing_cls, engine):
    exp = exp_cls(**EXP_KWARGS)
    timing = timing_cls(experiment_config=exp, **TIMING_KWARGS)
    return exp, engine.EngineParams.from_timing(timing, engine.headless_frame_shape(timing, exp.orig_resolution))


@pytest.fixture(scope="module")
def setup():
    _, params_j = _engine_params(JaxExperimentConfig, JaxTimingConfig, je)
    exp, params_t = _engine_params(ExperimentConfig, TimingConfig, te)
    return exp, params_j, params_t


def _tables(S: int, n: int = 480, seed: int = 0) -> np.ndarray:
    """(S, n, 4) xywh worm tables: random walks, NaN rows every 41st frame."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0.2, 1.0, (S, n, 2)), axis=1) + 250
    csvs = np.concatenate([pos - 5, np.full((S, n, 2), 10.0)], axis=-1)
    csvs[:, ::41] = np.nan
    return csvs


def _jax_stream_ctl(tables: np.ndarray, params):
    """tests/test_parallel.py's per-stream controller: the state carries
    each stream's table."""

    def init():
        return {"csv": jnp.asarray(tables, dtype=jnp.float64)}

    def decide(consts, state, ctx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bbox = je._gather_rows(state["csv"], f - params.pred_n)
        cam_tl = jnp.stack([ctx.position[0] - params.cam_w // 2, ctx.position[1] - params.cam_h // 2])
        center = (bbox[:2] - cam_tl) + bbox[2:] / 2
        target = center - jnp.array([params.cam_w / 2, params.cam_h / 2])
        return state, jnp.where(jnp.isfinite(bbox).all(), jnp.round(target), 0.0).astype(jnp.int32)

    def predict_all(consts, state, cycle_idx, positions):
        return je._gather_rows(state["csv"], cycle_idx * params.cycle_n + jnp.arange(params.cycle_n))

    return je.CycleController(init=init, decide=decide, predict_all=predict_all)


def _port_stream_ctl(tables: np.ndarray, params, device="cpu"):
    """The same controller in the port."""
    dev = torch.device(device)
    mid = torch.tensor([params.cam_w / 2, params.cam_h / 2], dtype=torch.float64, device=dev)
    steps = torch.arange(params.cycle_n, device=dev)

    def init():
        return {"csv": torch.tensor(tables, dtype=torch.float64, device=dev)}

    def decide(consts, state, ctx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bbox = te._gather_rows(state["csv"], torch.tensor([f - params.pred_n], device=dev))[0]
        cam_tl = torch.stack([ctx.position[0] - params.cam_w // 2, ctx.position[1] - params.cam_h // 2])
        center = (bbox[:2] - cam_tl) + bbox[2:] / 2
        target = center - mid
        return state, torch.where(torch.isfinite(bbox).all(), torch.round(target), 0.0).to(torch.int32)

    def predict_all(consts, state, cycle_idx, positions):
        return te._gather_rows(state["csv"], cycle_idx * params.cycle_n + steps)

    return te.CycleController(init=init, decide=decide, predict_all=predict_all)


def _cpu_mesh(k: int):
    return tm.make_mesh(devices=["cpu"] * k)


def _assert_logs_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.positions), np.asarray(want.positions))
    np.testing.assert_array_equal(np.asarray(got.worm_bboxes), np.asarray(want.worm_bboxes))  # NaN == NaN


def test_mesh_and_placement():
    mesh = _cpu_mesh(2)
    assert mesh.devices.size == mesh.size == 2 and mesh.axis == "streams"
    assert tm.make_mesh(1, axis="data", devices=["cpu", "cpu"]).size == 1
    x = torch.arange(12).reshape(4, 3)
    split, copies = tm.stream_sharding(mesh).place(x), tm.replicated(mesh).place(x)
    assert [p.tolist() for p in split] == [x[:2].tolist(), x[2:].tolist()]
    assert all(torch.equal(c, x) for c in copies)


@pytest.mark.parametrize("slots", [2, 8])
def test_sharded_csv_matches_jax(setup, slots):
    exp, params_j, params_t = setup
    S, n_cycles = 8, 20
    tables = _tables(S)
    init = np.tile(np.asarray(exp.init_position), (S, 1))
    want = jm.run_engine_sharded(params_j, _jax_stream_ctl(tables, params_j), init, n_cycles, jm.make_mesh(slots))
    assert len(want.positions.addressable_shards) == slots

    mesh = _cpu_mesh(slots)
    plain = tm.run_engine_sharded(params_t, _port_stream_ctl(tables, params_t), init, n_cycles, mesh)
    per_slot = tm.run_engine_sharded(
        params_t, lambda d, lo, hi: _port_stream_ctl(tables[lo:hi], params_t, d), init, n_cycles, mesh
    )
    one = te.run_engine_streams(params_t, _port_stream_ctl(tables, params_t), init, n_cycles, device="cpu")
    assert tuple(plain.positions.shape) == (n_cycles, S, params_t.cycle_n, 2)
    for got in (plain, per_slot, one):
        _assert_logs_equal(got, want)


def test_sharded_rejects_uneven_streams(setup):
    """S not divisible by the mesh fails loudly with padding guidance, in
    the JAX package's words; so do the other misuses."""
    exp, params_j, params_t = setup
    table = np.zeros((60, 4))
    init = np.tile(exp.init_position, (9, 1))  # 9 streams on 8 slots
    msg = "stream count 9 is not a multiple of the mesh size 8; pad the stream batch"
    with pytest.raises(ValueError, match=msg):
        jm.run_engine_sharded(params_j, je.csv_controller(table, params_j), init, 2, jm.make_mesh())
    with pytest.raises(ValueError, match=msg):
        tm.run_engine_sharded(params_t, te.csv_controller(table, params_t, device="cpu"), init, 2, _cpu_mesh(8))
    with pytest.raises(ValueError, match="delayed_log=True requires a batched controller"):
        tm.run_engine_sharded(params_t, te.csv_controller(table, params_t, device="cpu"), init[:8], 2, _cpu_mesh(8),
                              delayed_log=True)
    with pytest.raises(ValueError, match="pass a factory"):  # slots on another device than the controller's tensors
        tm.run_engine_sharded(params_t, te.csv_controller_streams(_tables(2), params_t, device="cpu"), init[:2], 2,
                              tm.make_mesh(devices=["cpu", "meta"]), batched_controller=True)


def test_pad_streams_then_shard(setup):
    """pad_streams makes an uneven batch mesh-divisible; the pad slots
    replay the last real stream."""
    exp, params_j, params_t = setup
    s_real = 11  # on 8 slots
    tables = np.random.default_rng(0).uniform(50, 400, size=(s_real, 90, 4))
    init = np.tile(exp.init_position, (s_real, 1))
    want_tables, want_init, want_real = jm.pad_streams(tables, init, 8)
    got_tables, got_init, got_real = tm.pad_streams({"t": tables}, init, 8)
    assert got_real == want_real == s_real
    np.testing.assert_array_equal(got_tables["t"], want_tables)
    np.testing.assert_array_equal(got_init, want_init)
    assert tm.pad_streams(tables[:8], init[:8], 8)[2] == 8

    want = jm.run_engine_sharded(params_j, _jax_stream_ctl(want_tables, params_j), want_init, 3, jm.make_mesh())
    got = tm.run_engine_sharded(params_t, _port_stream_ctl(got_tables["t"], params_t), got_init, 3, _cpu_mesh(8))
    _assert_logs_equal(got, want)
    np.testing.assert_array_equal(got.positions[:, s_real - 1].numpy(), got.positions[:, -1].numpy())


def test_carry_resumes_across_calls(setup):
    """A run split in two calls (``return_carry``, then ``carry`` and
    ``start_cycle``) gives the one call's logs, for a batched controller
    sliced per slot; equal to JAX's sharded run."""
    exp, params_j, params_t = setup
    S = 4
    tables = _tables(S, seed=3)
    init = np.tile(np.asarray(exp.init_position), (S, 1))
    want = jm.run_engine_sharded(params_j, je.csv_controller_streams(tables, params_j), init, 12, jm.make_mesh(2),
                                 batched_controller=True)
    ctl = te.csv_controller_streams(tables, params_t, device="cpu")
    mesh = _cpu_mesh(2)
    first, carry = tm.run_engine_sharded(params_t, ctl, init, 5, mesh, batched_controller=True, return_carry=True)
    assert len(carry) == 2 and tuple(carry[0][0].shape) == (2, 2)
    second = tm.run_engine_sharded(params_t, ctl, init, 7, mesh, batched_controller=True, start_cycle=5, carry=carry)
    joined = te.CycleLog(torch.cat([first.positions, second.positions]), torch.cat([first.worm_bboxes, second.worm_bboxes]))
    _assert_logs_equal(joined, want)
    _assert_logs_equal(tm.run_engine_sharded(params_t, ctl, init, 12, mesh, batched_controller=True), want)


# ---------------------------------------------------------------------------
# live loops on a mesh (the fixture of tests/test_torch_engine_live.py)
# ---------------------------------------------------------------------------

LIVE_S = 4


@pytest.fixture(scope="module")
def live():
    """The port's seeded weights (Flax's init, drawn without compiling JAX's
    init) carried to the JAX side; a decisive class head (near-tied top-1
    anchors would flip on float32 noise)."""
    _, params_j = _params(JaxExperimentConfig, JaxTimingConfig, je, EXP48, TIMING48)
    _, params_t = _params(ExperimentConfig, TimingConfig, te, EXP48, TIMING48)
    det = YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=1, device="cpu").model
    jvars = jax_fuse_conv_bn(_decisive_class_head(_unflatten(state_dict_to_flax_flat(det.state_dict()))))
    io = IOConfig([0, -3, -6], [3])
    tpred = make_rmlp_predictor(io, seed=2, device="cpu")
    m = tpred.model
    jpred = JaxWormPredictor(
        model=JaxRMLP(m.block_in_dim, m.block_dims, m.block_nonlins, m.n_blocks, m.out_dim, m.in_dim, m.batch_norm),
        variables=_unflatten(state_dict_to_flax_flat(m.state_dict())),
        io_config=JaxIOConfig(list(io.input_frames), list(io.pred_frames)),
    )
    trajs = np.stack([make_trajectory(600, (200, 200), seed=40 + i) for i in range(LIVE_S)])
    return (params_j, JaxYoloV8(nc=1, scale="n", fused=True), jvars, jpred), (params_t, _port_yolo(jvars, True), tpred), trajs


def test_folded_live_loop_sharded_matches_jax(live):
    (params_j, jmodel, jvars, jpred), (params_t, tmodel, tpred), trajs = live
    init = np.tile([100, 100], (LIVE_S, 1))
    ctl_j = jl.make_stream_batch_fused(params_j, jl.LiveLoopConfig(**LOOP_KW), JaxScene(), trajs, jmodel, jvars, jpred)
    want = jm.run_engine_sharded(params_j, ctl_j, init, N_CYCLES, jm.make_mesh(2), batched_controller=True, delayed_log=True)
    cfg = tl.LiveLoopConfig(**LOOP_KW)
    calls = []

    def factory(dev, lo, hi):
        calls.append((dev, lo, hi))
        return tl.make_stream_batch_fused(params_t, cfg, SyntheticScene(), trajs[lo:hi], tmodel, tpred, device=dev)

    got = tm.run_engine_sharded(params_t, factory, init, N_CYCLES, _cpu_mesh(2), batched_controller=True, delayed_log=True)
    assert calls == [(torch.device("cpu"), 0, 2), (torch.device("cpu"), 2, 4)]
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    b_got, b_want = got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes)
    np.testing.assert_array_equal(np.isnan(b_got), np.isnan(b_want))
    assert np.isfinite(b_got).any()
    np.testing.assert_allclose(b_got, b_want, atol=1e-3)
    one = te.run_engine_streams(params_t, factory(torch.device("cpu"), 0, LIVE_S), init, N_CYCLES, delayed_log=True, device="cpu")
    _assert_logs_equal(got, one)


def test_per_stream_live_loop_sharded_equals_one_device(live):
    """The per-stream live controller (the JAX package's ``vmap`` form,
    ``make_stream_batch``), sliced per slot: the one-device run's logs."""
    _, (params_t, tmodel, tpred), trajs = live
    init = np.tile([100, 100], (LIVE_S, 1))
    ctl = tl.make_stream_batch(params_t, tl.LiveLoopConfig(**LOOP_KW), SyntheticScene(), trajs, tmodel, tpred, device="cpu")
    got = tm.run_engine_sharded(params_t, ctl, init, 3, _cpu_mesh(2))
    _assert_logs_equal(got, te.run_engine_streams(params_t, ctl, init, 3, device="cpu"))


def test_sweep_hetero_on_a_mesh_matches_jax(tmp_path):
    exps_j = [JaxExperimentConfig(**e) for e in EXPS]
    exps_t = [ExperimentConfig(**e) for e in EXPS]
    params_j, geom_j = jh.geometry_from_configs([JaxTimingConfig(experiment_config=e, **TIMING) for e in exps_j], exps_j)
    params_t, geom_t = th.geometry_from_configs([TimingConfig(experiment_config=e, **TIMING) for e in exps_t], exps_t)
    tables = []
    for i, e in enumerate(EXPS):
        make_worm_csv(str(tmp_path / f"w{i}.csv"), num_frames=e["num_frames"], seed=11 + i)
        tables.append(pd.read_csv(tmp_path / f"w{i}.csv")[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(float))
    csvs = th.pad_worm_tables(tables)
    init = np.asarray([e.init_position for e in exps_t])
    want = jh.run_sweep_hetero(params_j, geom_j, jh.csv_controller_hetero(csvs, params_j, geom_j), init, mesh=jm.make_mesh(2))

    def factory(dev, lo, hi):
        return th.csv_controller_hetero(csvs[lo:hi], params_t, th.slice_geometry(geom_t, lo, hi), device=dev)

    mesh = _cpu_mesh(2)
    plain = th.csv_controller_hetero(csvs, params_t, geom_t, device="cpu")
    for ctl in (factory, plain):
        got = th.run_sweep_hetero(params_t, geom_t, ctl, init, mesh=mesh, device="cpu")
        for i in range(len(EXPS)):
            assert got[i].to_csv(index=False) == want[i].to_csv(index=False), f"exp{i}"


def test_per_stream_consts_stay_whole_on_a_mesh(setup):
    """A per-stream controller whose consts have a leading axis equal to S
    (polyfit's five sample times and fit weights, S=5 on five slots): every
    slot fits from all five samples, so the sharded run equals the
    one-device run."""
    exp, _, params_t = setup
    S = 5
    table = _tables(1, seed=5)[0]
    ctl = te.polyfit_controller(table, params_t, np.array([-15, -10, -5, 0, 3]), np.linspace(0.5, 1.0, 5), 2, device="cpu")
    assert ctl.consts["times"].shape[0] == S
    init = np.asarray(exp.init_position) + np.arange(S)[:, None] * np.array([4, -3])
    got = tm.run_engine_sharded(params_t, ctl, init, 6, _cpu_mesh(S))
    _assert_logs_equal(got, te.run_engine_streams(params_t, ctl, init, 6, device="cpu"))


def test_live_hetero_loop_sharded_matches_jax(live):
    (_, jmodel, jvars, jpred), (_, tmodel, tpred), _ = live
    exps_j = [JaxExperimentConfig(**e) for e in EXPS]
    exps_t = [ExperimentConfig(**e) for e in EXPS]
    params_j, geom_j = jh.geometry_from_configs([JaxTimingConfig(experiment_config=e, **TIMING) for e in exps_j], exps_j)
    params_t, geom_t = th.geometry_from_configs([TimingConfig(experiment_config=e, **TIMING) for e in exps_t], exps_t)
    assert len(EXPS) == 2 and len({tuple(c) for c in np.asarray(geom_t.cam_size)}) == 2  # one camera size a slot
    trajs = np.stack([make_trajectory(200, tuple(geom_t.bounds[i][::-1]), seed=40 + i) for i in range(2)])
    init = np.asarray([e.init_position for e in exps_t])
    ctl_j = jh.yolo_mlp_controller_hetero(params_j, geom_j, jl.LiveLoopConfig(**LOOP_KW), JaxScene(), trajs, jmodel,
                                          jvars, jpred)
    want = jm.run_engine_sharded(params_j, ctl_j, init, 2, jm.make_mesh(2), batched_controller=True)
    cfg = tl.LiveLoopConfig(**LOOP_KW)
    plain = th.yolo_mlp_controller_hetero(params_t, geom_t, cfg, SyntheticScene(), trajs, tmodel, tpred, device="cpu")

    def factory(dev, lo, hi):
        return th.yolo_mlp_controller_hetero(params_t, th.slice_geometry(geom_t, lo, hi), cfg, SyntheticScene(),
                                             trajs[lo:hi], tmodel, tpred, device=dev)

    one = te.run_engine_streams(params_t, plain, init, 2, batched_controller=True, device="cpu")
    for ctl in (plain, factory):
        got = tm.run_engine_sharded(params_t, ctl, init, 2, _cpu_mesh(2), batched_controller=True)
        assert tuple(got.positions.shape) == (2, 2, params_t.cycle_n, 2)
        np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
        b_got, b_want = got.worm_bboxes.numpy(), np.asarray(want.worm_bboxes)
        np.testing.assert_array_equal(np.isnan(b_got), np.isnan(b_want))
        assert np.isfinite(b_got).any()
        np.testing.assert_allclose(b_got, b_want, atol=1e-3)
        _assert_logs_equal(got, one)
