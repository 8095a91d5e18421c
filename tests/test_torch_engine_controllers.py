"""The port's playback controllers against the JAX package's engine.

Reference: ``wtracker_tpu/sim/engine.py`` (``csv_controller``,
``optimal_controller``, ``polyfit_controller``, ``mlp_controller``,
``csv_controller_streams``, ``run_engine``, ``run_engine_streams``,
``logs_to_frame``, ``EngineParams.from_timing``).  Inputs: the worm tables
of ``tests/synthetic.py`` (NaN rows every 37th frame), at the fixture timing
(5 + 3 frames), the deployment timing of ``configs/timing_config.json``
(12 + 3) and a timing whose camera-ring offset is negative (3 + 5 frames,
so the csv controller reads the previous cycle's moving phase).  The bar is
byte-identical ``bboxes.csv`` text; the MLP runs the JAX predictor's
weights (``resmlp_from_flax``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.controllers import MLPController
from wtracker_tpu_torch.convert import resmlp_from_flax
from wtracker_tpu_torch.models.resmlp import RMLP, WormPredictor
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim import engine as te
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig

torch.set_num_threads(2)

DEPLOY_TIMING = "configs/timing_config.json"
NEGATIVE_OFFSET = dict(TIMING_KWARGS, imaging_time_ms=50.0, moving_time_ms=80.0)  # 3 + 5 frames
TIMINGS = {"fixture": TIMING_KWARGS, "deployment": DEPLOY_TIMING, "negative_offset": NEGATIVE_OFFSET}
POLYFIT = dict(degree=2, sample_times=[3, -8, 0, -4], weights=[1.5, 0.5, 2.0, 1.0])  # times unsorted on purpose
IO = dict(input_frames=[0, -3, -6], pred_frames=[3])


def _configs(which: str, exp_cls, timing_cls, num_frames: int = 480):
    exp = exp_cls(**{**EXP_KWARGS, "num_frames": num_frames})
    spec = TIMINGS[which]
    timing = timing_cls.load_json(spec) if isinstance(spec, str) else timing_cls(experiment_config=exp, **spec)
    return exp, timing


def _params(mod, timing, exp, **kw):
    return mod.EngineParams.from_timing(timing, mod.headless_frame_shape(timing, exp.orig_resolution), **kw)


@pytest.fixture(scope="module")
def worm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("worm") / "worm.csv")
    make_worm_csv(path, num_frames=480)
    return path, pd.read_csv(path).to_numpy(dtype=float)


@pytest.fixture(scope="module")
def predictors():
    jpred = jax_make_predictor(JaxIOConfig(**IO), block_in_dim=16, block_dims=(8, 16), n_blocks=2, seed=1)
    rmlp = RMLP(block_in_dim=16, block_dims=(8, 16), block_nonlins=("relu", "relu"), n_blocks=2, out_dim=2, in_dim=12)
    rmlp.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables)))
    return jpred, WormPredictor(rmlp.eval(), IOConfig(**IO))


def _controller(mod, name, csv_data, params, timing, worm_csv, predictor, **kw):
    if name == "csv":
        return mod.csv_controller(csv_data, params, **kw)
    if name == "optimal":
        return mod.optimal_controller(csv_data, params, **kw)
    if name == "polyfit":
        return mod.polyfit_controller(
            csv_data, params, np.array(POLYFIT["sample_times"]), np.array(POLYFIT["weights"]), POLYFIT["degree"], **kw
        )
    if mod is je:
        return je.mlp_controller(csv_data, params, predictor, MLPController(timing, worm_csv, predictor).max_dist_per_pred)
    return te.mlp_controller(csv_data, params, predictor, te.mlp_max_dist_per_pred(timing, predictor.io_config), **kw)


def _both(name, which, worm, predictors, motor="sine"):
    worm_csv, csv_data = worm
    jpred, tpred = predictors
    exp_j, timing_j = _configs(which, JaxExperimentConfig, JaxTimingConfig)
    exp_t, timing_t = _configs(which, ExperimentConfig, TimingConfig)
    params_j, params_t = _params(je, timing_j, exp_j, motor=motor), _params(te, timing_t, exp_t, motor=motor)
    assert vars(params_t) == vars(params_j)
    n = params_t.n_logged_cycles(exp_t.num_frames)
    ctl_j = _controller(je, name, csv_data, params_j, timing_j, worm_csv, jpred)
    ctl_t = _controller(te, name, csv_data, params_t, timing_t, worm_csv, tpred, device="cpu")
    want = je.logs_to_frame(params_j, je.run_engine(params_j, ctl_j, exp_j.init_position, n))
    got = te.run_engine(params_t, ctl_t, exp_t.init_position, n, device="cpu")
    return params_t, got, want


@pytest.mark.parametrize("which", list(TIMINGS))
@pytest.mark.parametrize("name", ["csv", "optimal", "polyfit", "mlp"])
def test_controller_logs_match_jax(name, which, worm, predictors):
    params, got, want = _both(name, which, worm, predictors)
    assert got.positions.dtype == torch.int32 and got.worm_bboxes.dtype == torch.float64
    assert te.logs_to_frame(params, got).to_csv(index=False) == want.to_csv(index=False)
    assert len(np.unique(got.positions.numpy().reshape(-1, 2), axis=0)) > 10  # the platform moved


def test_step_motor_matches_jax(worm, predictors):
    params, got, want = _both("csv", "fixture", worm, predictors, motor="step")
    assert params.motor_weights == (0.0, 0.0, 1.0)  # round(3 · 0.5) = 2
    assert te.logs_to_frame(params, got).to_csv(index=False) == want.to_csv(index=False)


def test_unknown_motor_raises():
    exp, timing = _configs("fixture", ExperimentConfig, TimingConfig)
    with pytest.raises(ValueError, match="unknown motor"):
        _params(te, timing, exp, motor="linear")


def test_fixtures_reach_the_edge_cases(worm):
    """The negative-offset timing reads the previous cycle's moving phase,
    and the optimal controller meets even and odd counts of finite rows."""
    _, csv_data = worm
    for which, want_negative in (("fixture", False), ("deployment", False), ("negative_offset", True)):
        exp, timing = _configs(which, ExperimentConfig, TimingConfig)
        p = _params(te, timing, exp)
        assert (2 * p.imaging_n - p.pred_n + 1 - p.cycle_n < 0) == want_negative
    finite = np.isfinite(csv_data).all(axis=1)
    counts = {
        int(finite[c * p.cycle_n : c * p.cycle_n + p.imaging_n].sum())
        for p in (_params(te, *_configs(w, ExperimentConfig, TimingConfig)[::-1]) for w in ("fixture", "deployment"))
        for c in range(1, p.n_logged_cycles(480) + 1)
    }
    assert {4, 5, 11, 12} <= counts


def test_resume_from_kept_carry(worm):
    _, csv_data = worm
    exp, timing = _configs("fixture", ExperimentConfig, TimingConfig)
    params = _params(te, timing, exp)
    ctl = te.polyfit_controller(csv_data, params, np.array([-8, -4, 0, 3]), np.ones(4), 1, device="cpu")
    whole = te.run_engine(params, ctl, exp.init_position, 30, device="cpu")
    first, carry = te.run_engine(params, ctl, exp.init_position, 12, return_carry=True, device="cpu")
    kept = tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in carry)
    rest = te.run_engine(params, ctl, None, 18, start_cycle=12, carry=carry, device="cpu")
    again = te.run_engine(params, ctl, None, 18, start_cycle=12, carry=carry, device="cpu")
    for a, b in zip(carry, kept):
        assert not isinstance(a, torch.Tensor) or torch.equal(a, b)  # the kept carry was not updated
    for field in ("positions", "worm_bboxes"):
        joined = torch.cat([getattr(first, field), getattr(rest, field)])
        np.testing.assert_array_equal(joined.numpy(), getattr(whole, field).numpy())
        np.testing.assert_array_equal(getattr(again, field).numpy(), getattr(rest, field).numpy())


def test_csv_streams_match_jax(tmp_path):
    tables = []
    for s, n in enumerate((480, 400, 440)):
        make_worm_csv(str(tmp_path / f"w{s}.csv"), num_frames=n, seed=20 + s)
        tables.append(pd.read_csv(tmp_path / f"w{s}.csv").to_numpy(dtype=float))
    csvs = np.full((3, 480, 4), np.nan)
    for s, t in enumerate(tables):
        csvs[s, : len(t)] = t
    init = np.array([[300, 250], [120, 90], [500, 400]])
    exp_j, timing_j = _configs("fixture", JaxExperimentConfig, JaxTimingConfig)
    exp_t, timing_t = _configs("fixture", ExperimentConfig, TimingConfig)
    params_j, params_t = _params(je, timing_j, exp_j), _params(te, timing_t, exp_t)
    n = params_t.n_logged_cycles(480)
    want = je.run_engine_streams(params_j, je.csv_controller_streams(csvs, params_j), init, n, batched_controller=True)
    got = te.run_engine_streams(
        params_t, te.csv_controller_streams(csvs, params_t, device="cpu"), init, n, batched_controller=True, device="cpu"
    )
    assert got.positions.shape == (n, 3, params_t.cycle_n, 2)
    for s in range(3):
        a = te.logs_to_frame(params_t, te.CycleLog(got.positions[:, s], got.worm_bboxes[:, s]))
        b = je.logs_to_frame(params_j, je.CycleLog(want.positions[:, s], want.worm_bboxes[:, s]))
        assert a.to_csv(index=False) == b.to_csv(index=False), f"stream {s}"


@pytest.mark.parametrize("finite", [12, 11, 0])
def test_nanmedian_is_jax_nanmedian(finite):
    rng = np.random.default_rng(finite)
    x = rng.normal(300.0, 40.0, (12, 2))
    x[rng.permutation(12)[: 12 - finite]] = np.nan
    got = te._nanmedian0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0)))
    if finite == 12:  # torch's own nanmedian takes the lower middle value
        assert not np.array_equal(got, torch.nanmedian(torch.from_numpy(x), dim=0).values.numpy())
    if finite == 0:
        assert np.isnan(got).all()


def test_mlp_clip_bound_matches_jax(worm, predictors):
    worm_csv, _ = worm
    jpred, tpred = predictors
    for which in ("fixture", "deployment"):
        _, timing_j = _configs(which, JaxExperimentConfig, JaxTimingConfig)
        _, timing_t = _configs(which, ExperimentConfig, TimingConfig)
        want = MLPController(timing_j, worm_csv, jpred).max_dist_per_pred
        assert te.mlp_max_dist_per_pred(timing_t, tpred.io_config) == want
