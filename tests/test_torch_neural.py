"""The port's predictor training, random draws and particle swarm against
the JAX package.

Reference: ``wtracker_tpu/neural/`` (``config.py``, ``dataset.py``,
``training.py``, ``optimize.py``), Flax's train-mode ``BatchNorm`` in
``wtracker_tpu/models/resmlp.py::MLPLayer``, and ``jax.random`` under the
package's ``jax_enable_x64``.

* ``MLPLayer`` in train mode: output and new ``batch_stats`` at rtol 1e-5.
* ``NumpyDataset`` from a seeded log and its split: exact.
* ``MLPTrainer`` for each optimizer (optax's ``adam``, ``sgd``,
  ``rmsprop`` chained behind ``add_decayed_weights``, and ``adamw``), two
  epochs from the same weights: per-batch losses, accuracies and final
  parameters at rtol 1e-4.  Both compute in float64 (JAX's RMLP follows its
  input's dtype; float32 parameters), for the reason
  ``tests/test_torch_yolo_training.py`` gives: XLA:CPU's in-order float32
  BatchNorm sums leave JAX's float32 losses ~1e-4 from exact after a few
  steps of 17 train-mode BatchNorms.
* Draws: the port's threefry ``uniform`` (float64, array bounds) and
  ``randint`` (int64) equal ``jax.random``'s bits at the recipe's and the
  swarm's shapes and keys.
* ``particle_swarm`` on a quadratic: JAX's history and best position bit
  for bit; ``optimize_polyfit_weights`` over a seeded log: JAX's history
  within rtol 1e-6 (an even camera size and an unclipped track, so no exact
  .5 tie of the polyfit arises: ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic import make_worm_csv
from wtracker_tpu.models import resmlp as jr
from wtracker_tpu.neural import config as jcfg
from wtracker_tpu.neural import dataset as jds
from wtracker_tpu.neural import optimize as jopt
from wtracker_tpu.neural import training as jtr
from wtracker_tpu.sim import config as jsim
from wtracker_tpu.sim.controllers import polyfit as jpoly
from wtracker_tpu_torch.convert import _flatten, flax_to_state_dict, resmlp_from_flax, state_dict_to_flax_flat
from wtracker_tpu_torch.models import resmlp as tr
from wtracker_tpu_torch.neural import config as tcfg
from wtracker_tpu_torch.neural import dataset as tds
from wtracker_tpu_torch.neural import optimize as topt
from wtracker_tpu_torch.neural import training as ttr
from wtracker_tpu_torch.neural import yolo_recipe as trec
from wtracker_tpu_torch.sim import config as tsim
from wtracker_tpu_torch.sim.controllers import polyfit as tpoly
from wtracker_tpu_torch.utils import flax_init

torch.set_num_threads(2)

INPUT_FRAMES = [0, -3, -6, -9, -12, -15, -18, -21, -24, -27, -30, -33, -36, -39, -42, -45]
PRED_FRAMES = [3, 6, 9, 12]


def _flat(variables: dict) -> dict:
    return {"/".join(k): v for k, v in _flatten(jax.tree.map(np.asarray, variables)).items()}


def test_mlp_layer_train_mode_is_flax_batchnorm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 12)) * 2 + 1).astype(np.float32)
    jm = jr.MLPLayer(20, "relu")
    jv = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    jv["batch_stats"]["bn"] = {"mean": rng.normal(0, 0.1, 20).astype(np.float32), "var": rng.uniform(0.5, 1.5, 20).astype(np.float32)}
    tm = tr.MLPLayer(12, 20, "relu")
    tm.load_state_dict(flax_to_state_dict(jv))

    np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach().numpy(), np.asarray(jm.apply(jv, x)), rtol=1e-5, atol=1e-6)
    y, upd = jm.apply(jv, x, train=True, mutable=["batch_stats"])
    got = tm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["bn"]["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]), rtol=1e-5)


@pytest.fixture(scope="module")
def log_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("neural") / "log.csv")
    make_worm_csv(path, num_frames=1500, seed=11, nan_every=41)
    return path


def test_dataset_and_split_equal(log_path):
    want = jds.NumpyDataset.create_from_config(jcfg.DatasetConfig(INPUT_FRAMES, PRED_FRAMES, log_path))
    got = tds.NumpyDataset.create_from_config(tcfg.DatasetConfig(INPUT_FRAMES, PRED_FRAMES, log_path))
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.y, want.y)
    for g, w in zip(got.split(0.8, seed=3), want.split(0.8, seed=3)):
        np.testing.assert_array_equal(g.X, w.X)
        np.testing.assert_array_equal(g.y, w.y)


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "rmsprop", "adamw"])
def test_mlp_trainer_two_epochs_match(log_path, optimizer):
    ds = jds.NumpyDataset.create_from_config(jcfg.DatasetConfig(INPUT_FRAMES, PRED_FRAMES, log_path))
    train, test = ds.split(0.8, seed=42)
    io = jcfg.IOConfig(INPUT_FRAMES, PRED_FRAMES)
    jpred = jr.make_rmlp_predictor(io, seed=42)
    stats64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jpred.variables["batch_stats"])
    jpred.variables = {**jpred.variables, "batch_stats": stats64}  # a float64 run carries float64 statistics
    tpred = tr.make_rmlp_predictor(tcfg.IOConfig(INPUT_FRAMES, PRED_FRAMES), device="cpu")
    tpred.model.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables)))

    tpred.model.double()
    jt = jtr.MLPTrainer(jpred, optimizer=optimizer, learning_rate=1e-3, weight_decay=1e-5, seed=42)
    tt = ttr.MLPTrainer(tpred, optimizer=optimizer, learning_rate=1e-3, weight_decay=1e-5, seed=42)
    train64, test64 = ((d.X.astype(np.float64), d.y.astype(np.float64)) for d in (train, test))
    want = jt.fit(train64, test64, num_epochs=2, print_every=0, batch_size=256)
    got = tt.fit(train64, test64, num_epochs=2, print_every=0, batch_size=256)
    assert got.num_epochs == want.num_epochs == 2 and len(got.train_loss) == len(want.train_loss) >= 4
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    params = state_dict_to_flax_flat(tt.model.state_dict())
    for k, w in _flat(jt.variables).items():
        np.testing.assert_allclose(params[k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_state_round_trip(tmp_path, log_path):
    ds = tds.NumpyDataset.create_from_config(tcfg.DatasetConfig(INPUT_FRAMES, PRED_FRAMES, log_path))
    pred = tr.make_rmlp_predictor(tcfg.IOConfig(INPUT_FRAMES, PRED_FRAMES), device="cpu")
    a = ttr.MLPTrainer(pred, optimizer="adamw")
    a.train_epoch(ds, batch_size=128)
    ttr.save_train_state(a, str(tmp_path), step=3)
    b = ttr.MLPTrainer(tr.make_rmlp_predictor(tcfg.IOConfig(INPUT_FRAMES, PRED_FRAMES), seed=5, device="cpu"), optimizer="adamw")
    ttr.load_train_state(b, str(tmp_path), step=3)
    a.rng, b.rng = np.random.default_rng(7), np.random.default_rng(7)
    ra, rb = a.train_epoch(ds, batch_size=128), b.train_epoch(ds, batch_size=128)
    assert ra.losses == rb.losses
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


# jitted, as the recipe and the swarm draw (XLA fuses the uniform's scaling
# into a multiply-add there); one compile per shape for the whole module
_uniform = jax.jit(lambda k, lo, hi, shape: jax.random.uniform(k, shape, minval=lo, maxval=hi), static_argnums=3)
_randint = jax.jit(lambda k, n, shape: jax.random.randint(k, shape, 0, n), static_argnums=(1, 2))


@pytest.mark.parametrize("seed", [0, 3, 100_003 * 7 + 2])
def test_draws_equal_jax_random(seed):
    k = jax.random.PRNGKey(seed)
    kk = flax_init.key(seed)
    np.testing.assert_array_equal(flax_init.split(kk, 5), np.asarray(jax.random.split(k, 5)))
    for shape, lo, hi in [((72,), -1.0, 1.0), ((72, 2), -0.1, 0.1), ((72,), 0.0, 1.0), ((8, 3), -2.0, 3.0)]:
        want = np.asarray(_uniform(k, lo, hi, shape))
        np.testing.assert_array_equal(flax_init.uniform(kk, shape, lo, hi, dtype=np.float64), want)
    lo = np.full(8, 1e-6, np.float32)
    hi = np.full(8, 5.0, np.float32)
    want = np.asarray(_uniform(k, jnp.asarray(lo), jnp.asarray(hi), (100, 8)))
    np.testing.assert_array_equal(flax_init.uniform(kk, (100, 8), lo, hi, dtype=np.float64), want)
    for b in (4, 5, 72):
        want = np.asarray(_randint(k, b, (b, 3)))
        got = flax_init.randint(kk, (b, 3), 0, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_augment_draws_are_jax_key_tree():
    """``sample_augment`` walks JAX's ``augment_batch`` key tree."""
    from wtracker_tpu.neural import yolo_recipe as jrec

    cfg = trec.AugmentConfig()
    key = jax.random.split(jax.random.PRNGKey(5 * 100_003 + 1), 3)[2]
    k_m, k_s, _ = jax.random.split(key, 3)
    s, tx, ty, fx, fy = jax.jit(lambda k: jrec._sample_affine(k, 6, (64, 48), jrec.AugmentConfig()))(k_s)
    k_pick, k_apply = jax.random.split(k_m)
    draws = trec.sample_augment(np.asarray(key), 6, (64, 48), cfg)
    np.testing.assert_array_equal(draws["partners"], np.asarray(jax.random.randint(k_pick, (6, 3), 0, 6)))
    np.testing.assert_array_equal(draws["use_mosaic"], np.asarray(jax.random.uniform(k_apply, (6,)) < cfg.mosaic))
    np.testing.assert_array_equal(draws["flip_x"], np.asarray(fx))
    np.testing.assert_array_equal(draws["flip_y"], np.asarray(fy))
    np.testing.assert_array_equal(draws["tx"], np.asarray(tx))
    np.testing.assert_array_equal(draws["ty"], np.asarray(ty))
    np.testing.assert_allclose(draws["scale"], np.asarray(s), rtol=1e-15)


# ---------------------------------------------------------------------------
# particle swarm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_particle_swarm_bit_for_bit(seed):
    """A max of squares (no sum whose multiply-adds XLA would fuse in the
    objective itself): the swarm's own arithmetic is what is compared."""
    bounds = (np.array([-2.0, -1.0, 0.5]), np.array([3.0, 2.0, 4.0]))
    want = jopt.particle_swarm(lambda x: jnp.max((x - 0.7) ** 2), bounds, pop_size=8, epochs=20, seed=seed)
    got = topt.particle_swarm(lambda x: ((x - 0.7) ** 2).amax(dim=1), bounds, pop_size=8, epochs=20, seed=seed, device="cpu")
    np.testing.assert_array_equal(got.history, want.history)
    np.testing.assert_array_equal(got.best_position, want.best_position)
    assert got.best_value == want.best_value


def test_optimize_polyfit_weights_matches(tmp_path):
    path = str(tmp_path / "log.csv")
    make_worm_csv(path, num_frames=2400, seed=21, nan_every=0)
    timing_kw = dict(imaging_time_ms=75.0, pred_time_ms=30.0, moving_time_ms=50.0,
                     camera_size_mm=(1.2, 1.2), micro_size_mm=(0.25, 0.25))
    exp_kw = dict(name="pso", num_frames=2400, frames_per_sec=60, orig_resolution=(2000, 2000), px_per_mm=90, init_position=(300, 250))
    jt = jsim.TimingConfig(experiment_config=jsim.ExperimentConfig(**exp_kw), **timing_kw)
    tt = tsim.TimingConfig(experiment_config=tsim.ExperimentConfig(**exp_kw), **timing_kw)
    assert tt.camera_size_px[0] % 2 == 0 and tt.camera_size_px[1] % 2 == 0
    offsets = np.array([-30, -25, -20, -15, -10, -5, 0, 3])
    pred = tt.cycle_frame_num + tt.imaging_frame_num // 2
    jev = jpoly.WeightEvaluator([path], jt, offsets, pred)
    tev = tpoly.WeightEvaluator([path], tt, offsets, pred, device="cpu")
    want = jopt.optimize_polyfit_weights(jev, pop_size=8, epochs=20, seed=1)
    got = topt.optimize_polyfit_weights(tev, pop_size=8, epochs=20, seed=1)
    assert got.history.dtype == want.history.dtype == np.float32
    np.testing.assert_allclose(got.history, want.history, rtol=1e-6)
    np.testing.assert_allclose(got.best_position, want.best_position, rtol=1e-6)
    assert want.history[-1] < want.history[0]


def test_missing_tensorboard_is_named(monkeypatch):
    """tensorboard is imported only when logging is asked for, and its
    absence is named."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard"):
        ttr.summary_writer("unused")
