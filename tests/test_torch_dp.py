"""The port's data axis against one device and against the JAX package.

Two gloo ranks on the CPU (``tests/torch_dp_worker.py``, joined through a
``file://`` store under ``tmp_path``) each take half of every batch; the
port's one-process run on the whole batch and the JAX package's step on a
2-device mesh (``tests/conftest.py``'s CPU devices) are the references.
Reference: ``wtracker_tpu/parallel/mesh.py::make_dp_train_step`` and
``wtracker_tpu/neural/yolo_training.py::make_dp_yolo_train_step``.

* Both ranks end with the same loss, gradients and weights, bit for bit.
* ResMLP (float64): the data-parallel step's loss, summed gradients and
  weights after the Adam step equal the one-process step at rtol 1e-9
  (gradients with a floor of 1e-9 of the largest, since a Dense bias in
  front of a BatchNorm has a gradient of rounding noise, whose Adam step is
  ``lr·sign(g)``: such weights are held to 2·lr), with and without
  train-mode BatchNorm (statistics of the whole batch);
  without BatchNorm (JAX's ``make_dp_train_step`` takes none) also JAX's
  data-parallel loss and weights, and JAX's gradients.
* YOLOv8n at 64 px (float64; a batch whose halves hold 4 and 1 boxes an
  image, so the ranks' target-score sums differ): the loss, the summed
  gradients and the BatchNorm running statistics equal the one-process
  step at rtol 1e-9.  Against JAX's ``make_dp_yolo_train_step`` (whose loss
  heads compute in float32 whatever the model's dtype) the loss and the
  statistics within ``tests/test_torch_yolo_training.py``'s float64 bars
  (rtol 1e-5; statistics atol 1e-7), and its gradients (its step with SGD
  at rate 1 as the optimizer) at rtol 1e-4 / atol 1e-6.
* One step of the recipe with every augmentation on and mosaic on every
  image (partners drawn over the whole batch): loss, gradients and
  statistics equal one process's at rtol 1e-9.
* Neither hand kernel launches.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dp_worker as w
from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.models.resmlp import RMLP as JaxRMLP
from wtracker_tpu.neural import yolo_training as jt
from wtracker_tpu.parallel import mesh as jm
from wtracker_tpu_torch.convert import _unflatten, state_dict_to_flax_flat
from wtracker_tpu_torch.neural.yolo_training import YoloTrainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks at once; returns a function that waits for them
    and gives rank 0's results (after holding rank 1's equal to them)."""
    tmp = tmp_path_factory.mktemp("dp")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", str(r), "2", str(tmp / "store"), str(tmp)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    done = {}

    def results() -> dict:
        if not done:
            for p in procs:
                out, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-3000:]
            r0, r1 = (torch.load(tmp / f"rank{r}.pt") for r in range(2))
            for case in ("mlp_bn0", "mlp_bn1", "yolo", "recipe"):
                assert r0[case]["loss"] == r1[case]["loss"], case
                for part in ("grads", "state"):
                    for k, v in r0[case][part].items():
                        assert torch.equal(v, r1[case][part][k]), (case, part, k)
            done.update(r0)
        return done

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


def _close(got: torch.Tensor, want, rtol: float = RTOL, floor: float = 0.0, what: str = ""):
    """Elementwise at ``rtol``, with an absolute ``floor``: gradients are
    held with a floor of ``rtol`` times the model's largest gradient, since
    a gradient that cancels (a Dense bias in front of a BatchNorm) is
    rounding noise."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol, atol=floor, err_msg=what)


def _grad_scale(grads: dict) -> float:
    return max(float(g.abs().max()) for g in grads.values())


def _weights_after_adam(got_state: dict, want_state: dict, grads: dict, lr: float):
    """Weights after the first Adam step: entries whose gradient is rounding
    noise (below 1e-9 of the model's largest) move by about ``lr·sign(g)``
    and may part by 2·lr; the others at rtol 1e-9.  BatchNorm statistics at
    rtol 1e-9."""
    scale = _grad_scale(grads)
    for k, want in want_state.items():
        got, want = got_state[k].double(), want.double()
        if k not in grads:
            _close(got, want, what=k)
            continue
        noise = grads[k].abs() < RTOL * scale
        _close(got[~noise], want[~noise], floor=RTOL * lr, what=k)
        assert float((got[noise] - want[noise]).abs().sum() and (got[noise] - want[noise]).abs().max()) <= 2 * lr * (1 + 1e-6), k


def _one_process(model, loss_fn, X, y, tx) -> tuple[float, dict]:
    model.train()
    loss = loss_fn(model(torch.from_numpy(X)), torch.from_numpy(y))
    tx.zero_grad()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    tx.step()
    return float(loss.detach()), grads


def _flax(model: torch.nn.Module) -> dict:
    """The model's weights as float64 Flax variables."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64), _unflatten(state_dict_to_flax_flat(model.state_dict())))


def test_yolo_dp_step(ranks):
    images, gt, cls, mask = w.yolo_batch()
    trainer = YoloTrainer(w.yolo_model(), imgsz=(w.YOLO_S, w.YOLO_S))
    loss, _ = trainer.step(images, gt, cls, mask)
    one = w.outcome(trainer.model, loss)

    # JAX: make_dp_yolo_train_step on a 2-device mesh, with SGD at rate 1
    # as the trainer's optimizer, so that the step's update is the gradient
    variables = _flax(w.yolo_model())
    jmodel = jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.float64)
    jtrainer = jt.YoloTrainer(jmodel, variables, imgsz=(w.YOLO_S, w.YOLO_S), learning_rate=1e-3)
    jtrainer.tx = optax.sgd(1.0)
    step = jt.make_dp_yolo_train_step(jtrainer, jm.make_mesh(2, axis="data"))
    batch = [jnp.asarray(a) for a in (images, gt, cls, mask)]
    params, want_stats, _, want_loss = step(
        jtrainer.params, jtrainer.batch_stats, jtrainer.tx.init(jtrainer.params), *batch
    )
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), jtrainer.params, params)

    got = ranks()["yolo"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL)
    for n, g in one["grads"].items():
        _close(got["grads"][n], g, floor=RTOL * _grad_scale(one["grads"]), what=n)
    stats = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 57
    for k in stats:
        _close(got["state"][k], one["state"][k], what=k)

    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-5)
    got_flat = state_dict_to_flax_flat({k: v for k, v in got["state"].items()})
    for k, v in {"/".join(p): a for p, a in _flatten({"batch_stats": want_stats}).items()}.items():
        np.testing.assert_allclose(got_flat[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    got_grads = state_dict_to_flax_flat({n: g.to(torch.float32) for n, g in got["grads"].items()})
    for k, v in {"/".join(p): a for p, a in _flatten({"params": jgrads}).items()}.items():
        np.testing.assert_allclose(got_grads[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_mlp_dp_step(ranks, batch_norm):
    model, tx, loss_fn, X, y = w.mlp_case(batch_norm)
    loss, grads = _one_process(model, loss_fn, X, y, tx)
    got = ranks()[f"mlp_bn{int(batch_norm)}"]
    np.testing.assert_allclose(got["loss"], loss, rtol=RTOL)
    for n, g in grads.items():
        _close(got["grads"][n], g, floor=RTOL * _grad_scale(grads), what=n)
    _weights_after_adam(got["state"], model.state_dict(), grads, 1e-3)
    if batch_norm:
        return

    # JAX: its data-parallel step on a 2-device mesh, and its gradients
    m, _, _, _, _ = w.mlp_case(False)
    variables = _flax(m)
    jmodel = JaxRMLP(m.block_in_dim, m.block_dims, m.block_nonlins, m.n_blocks, m.out_dim, m.in_dim, m.batch_norm)
    jloss = lambda p, t: ((p - t) ** 2).mean()  # noqa: E731
    tx_j = optax.adam(1e-3)
    step = jm.make_dp_train_step(jmodel, tx_j, jloss, jm.make_mesh(2, axis="data"))
    params, _, want_loss = step(variables["params"], tx_j.init(variables["params"]), X, y)
    jgrads = jax.grad(lambda p: jloss(jmodel.apply({"params": p}, X, train=True), y))(variables["params"])
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=RTOL)
    flat = lambda tree: {"/".join(k): v for k, v in _flatten(tree).items()}  # noqa: E731
    got_grads = state_dict_to_flax_flat_f64(got["grads"])
    for k, v in flat({"params": jgrads}).items():
        _close(got_grads[k], v, floor=RTOL * _grad_scale(grads), what=k)
    got_state = state_dict_to_flax_flat_f64(got["state"])
    for k, v in flat({"params": params}).items():
        _close(got_state[k], v, floor=RTOL * 1e-3, what=k)


def state_dict_to_flax_flat_f64(state: dict) -> dict:
    """``state_dict_to_flax_flat``'s keys and layout, keeping float64 (it
    casts to float32)."""
    out = {}
    for key, t in state.items():
        names = list(state_dict_to_flax_flat({key: t.to(torch.float32)}))
        if names:  # not a batch counter
            arr = t.detach().double().numpy()
            out[names[0]] = torch.from_numpy(np.ascontiguousarray(arr.T if arr.ndim == 2 else arr))
    return out


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_recipe_dp_step_with_mosaic(ranks):
    run, data = w.recipe_case()
    loss = run.run_epoch(0, *data, np.random.default_rng(9))
    one = w.outcome(run.model, loss)
    got = ranks()["recipe"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL)
    for n, g in one["grads"].items():
        _close(got["grads"][n], g, floor=RTOL * _grad_scale(one["grads"]), what=n)
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            _close(got["state"][k], v, what=k)


def test_dp_launches_no_hand_kernel(ranks):
    assert ranks()["launches"] == (0, 0)


def test_uneven_batch_and_missing_group_raise():
    from wtracker_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(axis="data", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch size 5 is not a multiple of the mesh size 2"):
        pm.dp_rows(mesh, 5)
    with pytest.raises(RuntimeError, match="init_data_parallel"):
        pm.dp_rows(mesh, 4)
    assert pm.dp_backend(mesh) == "gloo"
