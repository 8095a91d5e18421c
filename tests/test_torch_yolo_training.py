"""The port's train-mode BatchNorm, YOLOv8 loss, assigner and trainer
against the JAX package.

Reference: ``wtracker_tpu/neural/yolo_training.py`` (``pairwise_ciou``,
``task_aligned_assigner``, ``detection_loss``, ``YoloTrainer``) and Flax's
train-mode ``BatchNorm`` in ``wtracker_tpu/models/yolov8.py::ConvBN``.
YOLOv8n at 64 px, batch 4, 4 gt slots; weights carried over with
``yolov8_from_flax``.

* One ``ConvBN`` in train mode: output and new ``batch_stats`` at rtol 1e-5.
* On the same logits: ``pairwise_ciou``, the loss and its parts at rtol
  1e-5; the assigner's ``fg_mask`` and ``best_gt`` exactly, its target
  scores at rtol 1e-5.
* Through the model (gradients and optimizer steps), both sides compute in
  float64 (JAX: ``YoloV8(compute_dtype=float64)``, float32 parameters; the
  port: the module cast to float64).  In float32, XLA:CPU sums a
  BatchNorm's statistics in order, about 16x less precisely than torch's
  cascaded sum (1.4e-6 against 8.8e-8 relative on a 4,096-value mean), and
  ``E[x²] − E[x]²`` magnifies that; after the nano's 57 train-mode
  BatchNorms at batch 4, JAX's float32 logits are 1.2e-3 from the float64
  ones while the port's are 4e-5 from them.  In float64 both are exact to
  far below the tolerances, which then test the arithmetic: gradients of
  every parameter at rtol 1e-4 / atol 1e-6, losses, parameters and
  ``batch_stats`` after one and three AdamW steps at rtol 1e-4 with an
  atol of 1e-4, 10 % of one Adam step at lr 1e-3 (the largest gap measured
  is 3.8e-5, after three steps, where the steps' small differences have
  moved every later gradient).  Adam's step
  ``lr·m̂/(√v̂ + ε)`` of an entry whose gradient cancels to near zero
  follows that gradient's last float32 bits (the loss is float32 on both
  sides): entries with ``√v̂ < 100·ε`` at any step so far (about 10 % of a
  random-init nano's, most of them exact zeros) are held to ``2·lr`` a step
  instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.neural import yolo_training as jt
from wtracker_tpu_torch.convert import _flatten, _unflatten, flax_to_state_dict, state_dict_to_flax_flat, yolov8_from_flax
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.neural import yolo_training as tt

torch.set_num_threads(2)

S, B, G = 64, 4, 4
ADAM_ATOL = 1e-4  # 10 % of one Adam step at lr 1e-3 (module docstring)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(variables: dict) -> dict:
    """Flax variables as the ``/``-joined keys of the port's ``.npz``."""
    return {"/".join(k): v for k, v in _flatten(_np(variables)).items()}


def adam_flat_gradients(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The parameter entries whose Adam step follows their gradient's last
    bits: the step is ``lr·m̂/(√v̂ + ε)``, and where ``√v̂`` is below 100·ε
    (gradients that cancel to ~1e-7 and less) an ulp of the float32 loss
    moves it by a good part of ``lr``.  Keyed like the ``.npz``."""
    beta2, eps = optimizer.param_groups[0]["betas"][1], optimizer.param_groups[0]["eps"]
    flat = {}
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        v_hat = st["exp_avg_sq"] / (1 - beta2 ** float(st["step"]))
        flat[name] = (v_hat.sqrt() < 100 * eps).to(torch.float32)
    return {k: v.astype(bool) for k, v in state_dict_to_flax_flat(flat).items()}


def assert_state_close(model: torch.nn.Module, variables: dict, rtol: float, atol: float, adam=None):
    """The port's weights and BatchNorm statistics against Flax variables.
    ``adam=(flat, bound)``: entries flagged in ``flat`` (an entry whose Adam
    step followed its gradient's last bits at any step so far,
    :func:`adam_flat_gradients`) are held to ``bound``, the most that the
    steps so far can move them apart (``2·lr`` a step)."""
    got = state_dict_to_flax_flat(model.state_dict())
    want = _flat(variables)
    assert set(got) == set(want)
    flat = adam[0] if adam else {}
    for k, w in want.items():
        loose = flat.get(k, np.zeros(w.shape, bool))
        np.testing.assert_allclose(got[k][~loose], w[~loose], rtol=rtol, atol=atol, err_msg=k)
        if loose.any():
            assert np.abs(got[k][loose] - w[loose]).max() <= adam[1], k


def make_batch(seed: int, b: int = B, g: int = G, size: int = S):
    rng = np.random.default_rng(seed)
    images = rng.random((b, size, size, 3)).astype(np.float32)
    c = rng.uniform(10, size - 10, (b, g, 2))
    wh = rng.uniform(6, 20, (b, g, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    cls = np.zeros((b, g), np.int32)
    mask = rng.random((b, g)) < 0.7
    mask[:, 0] = True
    return images, gt, cls, mask


@pytest.fixture(scope="module")
def nano():
    """YOLOv8n at 64 px: Flax's init from seed 0 (the port's ``init_random``,
    within 2.4e-7 of it), as Flax variables of the JAX package's module."""
    model = ty.YoloV8Detector.init_random(nc=1, scale="n", imgsz=S, seed=0, device="cpu").model
    return jy.YoloV8(nc=1, scale="n"), _unflatten(state_dict_to_flax_flat(model.state_dict()))


def port_model(jv, dtype=torch.float32) -> ty.YoloV8:
    model = ty.YoloV8(nc=1, scale="n")
    model.load_state_dict(yolov8_from_flax(jv))
    return model.to(dtype)


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------


def test_convbn_train_mode_is_flax_batchnorm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 8, 8, 16)) + 0.5).astype(np.float32)
    jm = jy.ConvBN(32, 3, 1)
    jv = _np(jm.init(jax.random.PRNGKey(0), x))
    jv["batch_stats"]["bn"] = {"mean": rng.normal(0, 0.1, 32).astype(np.float32), "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}
    jv["params"]["bn"] = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32), "bias": rng.normal(0, 0.1, 32).astype(np.float32)}
    tm = ty.ConvBN(16, 32, 3, 1)
    tm.load_state_dict(flax_to_state_dict(jv))

    y_eval = jm.apply(jv, x, train=False)
    got_eval = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got_eval, np.asarray(y_eval), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.bn.running_var.numpy(), jv["batch_stats"]["bn"]["var"])  # eval updates nothing

    y, upd = jm.apply(jv, x, train=True, mutable=["batch_stats"])
    got = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["bn"]["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]), rtol=1e-5)
    # the biased batch variance, where torch's BatchNorm would take n/(n-1) of it
    xt = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), tm.conv.weight, padding=1)
    biased = xt.var(dim=(0, 2, 3), unbiased=False).detach().numpy()
    np.testing.assert_allclose(tm.bn.running_var.numpy(), 0.97 * jv["batch_stats"]["bn"]["var"] + 0.03 * biased, rtol=1e-5)


# ---------------------------------------------------------------------------
# the loss on identical logits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logits(nano):
    """Eval-mode logits of a batch (the port's forward), fed to both losses."""
    _, jv = nano
    images, gt, cls, mask = make_batch(1)
    with torch.no_grad():
        box_l, cls_l = port_model(jv).eval()(torch.from_numpy(images))
    return [t.numpy().copy() for t in box_l], [t.numpy().copy() for t in cls_l], gt, cls, mask


def test_pairwise_ciou_matches():
    rng = np.random.default_rng(2)
    gt = make_batch(3)[1][0]
    xy = rng.uniform(0, 60, (50, 2))
    pr = np.concatenate([xy, xy + rng.uniform(1, 25, (50, 2))], -1).astype(np.float32)
    want = np.asarray(jt.pairwise_ciou(jnp.asarray(gt), jnp.asarray(pr)))
    got = tt.pairwise_ciou(torch.from_numpy(gt), torch.from_numpy(pr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _decoded(box_l, cls_l):
    """The loss's decoded boxes, scores and anchors, from the port."""
    b = box_l[0].shape[0]
    box_flat = np.concatenate([t.reshape(b, -1, 64) for t in box_l], 1)
    cls_flat = np.concatenate([t.reshape(b, -1, 1) for t in cls_l], 1)
    anchors, strides = ty.make_anchors((S, S))
    dist = torch.from_numpy(box_flat).reshape(b, -1, 4, 16)
    ltrb = (torch.softmax(dist, -1) * torch.arange(16.0)).sum(-1).numpy()
    pred = np.concatenate([(anchors - ltrb[..., :2]) * strides, (anchors + ltrb[..., 2:]) * strides], -1)
    return 1 / (1 + np.exp(-cls_flat.astype(np.float32))), pred.astype(np.float32), (anchors * strides).astype(np.float32)


def test_assigner_matches(logits):
    box_l, cls_l, gt, cls, mask = logits
    scores, pred, anchors_px = _decoded(box_l, cls_l)
    want = jax.vmap(jt.task_aligned_assigner)(
        jnp.asarray(scores), jnp.asarray(pred), jnp.broadcast_to(anchors_px, (B, *anchors_px.shape)), gt, cls, mask
    )
    got = tt.task_aligned_assigner(*(torch.from_numpy(a) for a in (scores, pred, anchors_px, gt, cls, mask)))
    assert np.asarray(want[0]).sum() > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-12)


def test_detection_loss_matches(logits):
    box_l, cls_l, gt, cls, mask = logits
    want, want_parts = jax.jit(lambda b, c: jt.detection_loss(b, c, gt, cls, mask, (S, S)))(box_l, cls_l)
    got, parts = tt.detection_loss(
        [torch.from_numpy(t) for t in box_l], [torch.from_numpy(t) for t in cls_l],
        torch.from_numpy(gt), torch.from_numpy(cls), torch.from_numpy(mask), (S, S),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# through the model, in float64
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step(nano):
    """JAX's train-mode loss and gradients of a float64-compute nano, jitted
    once for the module: ``(params, batch_stats, *batch) -> ((loss,
    batch_stats), grads)``, the body of the JAX package's ``YoloTrainer``
    step."""
    jm = jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.float64)

    def loss_fn(params, stats, images, gt, cls, mask):
        (bl, cl), upd = jm.apply({"params": params, "batch_stats": stats}, images, train=True, mutable=["batch_stats"])
        return jt.detection_loss(bl, cl, gt, cls, mask, (S, S))[0], upd["batch_stats"]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _f64_stats(jv):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), jv["batch_stats"])


def test_loss_gradients_match(nano, jax_step):
    _, jv = nano
    images, gt, cls, mask = make_batch(4)
    (want, want_stats), grads = jax_step(jv["params"], _f64_stats(jv), images, gt, cls, mask)

    model = port_model(jv, torch.float64).train()
    bl, cl = model(torch.from_numpy(images))
    loss, _ = tt.detection_loss(bl, cl, *(torch.from_numpy(a) for a in (gt, cls, mask)), (S, S))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = state_dict_to_flax_flat({n: p.grad for n, p in model.named_parameters()})
    for k, w in _flat({"params": grads}).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    assert_state_close(model, {"params": jv["params"], "batch_stats": want_stats}, rtol=1e-5, atol=1e-7)


def test_yolo_trainer_steps_match(nano, jax_step):
    """``YoloTrainer``'s step against the JAX package's: its loss and
    gradients (the module's compiled ``jax_step``) and its optimizer,
    ``optax.adamw(1e-3, weight_decay=5e-4)`` (``yolo_training.py:232``)."""
    import optax

    _, jv = nano
    tx = optax.adamw(1e-3, weight_decay=5e-4)
    params, stats = jv["params"], _f64_stats(jv)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    ttrainer = tt.YoloTrainer(port_model(jv, torch.float64), imgsz=(S, S))
    flat = {}
    for step in range(3):
        batch = make_batch(10 + step)
        (want, stats), grads = jax_step(params, stats, *batch)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        got, parts = ttrainer.step(*batch)
        np.testing.assert_allclose(got, float(want), rtol=1e-4)
        now = adam_flat_gradients(ttrainer.model, ttrainer.optimizer)
        flat = {k: v | flat.get(k, False) for k, v in now.items()}
        if step in (0, 2):  # after one and after three steps
            assert_state_close(
                ttrainer.model, {"params": params, "batch_stats": stats}, rtol=1e-4, atol=ADAM_ATOL,
                adam=(flat, 2 * ttrainer.learning_rate * (step + 1)),
            )
