"""The port's detector-training recipe against the JAX package.

Reference: ``wtracker_tpu/neural/yolo_recipe.py`` (the schedule,
``augment_batch``, ``average_precision_50``, ``load_yolo_dataset``,
``YoloTrainingRun``).  YOLOv8n at 64 px.

* The learning rate at each step equals optax's
  ``warmup_cosine_decay_schedule`` (rtol 1e-6).
* ``augment_batch`` from JAX's key: JAX's images (atol 1e-5), boxes (atol
  1e-4) and masks, with mosaic on and off, on gray and 3-channel batches.
* ``average_precision_50``: JAX's value exactly (float64).
* ``load_yolo_dataset``: JAX's arrays exactly on square PNGs at ``imgsz``;
  where JAX resizes with OpenCV, the port's uint8 bilinear is within one
  grey level.
* Recipe epochs with augmentation off, from the same weights over the same
  batch order, uint8 gray storage: the mean loss and the learning rate, the
  weights, EMA weights and ``batch_stats`` after one and after three steps
  (rtol 1e-4; in float64 compute with the Adam tolerances of
  ``tests/test_torch_yolo_training.py``, which says why).
* Kill and resume gives the uninterrupted run's weights bit for bit; the
  two checkpoint faults of the JAX package are not copied (the epoch at
  which patience stops writes ``last.npz`` and the train state; an epoch
  without a validation value does not force a write).
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_yolo_training import ADAM_ATOL, adam_flat_gradients, assert_state_close, port_model
from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.neural import yolo_recipe as jrec
from wtracker_tpu_torch.convert import _unflatten, state_dict_to_flax_flat
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.neural import yolo_recipe as trec
from wtracker_tpu_torch.utils import image_codec

torch.set_num_threads(2)

S = 64


def _blob_batch(rng, B=8, size=S, G=2):
    images = rng.uniform(0, 0.2, size=(B, size, size)).astype(np.float32)
    gt = np.zeros((B, G, 4), np.float32)
    cls = np.zeros((B, G), np.int32)
    mask = np.zeros((B, G), bool)
    for i in range(B):
        for j in range(G if i % 2 else 1):
            cx, cy = rng.integers(12, size - 12, size=2)
            w, h = rng.integers(8, 16, size=2)
            images[i, cy - h // 2 : cy + h // 2, cx - w // 2 : cx + w // 2] = rng.uniform(0.7, 1.0)
            gt[i, j] = (cx - w // 2, cy - h // 2, cx + w // 2, cy + h // 2)
            mask[i, j] = True
    return images, gt, cls, mask


@pytest.mark.parametrize("epochs,steps,warmup", [(100, 5, 3.0), (3, 2, 3.0), (10, 7, 0.5)])
def test_schedule_equals_optax(epochs, steps, warmup):
    cfg = jrec.RecipeConfig(epochs=epochs, warmup_epochs=warmup)
    run = trec.YoloTrainingRun(ty.YoloV8(nc=1, scale="n"), (S, S), trec.RecipeConfig(epochs=epochs, warmup_epochs=warmup), steps_per_epoch=steps)
    total = max(2, epochs * steps)
    w = min(max(1, int(round(warmup * steps))), total - 1)
    want = optax.warmup_cosine_decay_schedule(cfg.lr0 * 0.01, cfg.lr0, w, total, cfg.lr0 * cfg.lrf)
    for count in range(total + 3):
        np.testing.assert_allclose(run.schedule(count), float(want(count)), rtol=1e-6)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("mosaic_on", [True, False])
def test_augment_batch_equals_jax(channels, mosaic_on):
    rng = np.random.default_rng(4)
    images, gt, cls, mask = _blob_batch(rng, B=6)
    images = np.repeat(images[..., None], channels, axis=-1)
    cfg = jrec.AugmentConfig()
    key = jax.random.split(jax.random.PRNGKey(3 * 100_003 + 2), 4)[1]
    fn = jax.jit(lambda k, *batch: jrec.augment_batch(k, *batch, cfg, mosaic_on))
    want = fn(key, *(jnp.asarray(a) for a in (images, gt, cls, mask)))
    got = trec.augment_batch(np.asarray(key), *(torch.from_numpy(a) for a in (images, gt, cls, mask)), trec.AugmentConfig(), mosaic_on)
    w_img, w_gt, w_cls, w_mask = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), w_img, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), w_mask)
    np.testing.assert_array_equal(got[2].numpy(), w_cls)
    np.testing.assert_allclose(got[1].numpy()[w_mask], w_gt[w_mask], atol=1e-4)
    assert got[1].shape == w_gt.shape and w_mask.any()


def test_average_precision_equals_jax():
    rng = np.random.default_rng(7)
    B, D, G = 12, 9, 3
    gt = np.zeros((B, G, 4))
    gt[..., :2] = rng.uniform(0, 50, (B, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(5, 20, (B, G, 2))
    gt_mask = rng.random((B, G)) < 0.7
    idx = rng.integers(0, G, (B, D))
    det = np.take_along_axis(gt, idx[..., None], axis=1) + rng.normal(0, 3, (B, D, 4))
    scores = np.round(rng.random((B, D)), 1)  # ties across and within images
    valid = rng.random((B, D)) < 0.8
    for args in [(det, scores, valid, gt, gt_mask), (det, scores, valid, gt, gt_mask, 0.3)]:
        assert trec.average_precision_50(*args) == jrec.average_precision_50(*args)
    assert trec.average_precision_50(det, scores, valid & False, gt, gt_mask) == 0.0


def _write_dataset(root, shapes, rng):
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        image_codec.imwrite(str(root / "images" / f"im{i:02d}.png"), img)
        rows = [f"0 {rng.uniform(0.3, 0.7):.5f} {rng.uniform(0.3, 0.7):.5f} {rng.uniform(0.05, 0.2):.5f} {rng.uniform(0.05, 0.2):.5f}"
                for _ in range(1 + i % 3)]
        (root / "labels" / f"im{i:02d}.txt").write_text("\n".join(rows) + "\n")


def test_loader_equals_jax_square(tmp_path):
    _write_dataset(tmp_path, [(S, S)] * 4, np.random.default_rng(1))
    for gray in (True, False):
        want = jrec.load_yolo_dataset(str(tmp_path / "images"), str(tmp_path / "labels"), S, max_gt=4, gray_uint8=gray)
        got = trec.load_yolo_dataset(str(tmp_path / "images"), str(tmp_path / "labels"), S, max_gt=4, gray_uint8=gray)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_loader_resizes_within_one_grey_level(tmp_path):
    _write_dataset(tmp_path, [(48, 80), (100, 70), (130, 130), (37, 61)], np.random.default_rng(2))
    want = jrec.load_yolo_dataset(str(tmp_path / "images"), str(tmp_path / "labels"), S, gray_uint8=True)
    got = trec.load_yolo_dataset(str(tmp_path / "images"), str(tmp_path / "labels"), S, gray_uint8=True)
    assert np.abs(got[0].astype(int) - want[0]).max() <= 1
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


def test_recipe_epochs_match_jax():
    """Three one-step epochs (warmup, then cosine), augmentation off."""
    rng = np.random.default_rng(5)
    images, gt, cls, mask = _blob_batch(rng, B=6)
    images = (images * 255).astype(np.uint8)  # compact gray storage
    cfg = dict(epochs=3, batch=4, warmup_epochs=1.0, augment=None, seed=2)
    jcfg = jrec.RecipeConfig(**{**cfg, "augment": jrec.AugmentConfig(0, 0, 0, 0, 0, 0, 0)})
    tcfg = trec.RecipeConfig(**{**cfg, "augment": trec.AugmentConfig(0, 0, 0, 0, 0, 0, 0)})

    init = ty.YoloV8Detector.init_random(nc=1, scale="n", imgsz=S, seed=1, device="cpu").model
    jv = _unflatten(state_dict_to_flax_flat(init.state_dict()))  # Flax's init, as the JAX package's variables
    jv64 = {**jv, "batch_stats": jax.tree.map(lambda a: a.astype(np.float64), jv["batch_stats"])}
    jrun = jrec.YoloTrainingRun(jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.float64), jv64, (S, S), jcfg, steps_per_epoch=1)
    trun = trec.YoloTrainingRun(port_model(jv, torch.float64), (S, S), tcfg, steps_per_epoch=1)

    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    d = [torch.from_numpy(a) for a in (images, gt, cls, mask)]
    flat = {}
    for e in range(3):
        want = jrun.run_epoch(e, *(jnp.asarray(a) for a in (images, gt, cls, mask)), jr)
        got = trun.run_epoch(e, *d, tr)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(trun.schedule(trun.step_count - 1), float(jrun.schedule(jrun.step_count - 1)), rtol=1e-6)
        now = adam_flat_gradients(trun.model, trun.optimizer)
        flat = {k: v | flat.get(k, False) for k, v in now.items()}
        if e in (0, 2):
            adam = (flat, 2 * tcfg.lr0 * (e + 1))
            assert_state_close(trun.model, jrun.variables(ema=False), rtol=1e-4, atol=ADAM_ATOL, adam=adam)
            assert_state_close(trun.eval_model(), jrun.variables(ema=True), rtol=1e-4, atol=ADAM_ATOL, adam=adam)


def _tiny_run(cfg, seed=5):
    model = ty.YoloV8Detector.init_random(nc=1, scale="n", imgsz=S, seed=seed, device="cpu").model
    return trec.YoloTrainingRun(model, (S, S), cfg, n_train=6)


def test_kill_and_resume_reproduces_uninterrupted_run(tmp_path):
    rng = np.random.default_rng(3)
    images, gt, cls, mask = _blob_batch(rng, B=8)
    images = (images * 255).astype(np.uint8)
    cfg = trec.RecipeConfig(epochs=3, batch=4, lr0=2e-3, warmup_epochs=1.0, val_fraction=0.25, val_max_det=4,
                            patience=10, close_mosaic=1, seed=1)
    run_a = _tiny_run(cfg)
    hist_a = run_a.fit(images, gt, cls, mask, ckpt_dir=str(tmp_path / "a"), log=lambda s: None)

    ck_b = str(tmp_path / "b")
    hist_b1 = _tiny_run(cfg).fit(images, gt, cls, mask, ckpt_dir=ck_b, log=lambda s: None, stop_after=2)
    assert [h.epoch for h in hist_b1] == [0, 1]
    run_b2 = _tiny_run(cfg, seed=9)  # other weights: everything must come back from the checkpoint
    hist_b2 = run_b2.fit(images, gt, cls, mask, ckpt_dir=ck_b, log=lambda s: None, resume=True)
    assert [h.epoch for h in hist_b2] == [2]

    for name, a in run_a.model.state_dict().items():
        assert torch.equal(a, run_b2.model.state_dict()[name]), name
    for name, a in run_a.ema_model.state_dict().items():
        assert torch.equal(a, run_b2.ema_model.state_dict()[name]), name
    assert hist_a[-1].train_loss == hist_b2[-1].train_loss
    assert hist_a[-1].val_map50 == hist_b2[-1].val_map50
    for name in ("best.npz", "last.npz"):
        assert open(tmp_path / "a" / name, "rb").read() == open(tmp_path / "b" / name, "rb").read(), name


class _Recording(trec.YoloTrainingRun):
    """Records the epochs at which the train state is written."""

    def save_state(self, directory, epoch, best_map, best_epoch):
        self.saved = getattr(self, "saved", []) + [epoch]
        super().save_state(directory, epoch, best_map, best_epoch)


def test_patience_stop_writes_last_checkpoint(tmp_path):
    """JAX breaks out of the loop after the write decision, so the stop epoch
    (not the last of ``epochs``, not on the ``ckpt_every`` cadence, no gain)
    writes nothing there (``yolo_recipe.py:913``); the port writes it."""
    rng = np.random.default_rng(3)
    images, gt, cls, mask = _blob_batch(rng, B=8)
    images = (images * 255).astype(np.uint8)
    cfg = trec.RecipeConfig(epochs=6, batch=4, val_fraction=0.25, val_max_det=4, patience=1, ckpt_every=100,
                            augment=trec.AugmentConfig(0, 0, 0, 0, 0, 0, 0))
    model = ty.YoloV8Detector.init_random(nc=1, scale="n", imgsz=S, seed=5, device="cpu").model
    run = _Recording(model, (S, S), cfg, n_train=6)
    hist = run.fit(images, gt, cls, mask, ckpt_dir=str(tmp_path), log=lambda s: None)
    stop = hist[-1].epoch
    assert stop < cfg.epochs - 1  # patience stopped the run
    assert run.saved[-1] == stop
    meta = run.load_state(str(tmp_path))
    assert meta["epoch"] == stop and meta["step_count"] == run.step_count


def test_no_validation_does_not_force_writes(tmp_path):
    """Without a validation value (NaN), JAX counts every epoch as improved
    and writes every epoch (``yolo_recipe.py:901``); the port writes on the
    ``ckpt_every`` cadence and at the last epoch."""
    rng = np.random.default_rng(3)
    images, gt, cls, mask = _blob_batch(rng, B=8)
    images = (images * 255).astype(np.uint8)
    cfg = trec.RecipeConfig(epochs=5, batch=4, ckpt_every=2, augment=trec.AugmentConfig(0, 0, 0, 0, 0, 0, 0))
    model = ty.YoloV8Detector.init_random(nc=1, scale="n", imgsz=S, seed=5, device="cpu").model
    run = _Recording(model, (S, S), cfg, n_train=8)
    empty = images[:0], gt[:0], mask[:0]
    hist = run.fit(images, gt, cls, mask, *empty, ckpt_dir=str(tmp_path), log=lambda s: None)
    assert len(hist) == 5 and all(np.isnan(h.val_map50) for h in hist)
    assert run.saved == [1, 3, 4]
