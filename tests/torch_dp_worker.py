"""One rank of the data-parallel cases of ``tests/test_torch_dp.py`` (the
port only: no JAX here).

Run as ``python -m tests.torch_dp_worker RANK WORLD STORE OUT``: joins a
gloo group of WORLD CPU ranks through ``file://STORE``, runs each case (the
ResMLP step with and without BatchNorm, the YOLOv8n step, a recipe step) on
its rows of each batch, and saves what the test compares (the whole
batch's loss, the summed gradients, the BatchNorm statistics) as
``OUT/rank{RANK}.pt``.  The test runs the same case functions on one
process over the whole batch.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

MLP_IO = ([0, -2], [2])
YOLO_S, YOLO_B, YOLO_G = 64, 4, 4


def mlp_case(batch_norm: bool):
    """A float64 ResMLP (JAX's ``tests/test_parallel.py`` topology), its
    optax-arithmetic Adam, the MSE loss and an 8-row batch."""
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig, make_optimizer

    io = IOConfig(*MLP_IO)
    model = make_rmlp_predictor(io, block_in_dim=8, block_dims=(8,), n_blocks=1, batch_norm=batch_norm, seed=0,
                                device="cpu").model.double()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, io.in_dim))
    y = rng.normal(size=(8, io.out_dim))
    return model, make_optimizer("adam", model.parameters(), 1e-3, 0.0), (lambda p, t: ((p - t) ** 2).mean()), X, y


def yolo_batch():
    """A (4, 64, 64, 3) batch whose two halves hold different numbers of
    boxes (so each rank's target-score sum differs)."""
    rng = np.random.default_rng(4)
    images = rng.random((YOLO_B, YOLO_S, YOLO_S, 3)).astype(np.float32)
    c = rng.uniform(10, YOLO_S - 10, (YOLO_B, YOLO_G, 2))
    wh = rng.uniform(6, 20, (YOLO_B, YOLO_G, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    cls = np.zeros((YOLO_B, YOLO_G), np.int32)
    mask = np.zeros((YOLO_B, YOLO_G), bool)
    mask[: YOLO_B // 2] = True  # the first rank's images: four boxes each
    mask[YOLO_B // 2 :, 0] = True  # the second's: one
    return images, gt, cls, mask


def yolo_model():
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    return YoloV8Detector.init_random(nc=1, scale="n", imgsz=YOLO_S, seed=0, device="cpu").model.double()


def recipe_case(mesh=None):
    """One recipe step (float64, batch 4) with every augmentation on and
    mosaic on every image, over 6 uint8 gray images: the run and its data."""
    from wtracker_tpu_torch.neural.yolo_recipe import AugmentConfig, RecipeConfig, YoloTrainingRun

    images, gt, cls, mask = yolo_batch()
    images = np.concatenate([images, images[:2, ::-1]])[..., 0]
    images = (images * 255).astype(np.uint8)
    gt, cls, mask = (np.concatenate([a, a[:2]]) for a in (gt, cls, mask))
    cfg = RecipeConfig(epochs=3, batch=4, warmup_epochs=1.0, augment=AugmentConfig(mosaic=1.0), seed=3)
    run = YoloTrainingRun(yolo_model(), (YOLO_S, YOLO_S), cfg, steps_per_epoch=1, mesh=mesh)
    return run, [torch.from_numpy(a) for a in (images, gt, cls, mask)]


def outcome(model: torch.nn.Module, loss) -> dict:
    return {
        "loss": float(loss),
        "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None},
        "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
    }


def main(rank: int, world: int, store: str, out: str) -> None:
    from wtracker_tpu_torch.neural.yolo_training import YoloTrainer, make_dp_yolo_train_step
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8
    from wtracker_tpu_torch.ops.preproc import crop_letterbox_views
    from wtracker_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    mesh = pm.make_mesh(axis="data", devices=["cpu"] * world)
    pm.init_data_parallel(mesh, rank, f"file://{store}")
    results = {}
    for bn in (False, True):
        model, tx, loss_fn, X, y = mlp_case(bn)
        step = pm.make_dp_train_step(model, tx, loss_fn, mesh)
        results[f"mlp_bn{int(bn)}"] = outcome(model, step(X, y))

    trainer = YoloTrainer(yolo_model(), imgsz=(YOLO_S, YOLO_S))
    loss, _ = make_dp_yolo_train_step(trainer, mesh)(*yolo_batch())
    results["yolo"] = outcome(trainer.model, loss)

    run, data = recipe_case(mesh)
    loss = run.run_epoch(0, *data, np.random.default_rng(9))
    results["recipe"] = outcome(run.model, loss)
    results["launches"] = (crop_letterbox_views.launches, conv_s8.launches)
    torch.save(results, f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
