"""Train the worm-head detector (reference: yolo_training.ipynb).

Port of ``workflows/yolo_training.py``.  Consumes a YOLO-format dataset
(images + ``.txt`` label files with ``class cx cy w h`` normalized rows) and
trains a fresh YOLOv8 (Flax's init from ``--seed``) with the TAL/CIoU/DFL
loss under the full reference recipe (yolo/yolo_train_config.yaml): AdamW
wd 5e-4, 3-epoch warmup + cosine decay, mosaic/flip/translate/scale/
brightness augmentation, EMA weights, per-epoch validation mAP@0.5 with
best/last checkpoints, early stopping and resume
(:mod:`wtracker_tpu_torch.neural.yolo_recipe`).  Writes the best EMA
weights as the JAX package's ``.npz``::

    python -m wtracker_tpu_torch.workflows.yolo_training --images DIR --labels DIR \\
        --output det.npz [--scale s] [--imgsz 384] [--epochs 100] [--batch 72] [--device cuda]

``--dp`` trains data-parallel over every visible card: the command starts
one process a rank itself (``--dp-ranks N`` ranks, spread over the cards in
turn; with more ranks than cards, ranks share a card), each on its share of
every batch, and the result is one device's training on the whole batch.
The ranks meet through a ``file://`` store in a temporary directory; NCCL
joins them when each has a card of its own, gloo otherwise (and on the
CPU).  Rank 0 alone prints, validates and writes.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", required=True)
    ap.add_argument("--labels", required=True)
    ap.add_argument("--output", required=True, help="weights output (.npz, the best-val EMA weights)")
    ap.add_argument("--scale", default="s", choices=["n", "s", "m"])
    ap.add_argument("--imgsz", type=int, default=384)
    ap.add_argument("--max-gt", type=int, default=4, help="ground-truth box capacity per image")
    # recipe knobs (defaults = the reference's training yaml)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=72)
    ap.add_argument("--lr0", type=float, default=1e-3, help="peak AdamW learning rate")
    ap.add_argument("--lrf", type=float, default=0.01, help="final LR fraction (cosine decay)")
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--warmup-epochs", type=float, default=3.0)
    ap.add_argument("--patience", type=int, default=100, help="early-stop epochs without val improvement")
    ap.add_argument("--close-mosaic", type=int, default=10, help="disable mosaic for the last N epochs")
    ap.add_argument("--val-fraction", type=float, default=0.2)
    ap.add_argument("--mosaic", type=float, default=0.4)
    ap.add_argument("--fliplr", type=float, default=0.5)
    ap.add_argument("--flipud", type=float, default=0.3)
    ap.add_argument("--translate", type=float, default=0.1)
    ap.add_argument("--scale-jitter", type=float, default=0.2)
    ap.add_argument("--brightness", type=float, default=0.4)
    ap.add_argument("--no-augment", action="store_true", help="disable all augmentation")
    ap.add_argument("--ckpt-dir", help="per-epoch best/last checkpoints (default: alongside --output)")
    ap.add_argument("--ckpt-every", type=int, default=1, help="write last/train-state checkpoints every N epochs")
    ap.add_argument(
        "--resume",
        action="store_true",
        help="continue an interrupted run from the full train state in --ckpt-dir "
        "(weights + optimizer + EMA + epoch/best bookkeeping; exact continuation)",
    )
    ap.add_argument("--tensorboard-dir", help="stream loss / val mAP50 / lr scalars to this tensorboard log dir")
    ap.add_argument("--dp", action="store_true", help="data-parallel over every visible card, one process a rank")
    ap.add_argument(
        "--dp-ranks", type=int, help="ranks of --dp (default: one a visible card; one on the CPU), spread over the cards"
    )
    ap.add_argument("--export-torch", help="also export the best weights as an ultralytics-layout torch state dict")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device of the training (default: cuda)")
    args = ap.parse_args(argv)

    import os
    import sys

    import numpy as np
    import torch

    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.neural.yolo_recipe import AugmentConfig, RecipeConfig, YoloTrainingRun, load_yolo_dataset
    from wtracker_tpu_torch.parallel import mesh as pm
    from wtracker_tpu_torch.utils.device import resolve_device

    mesh, rank = None, 0
    if args.dp and pm.rank_from_env() is None:  # the launcher: one process a rank, then done
        cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
        if torch.device(args.device).type == "cuda" and not cards:
            resolve_device(args.device)  # raises: no card
        ranks = args.dp_ranks or max(cards, 1)
        devices = [f"cuda:{r % cards}" for r in range(ranks)] if cards else ["cpu"] * ranks
        print(f"data-parallel over {ranks} ranks on {', '.join(devices)}", flush=True)
        code = pm.launch_ranks("wtracker_tpu_torch.workflows.yolo_training", sys.argv[1:] if argv is None else argv, devices)
        if code:
            raise SystemExit(code)
        return
    dev = resolve_device(args.device)
    if args.dp:
        rank, devices, init_method = pm.rank_from_env()
        mesh = pm.make_mesh(axis="data", devices=devices)
        dev = pm.init_data_parallel(mesh, rank, init_method)
    main_rank = rank == 0
    say = print if main_rank else (lambda *a, **k: None)  # rank 0 alone reports
    if args.tensorboard_dir and main_rank:  # name a missing tensorboard before any training
        from wtracker_tpu_torch.neural.training import summary_writer

        summary_writer(args.tensorboard_dir).close()

    # compact grayscale-uint8 storage, expanded per batch on the device
    images, gt, cls, mask = load_yolo_dataset(args.images, args.labels, args.imgsz, max_gt=args.max_gt, gray_uint8=True)
    say(f"{len(images)} images, {int(mask.sum())} boxes")

    aug = (
        AugmentConfig(mosaic=0, fliplr=0, flipud=0, translate=0, scale=0, brightness=0, contrast=0)
        if args.no_augment
        else AugmentConfig(
            mosaic=args.mosaic,
            fliplr=args.fliplr,
            flipud=args.flipud,
            translate=args.translate,
            scale=args.scale_jitter,
            brightness=args.brightness,
        )
    )
    cfg = RecipeConfig(
        epochs=args.epochs,
        batch=min(args.batch, len(images)),
        lr0=args.lr0,
        lrf=args.lrf,
        weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs,
        patience=args.patience,
        close_mosaic=args.close_mosaic,
        val_fraction=args.val_fraction,
        ckpt_every=args.ckpt_every,
        augment=aug,
        seed=args.seed,
    )

    imgsz = (args.imgsz, args.imgsz)
    model = YoloV8Detector.init_random(nc=int(cls.max()) + 1, scale=args.scale, imgsz=imgsz, seed=args.seed, device=dev).model
    n = len(images)
    n_train = n - max(1, int(round(n * cfg.val_fraction))) if n > 4 else n
    run = YoloTrainingRun(model, imgsz, cfg, n_train=max(1, n_train), mesh=mesh)

    ckpt_dir = args.ckpt_dir or os.path.dirname(os.path.abspath(args.output))
    history = run.fit(images, gt, cls, mask, ckpt_dir=ckpt_dir, resume=args.resume, tensorboard_dir=args.tensorboard_dir)
    if not main_rank:
        torch.distributed.destroy_process_group()
        return

    best = [h for h in history if np.isfinite(h.val_map50)]
    if best:
        top = max(best, key=lambda h: h.val_map50)
        say(f"best val mAP50 {top.val_map50:.3f} at epoch {top.epoch}")

    det = run.detector()
    det.save(args.output)
    say(f"weights saved to {args.output}")
    if dev.type == "cuda":
        say(f"peak device memory {torch.cuda.max_memory_allocated(dev)} bytes")

    if args.export_torch:
        from wtracker_tpu_torch.models.yolo_port import save_torch_state_dict

        save_torch_state_dict(det, args.export_torch)
        say(f"torch state dict exported to {args.export_torch}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
