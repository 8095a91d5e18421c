"""Train the ResMLP movement predictor (reference: predictor_training.ipynb).

Port of ``workflows/predictor_training.py``.  Builds (bbox history → future
center) samples from detection logs and fits a fresh ResMLP (Flax's init
from ``--seed``) with Adam and MSE, keeping the best-validation weights in
``--output`` (the JAX package's ``.npz``).  Reference recipe: batch 128,
Adam lr 1e-3, wd 1e-5, up to 100 epochs, early stop after 15::

    python -m wtracker_tpu_torch.workflows.predictor_training --logs LOG.csv [...] \\
        --output predictor.npz [--epochs 100] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--logs", required=True, nargs="+", help="bboxes.csv log(s)")
    ap.add_argument("--output", required=True, help="checkpoint output (.npz)")
    ap.add_argument("--input-frames", type=int, nargs="+", default=[0, -3, -6, -9, -12, -15, -18, -21, -24, -27, -30, -33, -36, -39, -42, -45])
    ap.add_argument("--pred-frames", type=int, nargs="+", default=[3, 6, 9, 12])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=1e-5)
    ap.add_argument("--early-stopping", type=int, default=15)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="torch device of the training (default: cuda)")
    args = ap.parse_args(argv)

    from wtracker_tpu_torch.neural.config import DatasetConfig, TrainConfig
    from wtracker_tpu_torch.neural.training import fit_from_config

    cfg = TrainConfig(
        dataset=DatasetConfig(input_frames=args.input_frames, pred_frames=args.pred_frames, log_path=args.logs),
        model=None,
        loss_fn="mse",
        optimizer="adam",
        device=args.device,
        num_epochs=args.epochs,
        checkpoints=args.output,
        early_stopping=args.early_stopping,
        print_every=5,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        batch_size=args.batch,
        seed=args.seed,
    )
    trainer, result = fit_from_config(cfg)
    print(f"trained {result.num_epochs} epochs; best checkpoint at {args.output}")


if __name__ == "__main__":
    main()
