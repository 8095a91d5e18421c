"""Predictor training: the fit loop, the ResMLP trainer and full-state
checkpoints.

Port of :mod:`wtracker_tpu.neural.training` (the reference's ``Trainer`` and
``MLPTrainer``): multi-epoch fit with best-validation checkpoints, early
stopping, per-batch losses, tensorboard scalars, and the "correct =
prediction within 1 px of the target" accuracy (``‖pred − y‖₂ < 1``).

Each epoch's batches are cut on the host exactly as the JAX trainer cuts
them (a ``default_rng(seed)`` permutation per training epoch, the tail
dropped, ``min(batch, n)`` samples a batch), uploaded in one copy, and
stepped through in order on the device; losses and counts stay on the
device until the epoch ends.  The optimizers are
:data:`~wtracker_tpu_torch.neural.config.OPTIMIZERS` (optax's arithmetic).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from wtracker_tpu_torch.neural.config import LOSSES, TrainConfig, make_optimizer

if TYPE_CHECKING:  # models.resmlp imports neural.config: import it here only for the annotations
    from wtracker_tpu_torch.models.resmlp import WormPredictor
from wtracker_tpu_torch.neural.dataset import NumpyDataset
from wtracker_tpu_torch.neural.train_results import EpochResult, FitResult


def summary_writer(log_dir: str | None = None):
    """A tensorboard ``SummaryWriter`` (tensorboard is imported here, and a
    missing package is named)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:  # torch raises ImportError naming tensorboard when it is absent
        raise ImportError(f"tensorboard logging needs the tensorboard package: {exc}") from exc
    return SummaryWriter(log_dir)


class Trainer:
    """Base trainer: epoch orchestration, checkpointing, early stopping, logs.

    Subclasses provide ``train_epoch``/``test_epoch`` returning
    :class:`EpochResult`.
    """

    def __init__(self, log: bool = False):
        self.logger = summary_writer() if log else None

    def fit(
        self,
        dl_train,
        dl_test,
        num_epochs: int,
        checkpoints: str | None = None,
        early_stopping: int | None = None,
        print_every: int = 1,
        **kw,
    ) -> FitResult:
        actual_epoch_num = 0
        epochs_without_improvement = 0
        train_loss, train_acc, test_loss, test_acc = [], [], [], []
        best_val_loss = None

        for epoch in range(num_epochs):
            actual_epoch_num += 1
            verbose = print_every > 0 and (epoch % print_every == 0 or epoch == num_epochs - 1)
            if verbose:
                print(f"--- EPOCH {epoch + 1}/{num_epochs} ---")

            train_result = self.train_epoch(dl_train, verbose=verbose, **kw)
            test_result = self.test_epoch(dl_test, verbose=verbose, **kw)

            train_loss.extend(train_result.losses)
            train_acc.append(train_result.accuracy)
            test_loss.extend(test_result.losses)
            test_acc.append(test_result.accuracy)

            if self.logger is not None:
                self.logger.add_scalar("loss/train", float(np.mean(train_result.losses)), epoch)
                self.logger.add_scalar("loss/test", float(np.mean(test_result.losses)), epoch)
                self.logger.add_scalar("accuracy/train", train_result.accuracy, epoch)
                self.logger.add_scalar("accuracy/test", test_result.accuracy, epoch)

            curr_val_loss = float(np.mean(test_result.losses))
            if best_val_loss is None or curr_val_loss < best_val_loss:
                best_val_loss = curr_val_loss
                epochs_without_improvement = 0
                if checkpoints is not None:
                    self.save_checkpoint(checkpoints, curr_val_loss)
            else:
                epochs_without_improvement += 1
                if early_stopping is not None and epochs_without_improvement >= early_stopping:
                    break

        return FitResult(actual_epoch_num, train_loss, train_acc, test_loss, test_acc)

    def save_checkpoint(self, checkpoint_filename: str, loss: Optional[float] = None) -> None:
        raise NotImplementedError()

    def train_epoch(self, dl_train, **kw) -> EpochResult:
        raise NotImplementedError()

    def test_epoch(self, dl_test, **kw) -> EpochResult:
        raise NotImplementedError()

    def log_hparam(self, hparam_dict: dict, metric_dict: dict = {}, run_name: str = "hparams"):
        if self.logger is not None:
            self.logger.add_hparams(hparam_dict, metric_dict, run_name=run_name)


class MLPTrainer(Trainer):
    """Trains a :class:`WormPredictor` in place, on the device of its model.

    Args:
        predictor: the model and IO contract to train.
        loss_fn: key into ``LOSSES`` ("mse", "l1").
        optimizer: key into ``OPTIMIZERS`` ("adam", "sgd", "rmsprop", "adamw").
        learning_rate / weight_decay: optimizer hyperparameters.
    """

    def __init__(
        self,
        predictor: WormPredictor,
        loss_fn: str = "mse",
        optimizer: str = "adam",
        learning_rate: float = 1e-3,
        weight_decay: float = 1e-5,
        log: bool = False,
        seed: int = 42,
    ):
        super().__init__(log=log)
        self.predictor = predictor
        self.model = predictor.model
        self.device = next(self.model.parameters()).device
        self.loss_name = loss_fn
        self.loss = LOSSES[loss_fn]
        self.rng = np.random.default_rng(seed)
        self.optimizer = make_optimizer(optimizer, self.model.parameters(), learning_rate, weight_decay)

    # -- data plumbing -----------------------------------------------------

    def _batchify(self, ds, batch_size: int, shuffle: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """(n_batches, batch, dim) X and y on the device: a permutation drawn
        from the trainer's generator when shuffling, the tail dropped."""
        X, y = (ds.X, ds.y) if hasattr(ds, "X") else ds
        n = len(X)
        idx = self.rng.permutation(n) if shuffle else np.arange(n)
        n_batches = max(n // batch_size, 1)
        bs = min(batch_size, n)
        idx = idx[: n_batches * bs]
        Xb = np.ascontiguousarray(X[idx].reshape(n_batches, bs, -1))
        yb = np.ascontiguousarray(y[idx].reshape(n_batches, bs, -1))
        return torch.from_numpy(Xb).to(self.device), torch.from_numpy(yb).to(self.device)

    def _epoch_result(self, losses: list, n_correct: list, n: int, split: str, verbose: bool) -> EpochResult:
        losses = torch.stack(losses).double().cpu().numpy().tolist()
        acc = float(torch.stack(n_correct).sum().item() / n * 100)
        if verbose:
            print(f"  {split}: loss {np.mean(losses):.5f}, accuracy {acc:.1f}%")
        return EpochResult(losses=losses, accuracy=acc)

    def train_epoch(self, dl_train, batch_size: int = 256, verbose: bool = False, **kw) -> EpochResult:
        Xb, yb = self._batchify(dl_train, batch_size, shuffle=True)
        self.model.train()
        losses, n_correct = [], []
        for X, y in zip(Xb, yb):
            preds = self.model(X)
            loss = self.loss(preds, y)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            losses.append(loss.detach())
            n_correct.append((torch.linalg.vector_norm(preds.detach() - y, dim=1) < 1.0).sum())
        return self._epoch_result(losses, n_correct, Xb.shape[0] * Xb.shape[1], "train", verbose)

    @torch.no_grad()
    def test_epoch(self, dl_test, batch_size: int = 256, verbose: bool = False, **kw) -> EpochResult:
        Xb, yb = self._batchify(dl_test, batch_size, shuffle=False)
        self.model.eval()
        losses, n_correct = [], []
        for X, y in zip(Xb, yb):
            preds = self.model(X)
            losses.append(self.loss(preds, y))
            n_correct.append((torch.linalg.vector_norm(preds - y, dim=1) < 1.0).sum())
        return self._epoch_result(losses, n_correct, Xb.shape[0] * Xb.shape[1], "test ", verbose)

    # -- persistence -------------------------------------------------------

    def sync_predictor(self) -> WormPredictor:
        """The bound predictor, its model back in eval mode."""
        self.model.eval()
        return self.predictor

    def save_checkpoint(self, checkpoint_filename: str, loss: Optional[float] = None) -> None:
        from wtracker_tpu_torch.models.resmlp import save_predictor

        if self.logger is not None:
            checkpoint_filename = f"{self.logger.log_dir}/{checkpoint_filename}"
        save_predictor(self.predictor, checkpoint_filename)
        print(f"\n*** Saved checkpoint {checkpoint_filename} :: val_loss={loss:.3f}")


def fit_from_config(config: TrainConfig) -> tuple[MLPTrainer, FitResult]:
    """One-call training from a :class:`TrainConfig` (dataset build + fit), on
    ``config.device``."""
    from wtracker_tpu_torch.models.resmlp import load_predictor, make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig

    ds = NumpyDataset.create_from_config(config.dataset)
    ds_train, ds_test = ds.split(config.train_test_split, seed=config.seed)

    if isinstance(config.model, str):
        predictor = load_predictor(config.model, device=config.device)
    elif hasattr(config.model, "io_config"):
        predictor = config.model
    else:
        predictor = make_rmlp_predictor(
            IOConfig.from_datasetConfig(config.dataset), seed=config.seed, device=config.device
        )

    trainer = MLPTrainer(
        predictor,
        loss_fn=config.loss_fn,
        optimizer=config.optimizer,
        learning_rate=config.learning_rate,
        weight_decay=config.weight_decay,
        log=config.log,
        seed=config.seed,
    )
    result = trainer.fit(
        ds_train,
        ds_test,
        num_epochs=config.num_epochs,
        checkpoints=config.checkpoints,
        early_stopping=config.early_stopping,
        print_every=config.print_every,
        batch_size=config.batch_size,
    )
    trainer.sync_predictor()
    return trainer, result


# ---------------------------------------------------------------------------
# full train-state checkpoints (params, batch stats and optimizer state)
# ---------------------------------------------------------------------------


def save_train_state(trainer: MLPTrainer, directory: str, step: int = 0) -> None:
    """Persist the complete training state (weights, BatchNorm statistics,
    optimizer) as ``state_{step}.pt`` in ``directory``, resumable mid-run."""
    os.makedirs(directory, exist_ok=True)
    state = {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict()}
    torch.save(state, os.path.join(directory, f"state_{step}.pt"))


def load_train_state(trainer: MLPTrainer, directory: str, step: int = 0) -> MLPTrainer:
    """Restore a state saved by :func:`save_train_state` in place (tensors
    only: ``torch.load(weights_only=True)``)."""
    state = torch.load(os.path.join(directory, f"state_{step}.pt"), map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    return trainer
