"""Training result records.

Port of :mod:`wtracker_tpu.neural.train_results`: the reference's three
tuple types with the same field names (notebooks pickle them and read them
by position).
"""

from __future__ import annotations

from typing import NamedTuple


class BatchResult(NamedTuple):
    """One batch: loss and number of "correct" predictions (within 1 px of
    the target center)."""

    loss: float
    num_correct: int


class EpochResult(NamedTuple):
    """One epoch: per-batch losses and overall accuracy on the split."""

    losses: list[float]
    accuracy: float

    @property
    def mean_loss(self) -> float:
        return sum(self.losses) / max(len(self.losses), 1)


class FitResult(NamedTuple):
    """Multi-epoch fit summary: losses per batch and accuracy per epoch."""

    num_epochs: int
    train_loss: list[float]
    train_acc: list[float]
    test_loss: list[float]
    test_acc: list[float]

    def best_epoch(self) -> int:
        """Index of the epoch with the highest test accuracy (0 if empty)."""
        if not self.test_acc:
            return 0
        return max(range(len(self.test_acc)), key=self.test_acc.__getitem__)
