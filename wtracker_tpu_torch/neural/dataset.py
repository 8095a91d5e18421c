"""Training samples for the movement predictor, built from detection logs.

Port of :mod:`wtracker_tpu.neural.dataset` (``NumpyDataset``): X = worm
bboxes at the ``input_frames`` offsets, y = worm centers at the
``pred_frames`` offsets, rows with a NaN dropped, every coordinate re-based
to the frame-0 bbox corner in float32 (the reference casts before it
re-bases).  Persistence is ``.npz``.
"""

from __future__ import annotations

import numpy as np

from wtracker_tpu_torch.neural.config import DatasetConfig
from wtracker_tpu_torch.utils import bbox as bb

WORM_COLS = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]


class NumpyDataset:
    """An (X, y) sample store for the movement predictor."""

    def __init__(self, X: np.ndarray, y: np.ndarray, config: DatasetConfig | None = None):
        self.config = config
        self.X = np.asarray(X, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32)

    def __len__(self) -> int:
        return self.X.shape[0]

    def __getitem__(self, idx):
        return self.X[idx, :], self.y[idx, :]

    def save(self, path: str) -> None:
        np.savez(path, X=self.X, y=self.y)

    @staticmethod
    def load(path: str) -> "NumpyDataset":
        data = np.load(path)
        return NumpyDataset(data["X"], data["y"])

    def split(self, train_fraction: float, seed: int = 42) -> tuple["NumpyDataset", "NumpyDataset"]:
        """Random train/test split from ``default_rng(seed)``'s permutation."""
        perm = np.random.default_rng(seed).permutation(len(self))
        n_train = int(len(self) * train_fraction)
        tr, te = perm[:n_train], perm[n_train:]
        return NumpyDataset(self.X[tr], self.y[tr], self.config), NumpyDataset(self.X[te], self.y[te], self.config)

    @staticmethod
    def create_from_config(config: DatasetConfig, save_path: str | None = None) -> "NumpyDataset":
        """Build samples from one or more log CSVs."""
        paths = config.log_path if isinstance(config.log_path, (list, tuple)) else [config.log_path]
        X_off = np.asarray(config.input_frames, dtype=int)
        y_off = np.asarray(config.pred_frames, dtype=int)

        X_parts, y_parts = [], []
        for path in paths:
            import pandas as pd  # here: the package's other modules import it only where a command reads a log

            data = pd.read_csv(path)
            wrm_boxes = data[WORM_COLS].to_numpy(dtype=np.float64)
            wrm_centers = bb.center(wrm_boxes)

            start = abs(min(config.input_frames)) + 1
            stop = len(data) - max(config.pred_frames) - 1
            if stop <= start:
                continue
            base = np.arange(start, stop)

            X = wrm_boxes[base[:, None] + X_off[None, :]].reshape(len(base), -1)
            y = wrm_centers[base[:, None] + y_off[None, :]].reshape(len(base), -1)

            keep = np.isfinite(X).all(axis=1) & np.isfinite(y).all(axis=1)
            X = X[keep].astype(np.float32)
            y = y[keep].astype(np.float32)

            # re-base everything to the frame-0 bbox corner, in float32
            x0 = X[:, 0].copy().reshape(-1, 1)
            y0 = X[:, 1].copy().reshape(-1, 1)
            y[:, 0::2] -= x0
            y[:, 1::2] -= y0
            X[:, 0::4] -= x0
            X[:, 1::4] -= y0

            X_parts.append(X)
            y_parts.append(y)

        X = np.concatenate(X_parts, axis=0) if X_parts else np.zeros((0, len(config.input_frames) * 4), np.float32)
        y = np.concatenate(y_parts, axis=0) if y_parts else np.zeros((0, len(config.pred_frames) * 2), np.float32)

        dataset = NumpyDataset(X, y, config)
        if save_path is not None:
            dataset.save(save_path)
        return dataset
