"""Synthetic worm trajectories (host numpy).

Port of :func:`wtracker_tpu.sim.synthetic.make_trajectory`; the on-device
renderer of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np


def make_trajectory(
    num_frames: int,
    arena_hw: tuple[int, int],
    seed: int = 0,
    speed: float = 0.9,
    drift: float = 0.25,
    margin: int = 40,
) -> np.ndarray:
    """A smooth random-walk worm trajectory, (F, 2) float64 (x, y)."""
    rng = np.random.default_rng(seed)
    h, w = arena_hw
    steps = rng.normal(0, speed, size=(num_frames - 1, 2)) + drift
    # smooth with a running average for worm-like motion
    kernel = np.ones(15) / 15
    steps[:, 0] = np.convolve(steps[:, 0], kernel, mode="same")
    steps[:, 1] = np.convolve(steps[:, 1], kernel, mode="same")
    pos = np.concatenate([[[w / 2, h / 2]], steps]).cumsum(axis=0)
    pos[:, 0] = margin + np.abs(pos[:, 0] - margin) % (2 * (w - 2 * margin)) % (w - 2 * margin)
    pos[:, 1] = margin + np.abs(pos[:, 1] - margin) % (2 * (h - 2 * margin)) % (h - 2 * margin)
    return pos
