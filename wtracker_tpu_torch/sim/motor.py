"""Platform motor profiles: how a registered (dx, dy) move is spread over frames.

Port of :func:`wtracker_tpu.sim.motor.sine_step_weights` and
:func:`~wtracker_tpu.sim.motor.step_weights`.  The sine motor emits per-step
displacements ``(cos(iπ/n) − cos((i+1)π/n))/2 · d`` rounded to integer
pixels, carrying the rounding residual into the next step (the engine,
:mod:`wtracker_tpu_torch.sim.engine`, does the rounding in float64); the
step motor moves the whole distance on one step.
"""

from __future__ import annotations

import numpy as np


def sine_step_weights(n_steps: int) -> np.ndarray:
    """Half-cosine velocity-profile weights; sum to exactly 1 (telescoping).

    The same float64 expression as the reference motor, so integer rounding
    decisions match bit for bit.
    """
    i = np.arange(n_steps, dtype=np.float64)
    return (np.cos(i * np.pi / n_steps) - np.cos((i + 1) * np.pi / n_steps)) / 2


def step_weights(n_steps: int, move_after_ratio: float = 0.5) -> np.ndarray:
    """All-at-once profile: the whole move lands on step
    ``round(n_steps · move_after_ratio)``."""
    w = np.zeros(n_steps, dtype=np.float64)
    w[round(n_steps * move_after_ratio)] = 1.0
    return w
