"""Platform motor models: how a registered (dx, dy) move is spread over frames.

Port of :mod:`wtracker_tpu.sim.motor`.  The sine motor emits per-step
displacements ``(cos(iπ/n) − cos((i+1)π/n))/2 · d`` rounded to integer
pixels, carrying the rounding residual into the next step; the step motor
moves the whole distance on one step.  The host classes
(:class:`SineMotorController`, :class:`StepMotorController`) drive the
hook-based simulator; :func:`integer_motor_steps` is the same rounding chain
on tensors, as the replay engine (:mod:`wtracker_tpu_torch.sim.engine`) does
it, all in float64.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from wtracker_tpu_torch.sim.config import TimingConfig


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


def integer_motor_steps(weights, d) -> torch.Tensor:
    """Residual-carrying integer rounding of a weighted move.

    ``weights``: the ``n`` float64 step weights; ``d``: a displacement
    (number or tensor, any shape).  Returns the int32 per-step displacements,
    shape ``(n, *d.shape)``: step ``i`` is ``round(w_i·d + r)`` with ``r``
    the previous step's residual, half to even, in float64.
    """
    d = torch.as_tensor(d, dtype=torch.float64)
    resid = torch.zeros_like(d)
    steps = []
    for w in np.asarray(weights, dtype=np.float64):
        raw = float(w) * d + resid
        s = torch.round(raw)
        resid = raw - s
        steps.append(s.to(torch.int32))
    return torch.stack(steps, dim=0)


class MotorController(abc.ABC):
    """Spreads one registered move across the moving phase, one step per frame."""

    def __init__(self, timing_config: TimingConfig):
        self.timing_config = timing_config
        self.movement_steps = timing_config.moving_frame_num

    @abc.abstractmethod
    def register_move(self, dx: int, dy: int) -> None:
        """Queue a full (dx, dy) move to be emitted over the coming steps."""

    @abc.abstractmethod
    def step(self) -> tuple[int, int]:
        """Pop the next per-frame integer displacement."""


class StepMotorController(MotorController):
    """Move the entire distance at once, after ``move_after_ratio`` of the phase."""

    def __init__(self, timing_config: TimingConfig, move_after_ratio: float = 0.5):
        if not 0 <= move_after_ratio <= 1:
            raise ValueError(f"move_after_ratio {move_after_ratio} is not in [0, 1]")
        super().__init__(timing_config)
        self.queue: list[tuple[int, int]] = []
        self.move_at_step = round(self.movement_steps * move_after_ratio)

    def register_move(self, dx: int, dy: int) -> None:
        steps = [(0, 0)] * (self.movement_steps - 1)
        steps.insert(self.move_at_step, (dx, dy))
        self.queue.extend(steps)

    def step(self) -> tuple[int, int]:
        return self.queue.pop(0)


class SineMotorController(MotorController):
    """Half-cosine velocity profile with residual-carrying integer rounding
    (the simulator's default motor)."""

    def __init__(self, timing_config: TimingConfig):
        super().__init__(timing_config)
        self.queue: list[tuple[int, int]] = []

    def register_move(self, dx: int, dy: int) -> None:
        if self.queue:
            raise RuntimeError("a move was registered before the previous one finished")
        steps = integer_motor_steps(sine_step_weights(self.movement_steps), (dx, dy))
        self.queue.extend(tuple(s) for s in steps.tolist())

    def step(self) -> tuple[int, int]:
        return self.queue.pop(0)
