"""Particle-swarm optimization, and the polyfit weight tuner built on it.

Port of :mod:`wtracker_tpu.neural.optimize` (the reference's mealpy
``OriginalPSO`` run of polyfit_optimizer.ipynb: population 100, up to 300
epochs).  The JAX package runs with ``jax_enable_x64``, so its swarm
(positions, velocities, bests) is float64 and its random draws are float64
``jax.random.uniform``s.  The port draws the same numbers on the host with
:mod:`~wtracker_tpu_torch.utils.flax_init`'s threefry, in JAX's key order,
uploads all of a run's draws at once, and keeps the swarm on the device.

XLA fuses each velocity update's last two products into multiply-adds
(``fma(social·r2, gbest − pos, fma(inertia, vel, cognitive·r1·(pbest −
pos)))``); :func:`~wtracker_tpu_torch.utils.flax_init.fma` rounds the same
way with plain float64 ops, which gives JAX's swarm bit for bit on both
devices for an objective computed identically.  The whole population is
scored in one call of the objective: :func:`optimize_polyfit_weights` fits
every particle's weighting in one batched call of the float64
:mod:`~wtracker_tpu_torch.ops.polyfit` (``WeightEvaluator.mae``), so each
of its ~1,500 launches serves all particles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from wtracker_tpu_torch.utils import flax_init
from wtracker_tpu_torch.utils.device import resolve_device


@dataclass
class PSOResult:
    best_position: np.ndarray
    best_value: float
    history: np.ndarray
    """Best objective value after each epoch, shape (epochs,)."""


def swarm_draws(seed: int, pop_size: int, epochs: int, lo: np.ndarray, hi: np.ndarray, v_max: np.ndarray):
    """The swarm's random numbers as the JAX package draws them: initial
    positions and velocities from the halves of ``PRNGKey(seed)``, then for
    each epoch two (pop, D) uniforms from the halves of that epoch's key out
    of ``split(PRNGKey(seed + 1), epochs)``.  All float64."""
    shape = (pop_size, lo.shape[0])
    k1, k2 = flax_init.split(flax_init.key(seed))
    pos = flax_init.uniform(k1, shape, lo, hi, dtype=np.float64)
    vel = flax_init.uniform(k2, shape, -v_max, v_max, dtype=np.float64)
    r = np.empty((epochs, 2) + shape, np.float64)
    for e, k in enumerate(flax_init.split(flax_init.key(seed + 1), epochs)):
        kc, ks = flax_init.split(k)
        r[e, 0] = flax_init.uniform(kc, shape, dtype=np.float64)
        r[e, 1] = flax_init.uniform(ks, shape, dtype=np.float64)
    return pos, vel, r


def particle_swarm(
    objective: Callable[[torch.Tensor], torch.Tensor],
    bounds: tuple[np.ndarray, np.ndarray],
    pop_size: int = 100,
    epochs: int = 300,
    inertia: float = 0.4,
    cognitive: float = 2.05,
    social: float = 2.05,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PSOResult:
    """Minimize ``objective`` over a box-bounded search space.

    Args:
        objective: maps the (pop, D) float64 population to its (pop,) values.
        bounds: (lower, upper) arrays of shape (D,), taken as float32 as in
            the JAX package.
        pop_size / epochs: swarm size and iteration count.
        inertia / cognitive / social: standard PSO update coefficients.
    """
    dev = resolve_device(device)
    lo32, hi32 = np.asarray(bounds[0], np.float32), np.asarray(bounds[1], np.float32)
    v_max32 = (hi32 - lo32) * np.float32(0.5)
    pos, vel, r = (torch.from_numpy(a).to(dev) for a in swarm_draws(seed, pop_size, epochs, lo32, hi32, v_max32))
    lo, hi, v_max = (torch.from_numpy(a.astype(np.float64)).to(dev) for a in (lo32, hi32, v_max32))

    fit = objective(pos)
    pbest, pbest_val = pos, fit
    g_idx = torch.argmin(fit)
    gbest, gbest_val = pos[g_idx], fit[g_idx]

    history = []
    for e in range(epochs):
        r1, r2 = r[e, 0], r[e, 1]
        vel = flax_init.fma(social * r2, gbest[None, :] - pos, flax_init.fma(inertia, vel, (cognitive * r1) * (pbest - pos)))
        vel = torch.clamp(vel, -v_max, v_max)
        pos = torch.clamp(pos + vel, lo, hi)

        fit = objective(pos)
        improved = fit < pbest_val
        pbest = torch.where(improved[:, None], pos, pbest)
        pbest_val = torch.where(improved, fit, pbest_val)

        g_idx = torch.argmin(pbest_val)  # first minimum
        g_val = pbest_val[g_idx]
        better = g_val < gbest_val
        gbest = torch.where(better, pbest[g_idx], gbest)
        gbest_val = torch.where(better, g_val, gbest_val)
        history.append(gbest_val)

    return PSOResult(
        best_position=gbest.cpu().numpy(),
        best_value=float(gbest_val),
        history=torch.stack(history).cpu().numpy() if history else np.zeros(0),
    )


def optimize_polyfit_weights(
    evaluator,
    degree: int = 2,
    pop_size: int = 100,
    epochs: int = 300,
    weight_bounds: tuple[float, float] = (1e-6, 5.0),
    seed: int = 0,
) -> PSOResult:
    """Tune :class:`~wtracker_tpu_torch.sim.controllers.polyfit.WeightEvaluator`
    sample weights with the swarm, on the evaluator's device.  Each
    particle's weighting is scored in float32, as the JAX package scores
    one candidate."""
    n = evaluator.x_input.shape[0]
    bounds = (np.full(n, weight_bounds[0]), np.full(n, weight_bounds[1]))
    return particle_swarm(lambda w: evaluator.mae(w, degree).to(torch.float32), bounds, pop_size=pop_size,
                          epochs=epochs, seed=seed, device=evaluator.device)
