"""Polynomial-extrapolation controller, its configuration and the offline
weight evaluator.

Port of :mod:`wtracker_tpu.sim.controllers.polyfit` (the reference's
``PolyfitConfig``, ``PolyfitController``, ``WeightEvaluator``; saved JSONs
round-trip between the packages).  The controller fits a weighted
polynomial per axis to worm centres sampled at ``sample_times`` (relative
to the cycle start) and extrapolates to ``cycle_frame_num +
imaging_frame_num // 2``, the middle of the *next* imaging phase.  On the
host it calls numpy's ``polyfit``, as the JAX package's host path does; its
engine twin is :func:`wtracker_tpu_torch.sim.engine.polyfit_controller`.
:meth:`WeightEvaluator.mae` runs the port's float64
:mod:`~wtracker_tpu_torch.ops.polyfit` on its device, every sum a fixed
chain or tree of adds, so the card gives the CPU's bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import numpy.polynomial.polynomial as npoly
import pandas as pd
import torch

from wtracker_tpu_torch.ops.polyfit import _sum0, polyfit, polyvander
from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.controllers.csv import WORM_COLS, CsvController
from wtracker_tpu_torch.sim.simulator import Simulator
from wtracker_tpu_torch.utils import bbox as bb
from wtracker_tpu_torch.utils.config_base import ConfigBase
from wtracker_tpu_torch.utils.device import resolve_device


@dataclass
class PolyfitConfig(ConfigBase):
    """Fit recipe: polynomial degree + sample grid + per-sample weights.

    ``sample_times`` are frames relative to the cycle start (negatives reach
    into previous cycles) and are kept sorted; the weights keep the order
    they were given in; omitted weights mean uniform.
    """

    degree: int
    sample_times: list[int]
    weights: list[float] = None

    def __post_init__(self):
        self.sample_times = sorted(self.sample_times)
        if self.weights is None:
            self.weights = [1.0] * len(self.sample_times)
        if len(self.weights) != len(self.sample_times):
            raise ValueError(f"{len(self.weights)} weights for {len(self.sample_times)} sample times")


class PolyfitController(CsvController):
    """Extrapolates the worm centre with a weighted polynomial fit."""

    def __init__(self, timing_config: TimingConfig, polyfit_config: PolyfitConfig, csv_path: str) -> None:
        super().__init__(timing_config, csv_path)
        self.polyfit_config = polyfit_config
        self._sample_times = np.asarray(polyfit_config.sample_times, dtype=int)
        self._weights = np.asarray(polyfit_config.weights, dtype=float)

    def _sampled_track(self, sim: Simulator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(times, centres, weights) of the finite samples for this cycle,
        centres shifted into the current camera view."""
        query = sim.cycle_number * self.timing_config.cycle_frame_num + self._sample_times
        boxes = self.predict(query, relative=False)
        boxes[:, :2] -= np.asarray(sim.view.camera_position[:2])

        centers = bb.center(boxes)
        ok = np.isfinite(centers).all(axis=1)
        return self._sample_times[ok], centers[ok], self._weights[ok]

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        timing = self.timing_config
        times, centers, weights = self._sampled_track(sim)
        if times.size == 0:
            return 0, 0

        horizon = timing.cycle_frame_num + timing.imaging_frame_num // 2
        coeffs = npoly.polyfit(times, centers, deg=self.polyfit_config.degree, w=weights)
        future = npoly.polyval(horizon, coeffs)

        half_cam = np.asarray(sim.view.camera_size, dtype=float) / 2
        return round(future[0] - half_cam[0]), round(future[1] - half_cam[1])


def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving: zero-padded to a power of two, then
    ``v[..., :h] + v[..., h:]`` until one element is left.  Elementwise adds
    only, so the order (and the float64 result) is the same on every
    device."""
    n = 1 << max(v.shape[-1] - 1, 0).bit_length()
    v = torch.cat([v, v.new_zeros((*v.shape[:-1], n - v.shape[-1]))], dim=-1)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


class WeightEvaluator:
    """Mean-absolute-error objective for tuning polyfit sample weights.

    Builds (input positions, target position) pairs for every cycle of the
    given logs, filtered by validity and a speed band, then evaluates a
    candidate weight vector with one batched fit on ``device``.

    Args:
        csv_paths: logs holding the worm trajectory.
        timing_config: timing configuration of the simulation.
        input_time_offsets: sample times relative to each cycle start.
        pred_time_offset: target time relative to each cycle start.
        min_speed / max_speed: average-speed band for cycles to count.
        device: torch device of :meth:`eval` (default: cuda).
    """

    def __init__(
        self,
        csv_paths: list[str],
        timing_config: TimingConfig,
        input_time_offsets: np.ndarray,
        pred_time_offset: int,
        min_speed: float = 0,
        max_speed: float = np.inf,
        device: str | torch.device = "cuda",
    ):
        self.csv_paths = list(csv_paths)
        self.timing_config = timing_config
        self.input_time_offsets = np.sort(input_time_offsets)
        self.pred_time_offset = pred_time_offset
        self.min_speed = min_speed
        self.max_speed = max_speed
        self.device = resolve_device(device)

        per_log = [self._load_log_pairs(i, p) for i, p in enumerate(self.csv_paths)]
        self.x_input = self.input_time_offsets.reshape(-1)
        self.y_input = np.concatenate([inp for inp, _ in per_log], axis=1)
        self.y_target = np.concatenate([tgt for _, tgt in per_log], axis=0)
        self.x_target = np.full_like(self.y_target, self.pred_time_offset)
        self._dev = {
            name: torch.as_tensor(np.asarray(getattr(self, name), dtype=np.float64), device=self.device)
            for name in ("x_input", "y_input", "y_target", "x_target")
        }
        self._dev["count"] = torch.tensor(float(self.y_target.shape[0]), dtype=torch.float64, device=self.device)

    def _load_log_pairs(self, log_idx: int, path: str) -> tuple[np.ndarray, np.ndarray]:
        """One log's (inputs, target) pairs, reporting how much of it
        survived the validity and speed filters."""
        cycle_len = self.timing_config.cycle_frame_num
        track = pd.read_csv(path, usecols=WORM_COLS)[WORM_COLS].to_numpy(dtype=float)
        inp, tgt = self._extract_positions(track, cycle_len)

        total = len(track) // cycle_len
        kept = len(tgt) // 2
        pct = round((total - kept) / total * 100, 1) if total else 0.0
        print(f"Log {log_idx} :: Number of evaluation cycles: {kept}")
        print(f"Log {log_idx} :: Number of cycles removed: {total - kept} ({pct} %)")
        return inp, tgt

    def _extract_positions(self, raw_bboxes: np.ndarray, cycle_length: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-cycle (inputs, target) centre positions, filtered for validity
        and speed: ``y_input`` (N, 2·n_cycles), each kept cycle's x and y
        side by side, and ``y_target`` (2·n_cycles,)."""
        n_inputs = self.input_time_offsets.shape[0]
        centers = bb.center(raw_bboxes)

        cycle_starts = np.arange(0, raw_bboxes.shape[0], cycle_length, dtype=int)
        t_input = cycle_starts[:, None] + self.input_time_offsets[None, :]
        t_target = cycle_starts + self.pred_time_offset

        ok = (t_input >= 0).all(axis=1) & (t_target < len(centers))
        t_input, t_target = t_input[ok], t_target[ok]

        y_input = centers[t_input.reshape(-1), :].reshape(-1, n_inputs, 2)
        y_target = centers[t_target, :]

        finite = np.isfinite(y_input).all(axis=(1, 2)) & np.isfinite(y_target).all(axis=1)
        y_input, y_target = y_input[finite], y_target[finite]

        # speed band: average speed from the first input sample to the target
        dist = np.linalg.norm(y_target - y_input[:, 0, :], axis=1)
        time = self.pred_time_offset - self.input_time_offsets[0]
        speed = dist / time
        keep = (speed >= self.min_speed) & (speed <= self.max_speed)
        y_input, y_target = y_input[keep], y_target[keep]

        return y_input.swapaxes(0, 1).reshape(n_inputs, -1), y_target.reshape(-1)

    @torch.no_grad()
    def mae(self, weights, deg: int = 2) -> torch.Tensor:
        """MAE of the weighted polynomial fit over the whole dataset, for P
        weight vectors at once: ``weights`` (P, N) → float64 (P,) on the
        evaluator's device.

        Each of the M columns of ``y_input`` gets its own polynomial over
        the shared sample times, evaluated at its own target time.  One
        batched fit serves all P vectors (the particle swarm's population).
        """
        d = self._dev
        w = torch.as_tensor(weights, dtype=torch.float64, device=self.device)
        coeffs = polyfit(d["x_input"], d["y_input"], deg, w=w)  # (P, deg+1, M)
        van = polyvander(d["x_target"], deg)  # (M, deg+1)
        y_pred = _sum0((van.T * coeffs).movedim(-2, 0))  # (P, M)
        # a tensor divides correctly rounded on every device; a Python number
        # would be a product with its reciprocal on the card, an ulp off
        return _tree_sum(torch.abs(d["y_target"] - y_pred)) / d["count"]

    def eval(self, weights: np.ndarray, deg: int = 2) -> float:
        """MAE of the weighted polynomial fit for one (N,) weight vector."""
        return float(self.mae(np.asarray(weights, dtype=np.float64)[None], deg)[0])
