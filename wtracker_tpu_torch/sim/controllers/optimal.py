"""Oracle controller: move to the median ground-truth position of the next
imaging phase.

Port of :mod:`wtracker_tpu.sim.controllers.optimal`.  It reads the *future*
trajectory, so its error is the floor every real controller is measured
against.
"""

from __future__ import annotations

import numpy as np

from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.controllers.csv import CsvController
from wtracker_tpu_torch.sim.simulator import Simulator


class OptimalController(CsvController):
    """Centres the camera on the median future worm position."""

    def __init__(self, timing_config: TimingConfig, csv_path: str):
        super().__init__(timing_config, csv_path)
        self._csv_centers = self._csv_data[:, :2] + self._csv_data[:, 2:] / 2

    def _future_imaging_centers(self, cycle: int) -> np.ndarray:
        """Finite worm centres over the *next* cycle's imaging phase."""
        lo = (cycle + 1) * self.timing_config.cycle_frame_num
        window = self._csv_centers[lo : lo + self.timing_config.imaging_frame_num]
        return window[np.isfinite(window).all(axis=1)]

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        ahead = self._future_imaging_centers(sim.cycle_number)
        if ahead.shape[0] == 0:
            return 0, 0
        target = np.median(ahead, axis=0)

        cam = np.asarray(sim.view.camera_position, dtype=float)
        move = target - (cam[:2] + cam[2:] / 2)
        return round(move[0]), round(move[1])
