"""Ground-truth playback controller: replay worm bboxes from a logged CSV.

Port of :mod:`wtracker_tpu.sim.controllers.csv`, host side (numpy).  It is
both the replay harness and the base class of the polyfit, MLP and optimal
controllers; its engine twin is
:func:`wtracker_tpu_torch.sim.engine.csv_controller`.

* Frames outside the log give NaN boxes.
* ``relative=True`` shifts coordinates by the camera top-left held in the
  per-cycle deque at slot ``frame % cycle_frame_num`` (a slot that is not
  the queried frame's own mid-cycle; the engine reproduces the indexing).
* An unavailable prediction gives a (0, 0) move.
"""

from __future__ import annotations

from collections import deque
from typing import Collection

import numpy as np
import pandas as pd

from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.simulator import SimController, Simulator
from wtracker_tpu_torch.utils import bbox as bb

WORM_COLS = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]


class CsvController(SimController):
    """Replays worm detections from ``csv_path`` as the tracking signal."""

    def __init__(self, timing_config: TimingConfig, csv_path: str):
        super().__init__(timing_config)
        self.csv_path = csv_path
        table = pd.read_csv(csv_path, usecols=WORM_COLS)
        self._csv_data = np.column_stack([table[c].to_numpy(dtype=float) for c in WORM_COLS])
        self._camera_bboxes: deque = deque(maxlen=timing_config.cycle_frame_num)

    def on_sim_start(self, sim: Simulator) -> None:
        self._camera_bboxes.clear()

    def on_camera_frame(self, sim: Simulator) -> None:
        self._camera_bboxes.append(sim.view.camera_position)

    def begin_movement_prediction(self, sim: Simulator) -> None:
        pass

    def _camera_origin(self, frame_nums: np.ndarray) -> np.ndarray:
        """Camera top-left (x, y) per queried frame, from the cycle-slot deque."""
        slot = self.timing_config.cycle_frame_num
        rows = [self._camera_bboxes[int(n) % slot] for n in frame_nums]
        return np.asarray(rows, dtype=float)[:, :2]

    def predict(self, frame_nums: Collection[int], relative: bool = True) -> np.ndarray:
        """Worm bboxes for ``frame_nums``; NaN rows for frames outside the log.

        ``relative=True`` shifts coordinates into the camera view of the
        matching cycle slot (valid for frames of the last cycle only).
        """
        if len(frame_nums) == 0:
            raise ValueError("predict needs at least one frame")
        frames = np.asarray(frame_nums, dtype=int)

        # out-of-range gathers read row 0, then are masked to NaN
        inbounds = (frames >= 0) & (frames < len(self._csv_data))
        gathered = self._csv_data[np.where(inbounds, frames, 0)]
        boxes = np.where(inbounds[:, None], gathered, np.nan)

        if relative:
            boxes[:, :2] -= self._camera_origin(frames)
        return boxes

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        decision_frame = sim.frame_number - self.timing_config.pred_frame_num
        (bbox,) = self.predict([decision_frame])
        if not np.isfinite(bbox).all():
            return 0, 0
        offset = bb.center(bbox) - np.asarray(sim.view.camera_size, dtype=float) / 2
        return round(offset[0]), round(offset[1])

    def _cycle_predict_all(self, sim: Simulator) -> np.ndarray:
        cycle_len = self.timing_config.cycle_frame_num
        first = (sim.cycle_number - 1) * cycle_len
        frames = np.arange(first, min(first + cycle_len, len(self._csv_data)))
        return self.predict(frames)
