"""Neural movement controller driven by the port's :class:`WormPredictor`.

Port of :mod:`wtracker_tpu.sim.controllers.mlp`.

* Inputs are worm boxes at ``io_config.input_frames`` offsets from the
  prediction kickoff frame (``frame_number − pred_frame_num``).
* Coordinates are re-based to the first input box before inference; the
  features go to the predictor's device as one float32 row (the JAX
  predictor casts its input to float32 too).
* The predicted displacement is clipped to the worm's plausible speed,
  then combined with the worm's position relative to the camera centre.
* Any non-finite input gives a (0, 0) move.

Its engine twin is :func:`wtracker_tpu_torch.sim.engine.mlp_controller`.
"""

from __future__ import annotations

import numpy as np
import torch

from wtracker_tpu_torch.models.resmlp import WormPredictor
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.controllers.csv import CsvController
from wtracker_tpu_torch.sim.simulator import Simulator
from wtracker_tpu_torch.utils import bbox as bb


class MLPController(CsvController):
    """Predicts the worm's future displacement with a ResMLP.

    Args:
        timing_config: simulation timing.
        csv_path: detection log feeding the input features.
        model: a :class:`WormPredictor` (on the device it runs on).
        max_speed: max worm speed in mm/s; predictions are clipped to it.
    """

    def __init__(self, timing_config: TimingConfig, csv_path: str, model: WormPredictor, max_speed: float = 0.9):
        super().__init__(timing_config, csv_path)
        self.model = model
        self.io_config: IOConfig = model.io_config
        self._device = next(model.model.parameters()).device

        max_speed_px_frame = max_speed * (timing_config.px_per_mm / timing_config.frames_per_sec)
        self.max_dist_per_pred = max_speed_px_frame * self.io_config.pred_frames[0]

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        kickoff = sim.frame_number - self.timing_config.pred_frame_num
        sample_frames = kickoff + np.asarray(self.io_config.input_frames, dtype=int)

        boxes = self.predict(sample_frames, relative=False)
        if not np.isfinite(boxes).all():
            return 0, 0

        # anchor: the first input box's corner relative to the camera centre
        cam_center = bb.center(np.asarray(sim.view.camera_position, dtype=float))
        origin = boxes[0, :2].copy()
        anchor = origin - cam_center

        feats = boxes
        feats[:, :2] -= origin
        x = torch.from_numpy(feats.reshape(1, -1).astype(np.float32)).to(self._device)
        displacement = self.model(x).cpu().numpy().ravel()
        displacement = np.clip(displacement, -self.max_dist_per_pred, self.max_dist_per_pred)

        move = displacement[:2] + anchor
        return round(move[0].item()), round(move[1].item())
