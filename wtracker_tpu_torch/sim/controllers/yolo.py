"""Live-detection controller: YOLO worm-head detection in the closed loop.

Port of :mod:`wtracker_tpu.sim.controllers.yolo` (``YoloConfig``,
``YoloController``).

* Camera frames are buffered per cycle on the host and detected as one
  batch for the log (``_cycle_predict_all``).
* The decision uses the frame captured ``pred_frame_num`` frames earlier
  (the inference latency the reference models).
* No detection gives a NaN box and a (0, 0) move; ``max_det=1``, the
  top-scoring box only.

The detector runs in float32 on the config's device (the card by default):
each call uploads its host batch once and hands back a writable numpy copy
of the boxes, so the hooks stay in numpy and the loop syncs once a call.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Collection

import numpy as np
import torch

from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.simulator import SimController, Simulator
from wtracker_tpu_torch.utils.config_base import ConfigBase


@dataclass
class YoloConfig(ConfigBase):
    model_path: str
    """Detector weights: a Flax ``.npz`` export or an ultralytics-layout
    ``.pt`` state dict."""

    device: str = "cuda"
    verbose: bool = False

    pred_kwargs: dict = field(default_factory=lambda: {"imgsz": 384, "conf": 0.1})
    """Inference settings: image size and confidence threshold."""

    model: Any = field(default=None, init=False, repr=False)

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        state["model"] = None  # the live model never serializes
        return state

    def load_model(self):
        """Build (or return the cached) float32 detector on ``device``."""
        if self.model is None:
            from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

            self.model = YoloV8Detector.load(
                self.model_path,
                imgsz=self.pred_kwargs.get("imgsz", 384),
                conf=self.pred_kwargs.get("conf", 0.1),
                device=self.device,
            )
        return self.model


class YoloController(SimController):
    """Closes the loop with live detection on buffered camera frames."""

    def __init__(self, timing_config: TimingConfig, yolo_config: YoloConfig):
        super().__init__(timing_config)
        self.yolo_config = yolo_config
        self._camera_frames: deque = deque(maxlen=timing_config.cycle_frame_num)
        self._model = yolo_config.load_model()
        self._device = self._model.model.b1.conv.weight.device

    def on_sim_start(self, sim: Simulator) -> None:
        self._camera_frames.clear()

    def on_camera_frame(self, sim: Simulator) -> None:
        self._camera_frames.append(sim.camera_view())

    def on_cycle_end(self, sim: Simulator) -> None:
        self._camera_frames.clear()

    def predict(self, frames: Collection[np.ndarray]) -> np.ndarray:
        """The worm head in each frame: (N, 4) float32 xywh, NaN rows for
        frames without a detection."""
        if len(frames) == 0:
            raise ValueError("predict needs at least one frame")
        batch = torch.from_numpy(np.stack(list(frames), axis=0)).to(self._device)
        return self._model.detect(batch).cpu().numpy().copy()

    def begin_movement_prediction(self, sim: Simulator) -> None:
        pass

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        decision_frame = self._camera_frames[-self.timing_config.pred_frame_num]
        (bbox,) = self.predict([decision_frame])
        if not np.isfinite(bbox).all():
            return 0, 0

        offset = (bbox[:2] + bbox[2:] / 2) - np.asarray(sim.view.camera_size, dtype=float) / 2
        return round(offset[0]), round(offset[1])

    def _cycle_predict_all(self, sim: Simulator) -> np.ndarray:
        return self.predict(self._camera_frames)
