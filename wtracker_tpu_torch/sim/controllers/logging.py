"""Logging wrapper: the 17-column per-frame ``bboxes.csv`` and image dumps.

Port of :mod:`wtracker_tpu.sim.controllers.logging` (``LogConfig``,
``LoggingController``).  The CSV schema (frame, cycle, phase, plt_*, cam_*,
mic_*, wrm_*) is what every evaluation tool reads.  Kept from the JAX
package:

* per-frame positions and boxes are buffered during the cycle and written
  at the *next* cycle's start, so the final, possibly partial cycle is
  never logged;
* worm boxes come from the wrapped controller's ``_cycle_predict_all`` and
  are made absolute by adding the camera box's origin;
* a frame without a prediction logs a 0.0 box (the reference's
  ``discretize`` zeroes such rows in place), so the no-prediction error
  dump never fires; legal worm crops can go to ``worms/``.

Images are written by the async savers (OpenCV, imported only when an image
is written).
"""

from __future__ import annotations

from collections import deque
from copy import deepcopy
from dataclasses import dataclass, field

import numpy as np

from wtracker_tpu_torch.sim.simulator import SimController, Simulator
from wtracker_tpu_torch.utils import bbox as bb
from wtracker_tpu_torch.utils.bbox import BoxFormat
from wtracker_tpu_torch.utils.config_base import ConfigBase
from wtracker_tpu_torch.utils.io_utils import FrameSaver, ImageSaver
from wtracker_tpu_torch.utils.log_utils import CSVLogger
from wtracker_tpu_torch.utils.path_utils import create_parent_directory, join_paths

LOG_COLUMNS = [
    "frame",
    "cycle",
    "phase",
    "plt_x",
    "plt_y",
    "cam_x",
    "cam_y",
    "cam_w",
    "cam_h",
    "mic_x",
    "mic_y",
    "mic_w",
    "mic_h",
    "wrm_x",
    "wrm_y",
    "wrm_w",
    "wrm_h",
]


@dataclass
class LogConfig(ConfigBase):
    root_folder: str
    """Directory the logs are written into."""

    save_mic_view: bool = False
    save_cam_view: bool = False
    save_err_view: bool = True
    """Save camera views of frames in which no prediction was made."""
    save_wrm_view: bool = False
    """Save the detected worm-head crop of each frame."""

    mic_folder_name: str = "micro"
    cam_folder_name: str = "camera"
    err_folder_name: str = "errors"
    wrm_folder_name: str = "worms"

    bbox_file_name: str = "bboxes.csv"
    mic_file_name: str = "mic_{:09d}.png"
    cam_file_name: str = "cam_{:09d}.png"
    wrm_file_name: str = "wrm_{:09d}.png"

    mic_file_path: str = field(init=False)
    cam_file_path: str = field(init=False)
    err_file_path: str = field(init=False)
    wrm_file_path: str = field(init=False)
    bbox_file_path: str = field(init=False)

    def __post_init__(self):
        self.mic_file_path = join_paths(self.root_folder, self.mic_folder_name, self.mic_file_name)
        self.cam_file_path = join_paths(self.root_folder, self.cam_folder_name, self.cam_file_name)
        self.err_file_path = join_paths(self.root_folder, self.err_folder_name, self.cam_file_name)
        self.wrm_file_path = join_paths(self.root_folder, self.wrm_folder_name, self.wrm_file_name)
        self.bbox_file_path = join_paths(self.root_folder, self.bbox_file_name)

    def create_dirs(self) -> None:
        for path in (
            self.bbox_file_path,
            self.mic_file_path,
            self.cam_file_path,
            self.err_file_path,
            self.wrm_file_path,
        ):
            create_parent_directory(path)


class LoggingController(SimController):
    """Wraps any controller, delegating every hook while logging every frame."""

    def __init__(self, sim_controller: SimController, log_config: LogConfig):
        super().__init__(sim_controller.timing_config)
        self.sim_controller = sim_controller
        self.log_config = log_config

        maxlen = self.timing_config.cycle_frame_num
        self._camera_frames: deque = deque(maxlen=maxlen)
        self._platform_positions: deque = deque(maxlen=maxlen)
        self._camera_bboxes: deque = deque(maxlen=maxlen)
        self._micro_bboxes: deque = deque(maxlen=maxlen)

    def _clear_buffers(self) -> None:
        self._camera_frames.clear()
        self._platform_positions.clear()
        self._camera_bboxes.clear()
        self._micro_bboxes.clear()

    def on_sim_start(self, sim: Simulator) -> None:
        self.sim_controller.on_sim_start(sim)
        self._clear_buffers()
        self.log_config.create_dirs()

        self._image_saver = ImageSaver(tqdm=False)
        self._image_saver.start()
        self._frame_saver = FrameSaver(deepcopy(sim.view._frame_reader), tqdm=False)
        self._frame_saver.start()
        self._bbox_logger = CSVLogger(self.log_config.bbox_file_path, col_names=LOG_COLUMNS)

    def on_camera_frame(self, sim: Simulator) -> None:
        self.sim_controller.on_camera_frame(sim)

        self._platform_positions.append(sim.position)
        self._camera_bboxes.append(sim.view.camera_position)
        self._micro_bboxes.append(sim.view.micro_position)

        if self.log_config.save_err_view:
            self._camera_frames.append(sim.camera_view())

        if self.log_config.save_cam_view:
            path = self.log_config.cam_file_path.format(sim.frame_number)
            self._image_saver.schedule_save(sim.camera_view(), path)

        if self.log_config.save_mic_view:
            path = self.log_config.mic_file_path.format(sim.frame_number)
            self._image_saver.schedule_save(sim.view.micro_view(), path)

    def _log_cycle(self, sim: Simulator) -> None:
        cycle_number = sim.cycle_number - 1
        frame_offset = cycle_number * self.timing_config.cycle_frame_num

        worm_bboxes = self.sim_controller._cycle_predict_all(sim)
        cam_bboxes = np.asarray(list(self._camera_bboxes), dtype=float)

        # worm boxes arrive camera-relative; make them absolute (in place:
        # the array keeps the dtype the controller gave it)
        worm_bboxes[:, 0] += cam_bboxes[:, 0]
        worm_bboxes[:, 1] += cam_bboxes[:, 1]

        H, W = sim.experiment_config.orig_resolution
        crop_dims, is_crop_legal = bb.discretize(worm_bboxes, (H, W), BoxFormat.XYWH)

        # frames without a prediction log 0.0 (the reference's discretize
        # zeroes non-finite rows of the caller's array in place), so the
        # error dump below never fires, as in the reference
        worm_bboxes = np.where(np.isfinite(worm_bboxes).all(axis=1, keepdims=True), worm_bboxes, 0.0)

        rows = []
        for i, worm_bbox in enumerate(worm_bboxes):
            frame_number = frame_offset + i

            if self.log_config.save_err_view and not np.isfinite(worm_bbox).all():
                path = self.log_config.err_file_path.format(frame_number)
                self._image_saver.schedule_save(self._camera_frames[i], path)

            if self.log_config.save_wrm_view and is_crop_legal[i]:
                path = self.log_config.wrm_file_path.format(frame_number)
                self._frame_saver.schedule_save(frame_number, tuple(crop_dims[i]), path)

            row = {
                "frame": frame_number,
                "cycle": cycle_number,
                "phase": "imaging" if i < self.timing_config.imaging_frame_num else "moving",
            }
            row["plt_x"], row["plt_y"] = self._platform_positions[i]
            row["cam_x"], row["cam_y"], row["cam_w"], row["cam_h"] = self._camera_bboxes[i]
            row["mic_x"], row["mic_y"], row["mic_w"], row["mic_h"] = self._micro_bboxes[i]
            row["wrm_x"], row["wrm_y"], row["wrm_w"], row["wrm_h"] = worm_bbox
            rows.append(row)

        self._bbox_logger.writerows(rows)
        self._bbox_logger.flush()

    def on_cycle_end(self, sim: Simulator) -> None:
        self._log_cycle(sim)
        self.sim_controller.on_cycle_end(sim)
        self._clear_buffers()

    def on_sim_end(self, sim: Simulator) -> None:
        self.sim_controller.on_sim_end(sim)
        self._image_saver.close()
        self._frame_saver.close()
        self._bbox_logger.close()

    def on_cycle_start(self, sim: Simulator) -> None:
        self.sim_controller.on_cycle_start(sim)

    def on_imaging_start(self, sim: Simulator) -> None:
        self.sim_controller.on_imaging_start(sim)

    def on_micro_frame(self, sim: Simulator) -> None:
        self.sim_controller.on_micro_frame(sim)

    def on_imaging_end(self, sim: Simulator) -> None:
        self.sim_controller.on_imaging_end(sim)

    def on_movement_start(self, sim: Simulator) -> None:
        self.sim_controller.on_movement_start(sim)

    def on_movement_end(self, sim: Simulator) -> None:
        self.sim_controller.on_movement_end(sim)

    def begin_movement_prediction(self, sim: Simulator) -> None:
        return self.sim_controller.begin_movement_prediction(sim)

    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        return self.sim_controller.provide_movement_vector(sim)

    def _cycle_predict_all(self, sim: Simulator) -> np.ndarray:
        return self.sim_controller._cycle_predict_all(sim)
