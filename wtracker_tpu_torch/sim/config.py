"""Experiment and timing configuration for the closed-loop simulation.

Port of :mod:`wtracker_tpu.sim.config`.  The invariants the persisted JSON
and every derived frame count depend on are kept:

* ms→frame quantization uses ``ceil``;
* mm→px conversion uses ``round``;
* ``cycle_frame_num = imaging_frame_num + moving_frame_num``;
* ``TimingConfig`` drops its ``experiment_config`` field after
  ``__post_init__`` so the persisted JSON matches the reference schema.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from wtracker_tpu_torch.utils.config_base import ConfigBase


@dataclass
class ExperimentConfig(ConfigBase):
    """Parameters that vary per recorded experiment."""

    name: str
    """Experiment name."""

    num_frames: int
    """Total number of frames in the experiment."""

    frames_per_sec: float
    """Recording frame rate."""

    orig_resolution: tuple[int, int]
    """Original frame resolution in pixels, (h, w)."""

    px_per_mm: float
    """Pixels per millimeter of the optics."""

    init_position: tuple[int, int]
    """Initial platform-center position in pixels, (x, y)."""

    comments: str = ""

    mm_per_px: float = field(init=False)
    ms_per_frame: float = field(init=False)

    def __post_init__(self):
        self.ms_per_frame = 1000 / self.frames_per_sec
        self.mm_per_px = 1 / self.px_per_mm

    @classmethod
    def from_frame_reader(
        cls,
        reader,
        name: str,
        frames_per_sec: int,
        px_per_mm: float,
        init_position: tuple[int, int],
    ) -> "ExperimentConfig":
        """Derive the frame count and resolution fields from a frame reader."""
        return cls(
            name=name,
            num_frames=len(reader),
            frames_per_sec=frames_per_sec,
            orig_resolution=reader.frame_size,
            px_per_mm=px_per_mm,
            init_position=init_position,
        )


@dataclass
class TimingConfig(ConfigBase):
    """Cycle timing and view-size parameters (stable across experiments).

    Time is given in milliseconds and quantized to whole frames; view sizes are
    given in millimeters and quantized to whole pixels.
    """

    experiment_config: ExperimentConfig = field(repr=False)
    """Consumed during construction only; deleted afterwards (see module doc)."""

    px_per_mm: int = field(init=False)
    mm_per_px: float = field(init=False)

    frames_per_sec: int = field(init=False)
    ms_per_frame: float = field(init=False)

    imaging_time_ms: float = 0.0
    imaging_frame_num: int = field(init=False)

    pred_time_ms: float = 0.0
    pred_frame_num: int = field(init=False)

    moving_time_ms: float = 0.0
    moving_frame_num: int = field(init=False)

    camera_size_mm: tuple[float, float] = (4.0, 4.0)
    camera_size_px: tuple[int, int] = field(init=False)

    micro_size_mm: tuple[float, float] = (0.32, 0.32)
    micro_size_px: tuple[int, int] = field(init=False)

    def __post_init__(self):
        exp = self.experiment_config
        self.frames_per_sec = exp.frames_per_sec
        self.ms_per_frame = exp.ms_per_frame

        self.imaging_frame_num = math.ceil(self.imaging_time_ms / self.ms_per_frame)
        self.pred_frame_num = math.ceil(self.pred_time_ms / self.ms_per_frame)
        self.moving_frame_num = math.ceil(self.moving_time_ms / self.ms_per_frame)

        self.mm_per_px = exp.mm_per_px
        self.px_per_mm = exp.px_per_mm

        self.camera_size_px = (
            round(self.px_per_mm * self.camera_size_mm[0]),
            round(self.px_per_mm * self.camera_size_mm[1]),
        )
        self.micro_size_px = (
            round(self.px_per_mm * self.micro_size_mm[0]),
            round(self.px_per_mm * self.micro_size_mm[1]),
        )

        # temporary constructor argument only: keep the persisted field set
        # identical to the reference schema
        del self.experiment_config

    @property
    def cycle_frame_num(self) -> int:
        """Frames per full cycle (imaging + moving phases)."""
        return self.imaging_frame_num + self.moving_frame_num

    @property
    def cycle_time_ms(self) -> float:
        return self.cycle_frame_num * self.ms_per_frame
