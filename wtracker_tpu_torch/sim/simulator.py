"""The closed-loop microscope-platform simulator: host event loop and hook ABC.

Port of :mod:`wtracker_tpu.sim.simulator` (the reference's own closed loop).
The per-frame hook schedule is the JAX package's:

* cycle start: ``on_movement_end``/``on_cycle_end`` (cycles > 0), then
  ``on_cycle_start``;
* every frame: ``on_camera_frame``;
* ``cycle_step == 0``: ``on_imaging_start``;
* ``cycle_step < imaging_frame_num``: ``on_micro_frame``;
* ``cycle_step == imaging_frame_num − pred_frame_num``:
  ``begin_movement_prediction``;
* ``cycle_step == imaging_frame_num``: ``on_imaging_end``, the controller's
  ``provide_movement_vector``, ``on_movement_start``, the motor's move;
* moving phase: one motor step per frame applied to the view position.

The schedule is data: :meth:`Simulator._compile_schedule` builds it once as
a per-cycle-step event table and :meth:`Simulator.run` dispatches over it.
The hooks run on the host; only a controller's detector or predictor touches
the card, once a decision.
"""

from __future__ import annotations

import abc
from typing import Callable

import numpy as np

from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.motor import MotorController, SineMotorController
from wtracker_tpu_torch.sim.view import ViewController
from wtracker_tpu_torch.utils.frame_reader import DummyReader, FrameReader


class Simulator:
    """Drives the frame-by-frame closed loop and dispatches controller hooks.

    Args:
        timing_config: cycle timing / view sizes.
        experiment_config: per-experiment parameters.
        sim_controller: the tracking controller under simulation.
        reader: frame source; ``None`` (headless) uses white dummy frames at
            the padded resolution, so the view geometry is unchanged.
        motor_controller: platform motor; the sine motor by default.
    """

    def __init__(
        self,
        timing_config: TimingConfig,
        experiment_config: ExperimentConfig,
        sim_controller: "SimController",
        reader: FrameReader | None = None,
        motor_controller: MotorController | None = None,
    ) -> None:
        self.timing_config = timing_config
        self.experiment_config = experiment_config
        self._sim_controller = sim_controller
        self._motor = motor_controller or SineMotorController(timing_config)
        self._view = ViewController(
            frame_reader=reader if reader is not None else self._headless_reader(),
            camera_size=timing_config.camera_size_px,
            micro_size=timing_config.micro_size_px,
            init_position=experiment_config.init_position,
        )
        self._schedule = self._compile_schedule()

    def _headless_reader(self) -> DummyReader:
        """White constant frames at the world (camera-padded) resolution."""
        cam_w, cam_h = self.timing_config.camera_size_px
        orig_w, orig_h = self.experiment_config.orig_resolution
        world = (orig_w + cam_w // 2 * 2, orig_h + cam_h // 2 * 2)
        return DummyReader(self.experiment_config.num_frames, world, colored=True)

    @property
    def view(self) -> ViewController:
        return self._view

    @property
    def position(self) -> tuple[int, int]:
        """Current platform-centre position (x, y)."""
        return self._view.position

    @property
    def frame_number(self) -> int:
        return self._view.index

    @property
    def cycle_number(self) -> int:
        return self._view.index // self.timing_config.cycle_frame_num

    @property
    def cycle_step(self) -> int:
        """Frame index within the current cycle (0-based)."""
        return self._view.index % self.timing_config.cycle_frame_num

    def camera_view(self) -> np.ndarray:
        return self._view.camera_view()

    def micro_view(self) -> np.ndarray:
        return self._view.micro_view()

    def _compile_schedule(self) -> tuple[tuple[Callable, ...], ...]:
        """The per-cycle-step event table: entry ``k`` holds the zero-argument
        callables to fire, in order, on a frame whose cycle step is ``k``."""
        t = self.timing_config
        ctl = self._sim_controller

        def hook(fn):
            return lambda: fn(self)

        table: list[tuple[Callable, ...]] = []
        for k in range(t.cycle_frame_num):
            events: list[Callable] = []
            if k == 0:
                events.append(self._wrap_cycle)
            events.append(hook(ctl.on_camera_frame))
            if k == 0:
                events.append(hook(ctl.on_imaging_start))
            if k < t.imaging_frame_num:
                events.append(hook(ctl.on_micro_frame))
            if k == t.imaging_frame_num - t.pred_frame_num:
                events.append(hook(ctl.begin_movement_prediction))
            if k == t.imaging_frame_num:
                events.append(hook(ctl.on_imaging_end))
                events.append(self._decide_move)
            if t.imaging_frame_num <= k < t.imaging_frame_num + t.moving_frame_num:
                events.append(self._step_platform)
            table.append(tuple(events))
        return tuple(table)

    def _wrap_cycle(self) -> None:
        """Close the previous cycle (if any) and open the next one."""
        if self.cycle_number > 0:
            self._sim_controller.on_movement_end(self)
            self._sim_controller.on_cycle_end(self)
        self._sim_controller.on_cycle_start(self)

    def _decide_move(self) -> None:
        """The decision point: query the controller, arm the motor."""
        dx, dy = self._sim_controller.provide_movement_vector(self)
        self._sim_controller.on_movement_start(self)
        self._motor.register_move(dx, dy)

    def _step_platform(self) -> None:
        """One moving-phase frame: advance the platform by the motor's step."""
        self._view.move_position(*self._motor.step())

    def run(self, visualize: bool = False, wait_key: bool = False, progress: bool = False) -> None:
        """Run the full simulation (all frames of the experiment).

        ``progress=True`` shows a tqdm bar (the JAX package shows one by
        default; here it is off by default, since tqdm is optional)."""
        cycle_n = self.timing_config.cycle_frame_num
        last_step = cycle_n - 1

        self._view.reset()
        self._view.set_position(*self.experiment_config.init_position)

        pbar = None
        if progress:
            from tqdm.auto import tqdm

            pbar = tqdm(total=len(self._view) // cycle_n, desc="Simulation Progress", unit="cycle")
        self._sim_controller.on_sim_start(self)
        while self._view.progress():
            step = self.cycle_step
            for event in self._schedule[step]:
                event()
            if pbar is not None and step == last_step:
                pbar.update(1)
            if visualize:
                self._view.visualize_world(timeout=0 if wait_key else 1)
        self._sim_controller.on_sim_end(self)
        if pbar is not None:
            pbar.close()


class SimController(abc.ABC):
    """Lifecycle-hook interface for tracking controllers.

    Subclasses implement the three abstract decision methods; the other
    hooks default to no-ops.  See the module docstring for the schedule.
    """

    def __init__(self, timing_config: TimingConfig):
        self.timing_config = timing_config

    def on_sim_start(self, sim: Simulator) -> None:
        """Called once before the first frame."""

    def on_sim_end(self, sim: Simulator) -> None:
        """Called once after the last frame."""

    def on_cycle_start(self, sim: Simulator) -> None:
        """Called at the first frame of every cycle."""

    def on_cycle_end(self, sim: Simulator) -> None:
        """Called when a cycle ends (before the next one starts)."""

    def on_camera_frame(self, sim: Simulator) -> None:
        """Called on every frame."""

    def on_imaging_start(self, sim: Simulator) -> None:
        """Called when the imaging phase starts."""

    def on_micro_frame(self, sim: Simulator) -> None:
        """Called on every frame of the imaging phase."""

    def on_imaging_end(self, sim: Simulator) -> None:
        """Called when the imaging phase ends."""

    def on_movement_start(self, sim: Simulator) -> None:
        """Called when the movement phase starts."""

    def on_movement_end(self, sim: Simulator) -> None:
        """Called when the movement phase ends."""

    @abc.abstractmethod
    def begin_movement_prediction(self, sim: Simulator) -> None:
        """Start the movement prediction (``pred_frame_num`` frames early)."""

    @abc.abstractmethod
    def provide_movement_vector(self, sim: Simulator) -> tuple[int, int]:
        """The (dx, dy) platform move decided for this cycle."""

    @abc.abstractmethod
    def _cycle_predict_all(self, sim: Simulator) -> np.ndarray:
        """Worm-bbox predictions for every frame of the cycle just finished:
        shape (cycle_frame_num, 4), NaN rows where there is none.  Read by
        the logging wrapper."""
