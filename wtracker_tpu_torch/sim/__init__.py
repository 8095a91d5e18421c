"""Closed-loop simulation: configs, motor, cycle engine, live video loop."""

from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.motor import MotorController, SineMotorController, StepMotorController
from wtracker_tpu_torch.sim.simulator import SimController, Simulator
from wtracker_tpu_torch.sim.view import ViewController

from wtracker_tpu_torch.sim.engine_hetero import (
    StreamGeometry,
    csv_controller_hetero,
    geometry_from_configs,
    pad_worm_tables,
    run_sweep_hetero,
)
from wtracker_tpu_torch.sim.engine import (
    CycleController,
    CycleLog,
    DecideCtx,
    EngineParams,
    csv_controller,
    headless_frame_shape,
    logs_to_frame,
    mlp_controller,
    optimal_controller,
    polyfit_controller,
    run_engine,
    run_engine_streams,
)

__all__ = [
    "ExperimentConfig",
    "TimingConfig",
    "MotorController",
    "SineMotorController",
    "StepMotorController",
    "SimController",
    "Simulator",
    "ViewController",
    "CycleController",
    "CycleLog",
    "DecideCtx",
    "EngineParams",
    "csv_controller",
    "StreamGeometry",
    "csv_controller_hetero",
    "geometry_from_configs",
    "pad_worm_tables",
    "run_sweep_hetero",
    "headless_frame_shape",
    "logs_to_frame",
    "mlp_controller",
    "optimal_controller",
    "polyfit_controller",
    "run_engine",
    "run_engine_streams",
]
