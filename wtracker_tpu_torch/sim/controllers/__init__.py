"""Tracking controllers for the hook-based simulator
(:class:`wtracker_tpu_torch.sim.simulator.Simulator`) and their
configurations; the engine's controller factories are their twins."""

from wtracker_tpu_torch.sim.controllers.csv import CsvController
from wtracker_tpu_torch.sim.controllers.logging import LogConfig, LoggingController
from wtracker_tpu_torch.sim.controllers.mlp import MLPController
from wtracker_tpu_torch.sim.controllers.optimal import OptimalController
from wtracker_tpu_torch.sim.controllers.polyfit import PolyfitConfig, PolyfitController, WeightEvaluator
from wtracker_tpu_torch.sim.controllers.yolo import YoloConfig, YoloController

__all__ = [
    "CsvController",
    "LogConfig",
    "LoggingController",
    "MLPController",
    "OptimalController",
    "PolyfitConfig",
    "PolyfitController",
    "WeightEvaluator",
    "YoloConfig",
    "YoloController",
]
