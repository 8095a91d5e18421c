"""Evaluation layer: error metrics, log analysis, plotting, replay."""

from wtracker_tpu_torch.eval.data_analyzer import DataAnalyzer
from wtracker_tpu_torch.eval.error_calculator import ErrorCalculator, precise_error_batched
from wtracker_tpu_torch.eval.plotter import Plotter
from wtracker_tpu_torch.eval.vlc import VLC, HotKey, StreamViewer

__all__ = [
    "DataAnalyzer",
    "ErrorCalculator",
    "precise_error_batched",
    "Plotter",
    "VLC",
    "HotKey",
    "StreamViewer",
]
