"""Host utilities: bbox math, configs, frame IO, logging, profiling, async saving, device selection."""

from wtracker_tpu_torch.utils.bbox import BoxConverter, BoxFormat, BoxUtils
from wtracker_tpu_torch.utils.config_base import ConfigBase, print_initialization
from wtracker_tpu_torch.utils.frame_reader import ArrayReader, DummyReader, FrameReader, FrameStream
from wtracker_tpu_torch.utils.log_utils import CSVLogger
from wtracker_tpu_torch.utils.profiling import StageTimer, device_trace
from wtracker_tpu_torch.utils.threading_utils import TaskScheduler, TqdmQueue, adjust_num_workers

__all__ = [
    "BoxConverter",
    "BoxFormat",
    "BoxUtils",
    "ConfigBase",
    "print_initialization",
    "ArrayReader",
    "DummyReader",
    "FrameReader",
    "FrameStream",
    "CSVLogger",
    "StageTimer",
    "device_trace",
    "TaskScheduler",
    "TqdmQueue",
    "adjust_num_workers",
]
