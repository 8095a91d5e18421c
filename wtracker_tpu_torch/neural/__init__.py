"""Training: configs and optimizers, datasets, the ResMLP trainer, the particle
swarm, and the YOLOv8 loss and full recipe."""

from wtracker_tpu_torch.neural.config import LOSSES, OPTIMIZERS, DatasetConfig, IOConfig, TrainConfig
from wtracker_tpu_torch.neural.dataset import NumpyDataset
from wtracker_tpu_torch.neural.optimize import PSOResult, optimize_polyfit_weights, particle_swarm
from wtracker_tpu_torch.neural.train_results import BatchResult, EpochResult, FitResult
from wtracker_tpu_torch.neural.training import MLPTrainer, Trainer, fit_from_config

__all__ = [
    "LOSSES",
    "OPTIMIZERS",
    "DatasetConfig",
    "IOConfig",
    "TrainConfig",
    "NumpyDataset",
    "PSOResult",
    "optimize_polyfit_weights",
    "particle_swarm",
    "BatchResult",
    "EpochResult",
    "FitResult",
    "MLPTrainer",
    "Trainer",
    "fit_from_config",
]
