"""Neural-training configuration: the predictor's IO contract, the dataset
and training recipes, and the loss and optimizer registries.

Port of :mod:`wtracker_tpu.neural.config`.  The field schema (names,
defaults, the derived ``in_dim``/``out_dim`` persisted into JSON) is the
compatibility contract with config files of either package.  Invariant:
``in_dim = BBOX_FEATURES·|input_frames|`` and
``out_dim = CENTER_FEATURES·|pred_frames|``.

The JAX package's optimizers are optax's; :data:`OPTIMIZERS` builds torch
optimizers with the same arithmetic (see :func:`make_optimizer`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch

from wtracker_tpu_torch.utils.config_base import ConfigBase

# feature widths per frame offset: a full bbox going in, a center coming out
BBOX_FEATURES = 4
CENTER_FEATURES = 2


def _config_warning(scope: str, detail: str) -> None:
    # the reference warns on stdout rather than raising
    print(f"WARNING::{scope}::{detail} Please verify your parameters.")


@dataclass
class IOConfig(ConfigBase):
    """Input/output contract of the predictor network.

    Frame offsets are relative to the prediction frame (0); negative offsets
    look into the past.
    """

    input_frames: list[int]
    pred_frames: list[int]

    in_dim: int = field(init=False)
    out_dim: int = field(init=False)

    def __post_init__(self):
        if 0 not in self.input_frames:
            _config_warning("IOConfig", "input_frames doesn't contain 0 (the prediction frame).")
        self.in_dim = BBOX_FEATURES * len(self.input_frames)
        self.out_dim = CENTER_FEATURES * len(self.pred_frames)

    @classmethod
    def from_datasetConfig(cls, config: "DatasetConfig") -> "IOConfig":
        return cls(config.input_frames, config.pred_frames)


@dataclass
class DatasetConfig(ConfigBase):
    """Where the training pairs come from: frame offsets and the source log(s)."""

    input_frames: list[int]
    """Frame offsets fed to the network (0 = the prediction frame, negatives
    are in the past)."""

    pred_frames: list[int]
    """Frame offsets the network predicts (relative to the prediction frame)."""

    log_path: str
    """Path to the log CSV holding worm-head detections (or a list of them)."""

    def __post_init__(self) -> None:
        if self.input_frames[0] != 0:
            _config_warning("DatasetConfig", "input_frames should contain 0 as first element.")

    @classmethod
    def from_io_config(cls, io: IOConfig, log_path: str) -> "DatasetConfig":
        return cls(io.input_frames, io.pred_frames, log_path)


class OptaxRMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (not ``torch.optim.RMSprop``): ``ν ← 0.9·ν +
    0.1·g²`` from ``ν = 0``, update ``−lr·g·rsqrt(ν + ε)`` with ε inside the
    root; ``weight_decay`` adds ``wd·p`` to the gradient first, as the
    ``add_decayed_weights`` that the JAX trainer chains in front."""

    def __init__(self, params: Iterable, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps, wd = group["decay"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - decay) * (g * g) + decay * nu)
                p.sub_(group["lr"] * (torch.rsqrt(nu + eps) * g))


def _adam(params, lr, weight_decay):
    return torch.optim.Adam(params, lr, weight_decay=weight_decay)


def _sgd(params, lr, weight_decay):
    return torch.optim.SGD(params, lr, weight_decay=weight_decay)


def _adamw(params, lr, weight_decay):
    return torch.optim.AdamW(params, lr, weight_decay=weight_decay)


def _rmsprop(params, lr, weight_decay):
    return OptaxRMSprop(params, lr, weight_decay=weight_decay)


# The JAX trainer's optimizers: ``adam``, ``sgd`` and ``rmsprop`` chained
# behind ``add_decayed_weights`` (coupled L2: the gradient gains ``wd·p``,
# which torch's ``weight_decay`` argument of Adam and SGD does), ``adamw``
# with decoupled decay (torch's AdamW).  optax's defaults are torch's here
# (Adam β 0.9/0.999, ε 1e-8; plain SGD) except RMSprop's.
OPTIMIZERS: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "adam": _adam,
    "sgd": _sgd,
    "rmsprop": _rmsprop,
    "adamw": _adamw,
}


def make_optimizer(name: str, params: Iterable, learning_rate: float, weight_decay: float) -> torch.optim.Optimizer:
    """The optimizer that the JAX trainer builds for ``name``."""
    return OPTIMIZERS[name](params, learning_rate, weight_decay)


LOSSES = {
    "mse": lambda pred, target: ((pred - target) ** 2).mean(),
    "l1": lambda pred, target: (pred - target).abs().mean(),
}


@dataclass
class TrainConfig(ConfigBase):
    """Full training recipe for the movement predictor (the JAX package's
    schema; ``device`` defaults to "cuda" here)."""

    dataset: DatasetConfig
    model: object | str  # a predictor, a checkpoint path, or None for a fresh one
    loss_fn: str = "mse"  # key into LOSSES
    optimizer: str = "adam"  # key into OPTIMIZERS
    device: str = "cuda"
    log: bool = False  # tensorboard logging on/off

    seed: int = field(default=42, kw_only=True)

    # fitting schedule
    num_epochs: int = 100
    checkpoints: str | None = None
    early_stopping: int | None = None
    print_every: int = 5

    # optimizer knobs
    learning_rate: float = 0.001
    weight_decay: float = 1e-5

    # batching
    batch_size: int = 256
    shuffle: bool = True
    num_workers: int = 0
    train_test_split: float = 0.8
