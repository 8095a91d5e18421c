"""ResMLP worm-movement predictor in PyTorch.

Port of :mod:`wtracker_tpu.models.resmlp`: residual MLP with an optional
input layer, ``n_blocks`` blocks applied as ``x = x + block(x)`` and a linear
head.  Each layer is Linear → BatchNorm → activation (BatchNorm skipped when
the activation is ``none``).  Module names follow the Flax tree (``input``,
``block_{i}.layer_{j}.dense``/``.bn``, ``output``), so the ``.npz`` files of
both packages carry the same weights (:func:`save_predictor`,
:func:`load_predictor`).  Inference is float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wtracker_tpu_torch.models.batchnorm import flax_batch_norm
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.utils import flax_init
from wtracker_tpu_torch.utils.device import resolve_device

ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: F.softmax(x, dim=-1),
    "logsoftmax": lambda x: F.log_softmax(x, dim=-1),
    "lrelu": lambda x: F.leaky_relu(x, 0.01),  # flax.linen.leaky_relu's slope
    "none": lambda x: x,
    None: lambda x: x,
}


class MLPLayer(nn.Module):
    """Linear → BatchNorm → activation (BatchNorm only with a real activation)."""

    def __init__(self, in_dim: int, out_dim: int, nonlin: str | None = "relu", batch_norm: bool = True):
        super().__init__()
        self.nonlin = nonlin
        self.dense = nn.Linear(in_dim, out_dim)
        # torch BatchNorm1d defaults (eps 1e-5, momentum 0.1), as the reference trains with;
        # train mode normalises as Flax does (models/batchnorm.py)
        use_bn = batch_norm and nonlin not in ("none", None)
        self.bn = nn.BatchNorm1d(out_dim, eps=1e-5, momentum=0.1) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x.reshape(x.shape[0], -1))
        if self.bn is not None:
            x = flax_batch_norm(x, self.bn) if self.training else self.bn(x)
        return ACTIVATIONS[self.nonlin](x)


class MlpBlock(nn.Module):
    """A stack of :class:`MLPLayer`s over ``dims`` with matching ``nonlins``."""

    def __init__(self, in_dim: int, dims: Sequence[int], nonlins: Sequence[str | None], batch_norm: bool = True):
        super().__init__()
        if len(dims) != len(nonlins):
            raise ValueError(f"{len(dims)} dims but {len(nonlins)} nonlins")
        self.n = len(dims)
        for i, out_dim in enumerate(dims):
            setattr(self, f"layer_{i}", MLPLayer(in_dim, out_dim, nonlins[i], batch_norm))
            in_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x)
        return x


class RMLP(nn.Module):
    """Residual MLP: optional input layer, residual blocks, linear head."""

    def __init__(
        self,
        block_in_dim: int,
        block_dims: Sequence[int],
        block_nonlins: Sequence[str | None],
        n_blocks: int,
        out_dim: int,
        in_dim: int | None = None,
        batch_norm: bool = True,
    ):
        super().__init__()
        self.block_in_dim = block_in_dim
        self.block_dims = tuple(block_dims)
        self.block_nonlins = tuple(block_nonlins)
        self.n_blocks = n_blocks
        self.out_dim = out_dim
        self.in_dim = in_dim
        self.batch_norm = batch_norm
        if in_dim is not None:  # a first projection layer
            self.input = MLPLayer(in_dim, block_in_dim, block_nonlins[0], batch_norm)
        for i in range(n_blocks):
            setattr(self, f"block_{i}", MlpBlock(block_in_dim, block_dims, block_nonlins, batch_norm))
        self.output = nn.Linear(block_in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        if self.in_dim is not None:
            x = self.input(x)
        for i in range(self.n_blocks):
            x = x + getattr(self, f"block_{i}")(x)
        return self.output(x)


@dataclass
class WormPredictor:
    """A movement-prediction model bound to its IO contract (eval mode)."""

    model: RMLP
    io_config: IOConfig

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Inference on a batch shaped (N, in_dim) → (N, out_dim), float32."""
        return self.model(x.to(torch.float32))


def _flax_init(model: nn.Module, seed: int) -> None:
    """The weights of the JAX package's ``model.init(PRNGKey(seed), ...)``:
    each Dense kernel ``lecun_normal`` from its Flax key
    (:mod:`wtracker_tpu_torch.utils.flax_init`), zero biases; BatchNorm
    starts at identity, as torch's does."""
    root = flax_init.key(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                kernel = flax_init.dense_kernel(root, tuple(name.split(".")), mod.in_features, mod.out_features)
                mod.weight.copy_(torch.from_numpy(kernel.T.copy()))
                mod.bias.zero_()


def make_rmlp_predictor(
    io_config: IOConfig,
    block_in_dim: int = 40,
    block_dims: Sequence[int] = (10, 4, 10, 40),
    n_blocks: int = 4,
    nonlin: str = "relu",
    batch_norm: bool = True,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> WormPredictor:
    """Fresh (untrained) predictor with the reference's default topology,
    holding the weights that the JAX package's ``make_rmlp_predictor`` draws
    from the same seed."""
    dev = resolve_device(device)
    model = RMLP(
        block_in_dim=block_in_dim,
        block_dims=tuple(block_dims),
        block_nonlins=(nonlin,) * len(block_dims),
        n_blocks=n_blocks,
        out_dim=io_config.out_dim,
        in_dim=io_config.in_dim,
        batch_norm=batch_norm,
    )
    _flax_init(model, seed)
    return WormPredictor(model.to(dev).eval(), io_config)


# ---------------------------------------------------------------------------
# persistence (.npz, the JAX package's format)
# ---------------------------------------------------------------------------


def save_predictor(predictor: WormPredictor, path: str) -> None:
    """Persist a predictor (topology + weights + IO contract) to ``.npz``."""
    from wtracker_tpu_torch.convert import state_dict_to_flax_flat

    m = predictor.model
    meta = dict(
        block_in_dim=m.block_in_dim,
        block_dims=list(m.block_dims),
        block_nonlins=list(m.block_nonlins),
        n_blocks=m.n_blocks,
        out_dim=m.out_dim,
        in_dim=m.in_dim,
        batch_norm=m.batch_norm,
        input_frames=list(predictor.io_config.input_frames),
        pred_frames=list(predictor.io_config.pred_frames),
    )
    flat = state_dict_to_flax_flat(m.state_dict())
    flat["__meta__"] = np.array(meta, dtype=object)
    np.savez(path, **flat)


def load_predictor(path: str, device: str | torch.device = "cuda") -> WormPredictor:
    """Load a predictor saved by :func:`save_predictor` of either package."""
    from wtracker_tpu_torch.convert import load_flax_npz, resmlp_from_flax

    dev = resolve_device(device)
    meta, variables = load_flax_npz(path)
    model = RMLP(
        block_in_dim=meta["block_in_dim"],
        block_dims=tuple(meta["block_dims"]),
        block_nonlins=tuple(meta["block_nonlins"]),
        n_blocks=meta["n_blocks"],
        out_dim=meta["out_dim"],
        in_dim=meta["in_dim"],
        batch_norm=meta["batch_norm"],
    )
    model.load_state_dict(resmlp_from_flax(variables))
    io_config = IOConfig(list(meta["input_frames"]), list(meta["pred_frames"]))
    return WormPredictor(model.to(dev).eval(), io_config)
