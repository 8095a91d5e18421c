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


# ---------------------------------------------------------------------------
# the reference's whole-module .pt files, read without running them
# ---------------------------------------------------------------------------

# the only callables a whole-module torch pickle may name besides module
# classes: tensor and parameter rebuilds, and two containers
_PICKLE_CALLABLES = {
    ("torch._utils", "_rebuild_tensor_v2"): "torch._utils",
    ("torch._utils", "_rebuild_parameter"): "torch._utils",
    ("collections", "OrderedDict"): "collections",
    ("builtins", "set"): "builtins",
    ("__builtin__", "set"): "builtins",
}


class _Pickled:
    """An inert stand-in for a pickled object of a class the loader does not
    run (the upstream ``wtracker`` classes, torch's module classes): it only
    keeps the pickled attributes (``__dict__``, so ``_modules``,
    ``_parameters``, ``_buffers`` for a module)."""

    _pickled_class = ""

    def __setstate__(self, state) -> None:
        if isinstance(state, tuple):  # (dict state, slot state)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__.update(state)

    def __getattr__(self, name: str):
        """A module's submodules, parameters and buffers as attributes."""
        if not name.startswith("__"):
            for group in ("_modules", "_parameters", "_buffers"):
                if name in self.__dict__.get(group, {}):
                    return self.__dict__[group][name]
        raise AttributeError(name)


def _restricted_pickle_module():
    """A ``pickle_module`` for ``torch.load`` whose unpickler maps module
    classes to :class:`_Pickled` stand-ins, allows the callables of
    ``_PICKLE_CALLABLES`` and refuses every other global."""
    import importlib
    import pickle
    import types

    stubs: dict = {}

    class Unpickler(pickle.Unpickler):
        def find_class(self, module: str, name: str):
            key = (module, name)
            if key in _PICKLE_CALLABLES:
                return getattr(importlib.import_module(_PICKLE_CALLABLES[key]), name)
            if module.split(".")[0] == "wtracker" or module.startswith("torch.nn.modules."):
                if key not in stubs:
                    stubs[key] = type(name, (_Pickled,), {"_pickled_class": f"{module}.{name}"})
                return stubs[key]
            raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a predictor checkpoint")

    mod = types.ModuleType("restricted_pickle")
    mod.Unpickler = Unpickler
    mod.load = lambda f, **kw: Unpickler(f, **kw).load()
    mod.__name__ = "restricted_pickle"
    return mod


def _pickled_state_dict(module: _Pickled, prefix: str = "") -> dict[str, np.ndarray]:
    """``state_dict()`` of a pickled module tree, from its stand-ins."""
    out = {}
    skip = module.__dict__.get("_non_persistent_buffers_set", set())
    for name, p in module.__dict__.get("_parameters", {}).items():
        if p is not None:
            out[prefix + name] = p.detach().numpy()
    for name, b in module.__dict__.get("_buffers", {}).items():
        if b is not None and name not in skip:
            out[prefix + name] = b.detach().numpy()
    for name, child in module.__dict__.get("_modules", {}).items():
        if child is not None:
            out.update(_pickled_state_dict(child, f"{prefix}{name}."))
    return out


def _children(module: _Pickled) -> list:
    return list(module.__dict__["_modules"].values())


def load_torch_checkpoint(path: str, reference_root: str | None = None) -> WormPredictor:
    """Load a reference ``WormPredictor`` ``.pt`` (a whole-module pickle of
    the upstream ``wtracker`` package) as a CPU :class:`WormPredictor`.

    The pickle is read with a restricted unpickler: the upstream classes
    (and torch's module classes) become inert stand-ins that only collect
    the pickled attributes, tensors are rebuilt from their storages, and any
    other global refuses the file.  Nothing is put on ``sys.path`` and no
    code of the checkpoint's package runs, so ``reference_root`` (the JAX
    package's way to import that package) is accepted and not needed.  The
    topology is read from the module tree as the JAX package reads it
    (``wtracker_tpu/models/resmlp.py``: ReLU blocks, BatchNorm when the
    pickle has running statistics).
    """
    from wtracker_tpu_torch.convert import resmlp_from_flax

    tm = torch.load(path, map_location="cpu", pickle_module=_restricted_pickle_module(), weights_only=False)
    io = tm.io_config
    io_config = IOConfig(list(io.input_frames), list(io.pred_frames))
    sd = _pickled_state_dict(tm)

    rmlp = tm.model
    has_input = "model.input.mlp_layer.0.weight" in sd
    blocks = _children(rmlp.blocks)
    sequence = _children(blocks[0].sequence)

    def linear(layer):
        return _children(layer.mlp_layer)[0]

    block_dims = [linear(layer).out_features for layer in sequence]
    has_bn = any(".mlp_layer.1.running_mean" in k for k in sd)
    model = RMLP(
        block_in_dim=linear(sequence[0]).in_features,
        block_dims=tuple(block_dims),
        block_nonlins=("relu",) * len(block_dims),
        n_blocks=len(blocks),
        out_dim=rmlp.output.out_features,
        in_dim=linear(rmlp.input).in_features if has_input else None,
        batch_norm=has_bn,
    )

    def layer(prefix: str):
        p = {"dense": {"kernel": sd[f"{prefix}.mlp_layer.0.weight"].T.copy(), "bias": sd[f"{prefix}.mlp_layer.0.bias"]}}
        s = {}
        if has_bn:
            p["bn"] = {"scale": sd[f"{prefix}.mlp_layer.1.weight"], "bias": sd[f"{prefix}.mlp_layer.1.bias"]}
            s = {"bn": {"mean": sd[f"{prefix}.mlp_layer.1.running_mean"], "var": sd[f"{prefix}.mlp_layer.1.running_var"]}}
        return p, s

    params, stats = {}, {}
    if has_input:
        params["input"], stats["input"] = layer("model.input")
    for b in range(len(blocks)):
        parts = [layer(f"model.blocks.{b}.sequence.{i}") for i in range(len(block_dims))]
        params[f"block_{b}"] = {f"layer_{i}": p for i, (p, _) in enumerate(parts)}
        stats[f"block_{b}"] = {f"layer_{i}": s for i, (_, s) in enumerate(parts)}
    params["output"] = {"kernel": sd["model.output.weight"].T.copy(), "bias": sd["model.output.bias"]}
    variables = {"params": params}
    if has_bn:
        variables["batch_stats"] = stats
    model.load_state_dict(resmlp_from_flax(variables))
    return WormPredictor(model.eval(), io_config)
