"""Carry Flax parameters of the JAX package over to the port's modules.

The JAX package's variables are nested dicts ``{"params": ..., "batch_stats":
...}``; here they arrive as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, variables)``, or the ``.npz`` files both packages write).  The
port's modules use the Flax module names, so a parameter's path maps to its
``state_dict`` key by joining with ``.`` and renaming the leaf:

=============================  ===============================  ============================
Flax leaf                      torch key                        layout
=============================  ===============================  ============================
``conv/kernel`` (kh,kw,in,out)  ``conv.weight`` (out,in,kh,kw)  transposed
``dense/kernel`` (in, out)      ``dense.weight`` (out, in)      transposed
``bias``                        ``bias``
``bn/scale``, ``bn/bias``       ``bn.weight``, ``bn.bias``
``bn/mean``, ``bn/var``         ``bn.running_mean``, ``.running_var``
=============================  ===============================  ============================
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_flax_npz(path: str) -> tuple[dict, dict]:
    """Read a JAX-package ``.npz`` (``__meta__`` plus ``/``-joined keys) into
    ``(meta, variables)``.  ``__meta__`` is a pickled dict, so only load files
    this project wrote."""
    with np.load(path, allow_pickle=True) as data:
        meta = data["__meta__"].item()
        variables = _unflatten({k: data[k] for k in data.files if k != "__meta__"})
    return meta, variables


def flax_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Generic Flax → torch ``state_dict`` mapping (see the module table)."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            leaf = path[-1]
            if leaf not in _LEAF:
                raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = ".".join(path[:-1] + (_LEAF[leaf],))
            state[key] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
            if leaf == "mean":  # torch BatchNorm also keeps a step counter
                state[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return state


def state_dict_to_flax_flat(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of :func:`flax_to_state_dict`, as the flat ``/``-joined keys
    of the JAX package's ``.npz`` files."""
    flat = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        bn = bool(path) and path[-1] == "bn"
        if leaf == "weight":
            name = "scale" if bn else "kernel"
            if not bn:
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            name = {"bias": "bias", "running_mean": "mean", "running_var": "var"}[leaf]
        collection = "batch_stats" if name in ("mean", "var") else "params"
        flat["/".join([collection, *path, name])] = np.ascontiguousarray(arr)
    return flat


def yolov8_from_flax(variables_np: dict) -> dict[str, torch.Tensor]:
    """State dict of :class:`wtracker_tpu_torch.models.yolov8.YoloV8` from the
    JAX package's YOLOv8 variables (BN-fused or not; the keys tell which)."""
    return flax_to_state_dict(variables_np)


def resmlp_from_flax(variables_np: dict) -> dict[str, torch.Tensor]:
    """State dict of :class:`wtracker_tpu_torch.models.resmlp.RMLP` from the
    JAX package's predictor variables."""
    return flax_to_state_dict(variables_np)
