"""Ultralytics-layout state dicts ↔ the port's YOLOv8 detector.

Port of :mod:`wtracker_tpu.models.yolo_port`.  An ultralytics state dict
names its layers ``model.{i}.*`` (``model.model.{i}.*`` inside a full YOLO
object); :data:`LAYER_MAP` gives the layer index of each module of
:class:`~wtracker_tpu_torch.models.yolov8.YoloV8`.  Both directions go
through the Flax layout of the JAX package (nested numpy dicts
``{"params", "batch_stats"}``), so the mapping is the JAX package's, key
for key, and :mod:`wtracker_tpu_torch.convert` does the last step.

A ``.pt`` file loads with ``torch.load(weights_only=True)``, which runs no
pickled code: a plain state dict, or ``{"model": state_dict}``, loads; a
whole-module pickle (what ultralytics itself saves) raises.  The JAX package
unpickles such files with ``weights_only=False``, which runs their code and
needs ultralytics installed; the port does not.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from wtracker_tpu_torch.convert import _unflatten, state_dict_to_flax_flat, yolov8_from_flax
from wtracker_tpu_torch.utils.device import resolve_device

# our module name ← ultralytics layer index
LAYER_MAP = {
    "b0": 0,
    "b1": 1,
    "b2": 2,
    "b3": 3,
    "b4": 4,
    "b5": 5,
    "b6": 6,
    "b7": 7,
    "b8": 8,
    "b9": 9,
    "n12": 12,
    "n15": 15,
    "n16": 16,
    "n18": 18,
    "n19": 19,
    "n21": 21,
}
HEAD_LAYER = 22


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _conv_kernel(w) -> np.ndarray:
    """torch OIHW → Flax HWIO."""
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _port_convbn(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    params = {
        "conv": {"kernel": _conv_kernel(sd[f"{prefix}.conv.weight"])},
        "bn": {"scale": _np(sd[f"{prefix}.bn.weight"]), "bias": _np(sd[f"{prefix}.bn.bias"])},
    }
    stats = {"bn": {"mean": _np(sd[f"{prefix}.bn.running_mean"]), "var": _np(sd[f"{prefix}.bn.running_var"])}}
    return params, stats


def _port_bottleneck(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    p1, s1 = _port_convbn(sd, f"{prefix}.cv1")
    p2, s2 = _port_convbn(sd, f"{prefix}.cv2")
    return {"cv1": p1, "cv2": p2}, {"cv1": s1, "cv2": s2}


def _port_c2f(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for name in ("cv1", "cv2"):
        params[name], stats[name] = _port_convbn(sd, f"{prefix}.{name}")
    i = 0
    while f"{prefix}.m.{i}.cv1.conv.weight" in sd:
        params[f"m_{i}"], stats[f"m_{i}"] = _port_bottleneck(sd, f"{prefix}.m.{i}")
        i += 1
    return params, stats


def _port_plain_conv(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": _conv_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _port_flax_variables(sd: Mapping, prefix: str = "model.") -> dict[str, Any]:
    """An ultralytics state dict as the JAX package's Flax variables
    ``{"params", "batch_stats"}`` (nested numpy dicts): what its
    ``port_state_dict`` returns.  ``prefix`` is the name before the layer
    index ("model." for a bare DetectionModel, "model.model." inside a full
    YOLO object)."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    for ours, idx in LAYER_MAP.items():
        base = f"{prefix}{idx}"
        if f"{base}.conv.weight" in sd:  # plain ConvBN layer
            params[ours], stats[ours] = _port_convbn(sd, base)
        else:  # C2f or SPPF: cv1/cv2 (+ m.{i})
            params[ours], stats[ours] = _port_c2f(sd, base)

    head_p: dict[str, Any] = {}
    head_s: dict[str, Any] = {}
    base = f"{prefix}{HEAD_LAYER}"
    for i in range(3):
        for branch in ("cv2", "cv3"):
            for j in (0, 1):
                head_p[f"{branch}_{i}_{j}"], head_s[f"{branch}_{i}_{j}"] = _port_convbn(sd, f"{base}.{branch}.{i}.{j}")
            head_p[f"{branch}_{i}_2"] = _port_plain_conv(sd, f"{base}.{branch}.{i}.2")
    params["head"] = head_p
    stats["head"] = head_s
    return {"params": params, "batch_stats": stats}


def port_state_dict(sd: Mapping, prefix: str = "model.") -> dict[str, torch.Tensor]:
    """An ultralytics state dict as the state dict of the port's (unfused)
    :class:`~wtracker_tpu_torch.models.yolov8.YoloV8`, float32."""
    return yolov8_from_flax(_port_flax_variables(sd, prefix))


def _export_kernel(k: np.ndarray) -> np.ndarray:
    """Flax HWIO → torch OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _export_convbn(out: dict, prefix: str, p: dict, s: dict) -> None:
    out[f"{prefix}.conv.weight"] = _export_kernel(p["conv"]["kernel"])
    out[f"{prefix}.bn.weight"] = np.asarray(p["bn"]["scale"])
    out[f"{prefix}.bn.bias"] = np.asarray(p["bn"]["bias"])
    out[f"{prefix}.bn.running_mean"] = np.asarray(s["bn"]["mean"])
    out[f"{prefix}.bn.running_var"] = np.asarray(s["bn"]["var"])
    out[f"{prefix}.bn.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def export_state_dict(state: Mapping[str, torch.Tensor], prefix: str = "model.", reg_max: int = 16) -> dict[str, np.ndarray]:
    """The port's YOLOv8 state dict in the ultralytics ``model.{i}.*`` layout
    (numpy arrays): the inverse of :func:`port_state_dict`, as the JAX
    package's ``export_state_dict`` gives it.

    Needs the *unfused* weights (BatchNorm kept) and raises otherwise.  The
    fixed DFL expectation conv, which the decode computes arithmetically, is
    written as ``arange(reg_max)`` to complete the manifest.
    """
    variables = _unflatten(state_dict_to_flax_flat(state))
    params = variables["params"]
    stats = variables.get("batch_stats")
    if not stats:
        raise ValueError(
            "export needs unfused variables with batch_stats — export before fuse_conv_bn(), or load the unfused form"
        )
    out: dict[str, np.ndarray] = {}

    def walk(p: dict, s: dict, prefix_t: str) -> None:
        if "conv" in p and "bn" in p:
            _export_convbn(out, prefix_t, p, s)
            return
        for name in sorted(p):
            tname = name.replace("m_", "m.") if name.startswith("m_") else name
            walk(p[name], s.get(name, {}), f"{prefix_t}.{tname}")

    for ours, idx in LAYER_MAP.items():
        walk(params[ours], stats[ours], f"{prefix}{idx}")

    base = f"{prefix}{HEAD_LAYER}"
    for i in range(3):
        for branch in ("cv2", "cv3"):
            for j in (0, 1):
                name = f"{branch}_{i}_{j}"
                _export_convbn(out, f"{base}.{branch}.{i}.{j}", params["head"][name], stats["head"][name])
            p2 = params["head"][f"{branch}_{i}_2"]
            out[f"{base}.{branch}.{i}.2.weight"] = _export_kernel(p2["kernel"])
            out[f"{base}.{branch}.{i}.2.bias"] = np.asarray(p2["bias"])
    out[f"{base}.dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)
    return out


def save_torch_state_dict(detector, path: str, prefix: str = "model.") -> None:
    """Write a detector's weights as a torch state-dict file in the
    ultralytics layout (``torch.load(weights_only=True)`` reads it back)."""
    sd = export_state_dict(detector.model.state_dict(), prefix=prefix, reg_max=detector.model.reg_max)
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}, path)


def _read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.pt`` state dict, read without running pickled code."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path}: not a plain state dict ({type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}). "
            "Only tensors load here (torch.load with weights_only=True); a whole-module pickle, such as "
            "ultralytics saves, would run its pickled code and needs ultralytics installed. Export its "
            "state dict first (model.state_dict())"
        ) from e
    if isinstance(obj, Mapping) and "model" in obj and isinstance(obj["model"], Mapping):
        obj = obj["model"]
    if not isinstance(obj, Mapping) or not all(isinstance(v, torch.Tensor) for v in obj.values()):
        raise ValueError(f"{path}: expected a state dict (name → tensor) or {{'model': state_dict}}")
    return dict(obj)


def load_ultralytics_checkpoint(
    path: str,
    imgsz: tuple[int, int] = (384, 384),
    conf: float = 0.1,
    device: str | torch.device = "cuda",
):
    """Load an ultralytics-layout ``.pt`` state dict into a float32
    :class:`~wtracker_tpu_torch.models.yolov8.YoloV8Detector`, inferring
    ``nc`` and the scale from the shapes."""
    from wtracker_tpu_torch.models.yolov8 import SCALES, YoloV8, YoloV8Detector

    dev = resolve_device(device)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in _read_state_dict(path).items()}
    prefix = "model.model." if any(k.startswith("model.model.") for k in sd) else "model."
    state = port_state_dict(sd, prefix=prefix)

    nc = state["head.cv3_0_2.weight"].shape[0]
    stem_out = state["b0.conv.weight"].shape[0]
    scale = next(s for s, (_, w, _) in SCALES.items() if round(64 * w) == stem_out or max(round(64 * w), 16) == stem_out)

    model = YoloV8(nc=nc, scale=scale)
    model.load_state_dict(state)
    return YoloV8Detector(model.to(dev).eval(), tuple(imgsz), conf)
