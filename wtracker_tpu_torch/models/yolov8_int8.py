"""Post-training int8 serving form of the YOLOv8 detector.

Port of :mod:`wtracker_tpu.models.yolov8_int8`, with the same scheme, names
and artifact format:

- **weights**: per-output-channel symmetric int8.  Before quantization each
  kernel is folded with its input activation scales (``W' = W · s_in[ic]``),
  so per-channel input scales (from concatenating int8 tensors of different
  scales: C2f, SPPF, PAN) cost nothing at run time.
- **activations**: per-tensor symmetric scales calibrated by an abs-max bf16
  forward over a calibration batch.  int8 is the currency between
  operations; concat, max-pool and nearest upsample run on int8; residual
  adds dequantize, add in float32 and requantize.
- **head logits** stay bf16; the decode is the bf16 detector's
  (:func:`wtracker_tpu_torch.models.yolov8.top1_source_boxes`).

Every convolution runs through :func:`wtracker_tpu_torch.ops.conv_s8.conv_s8`:
on the card the hand-written kernel ``csrc/conv_s8.cu`` (int32 accumulators
and the dequantize → bias → SiLU → requantize epilogue in one launch), on the
CPU its plain version.

The topology is written once (:func:`_forward`) and driven by three "ops"
engines: calibrate (bf16 + abs-max recording), build (host-side scale
propagation and weight quantization, numpy, the JAX package's arithmetic)
and apply (the int8 graph).  Layouts are the JAX package's: NHWC
activations, HWIO kernels.

The port's detect hooks take no ``variables`` argument, so
:func:`make_detect_fns` closes over the weights on the device; the engines'
``detector_model`` argument for the int8 hooks is an :class:`Int8Detector`,
which holds the int8 weights and nothing of the bf16 detector.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wtracker_tpu_torch.models.yolov8 import (
    SCALES,
    ConvBN,
    YoloV8,
    _make_divisible,
    _silu,
    fold_stem_matrices,
    preprocess_batch,
    stem_apply_weff,
    top1_source_boxes,
)
from wtracker_tpu_torch.ops.conv_s8 import conv_s8, pack_weights
from wtracker_tpu_torch.ops.conv_s8 import quant as _quant
from wtracker_tpu_torch.utils.device import resolve_device


def _conv_bf16(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC bf16 × HWIO bf16 → NHWC bf16, "same" padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def _maxpool(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k×k stride-1 max-pool of NHWC data, padded with -inf (Flax's
    ``max_pool``).  int8 goes through float32, which holds it exactly."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2).float(), k, 1, k // 2)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× resize of NHWC data: each pixel duplicated (any dtype)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _conv_node(model: YoloV8, name: str) -> nn.Conv2d:
    """The conv of a ConvBN block, or a head's final conv, by dotted name."""
    mod = model.get_submodule(name)
    return mod.conv if isinstance(mod, ConvBN) else mod


def _fused_hwio(model: YoloV8, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel (HWIO) and bias of ``name``, in the model's dtype."""
    conv = _conv_node(model, name)
    return conv.weight.permute(2, 3, 1, 0), conv.bias


class _CalibOps:
    """bf16 forward over a BN-fused model, recording per-point abs-max.

    With ``record=False`` this is a plain bf16 walker forward
    (:func:`forward_bf16_reference`)."""

    def __init__(self, model: YoloV8, record: bool = True):
        self.model = model
        self.record = record
        self.absmax: dict[str, float] = {}

    def _rec(self, name, y):
        if self.record:
            self.absmax[name] = max(self.absmax.get(name, 0.0), float(y.abs().max()))

    def input(self, x):
        self._rec("__input__", x)
        return x.to(torch.bfloat16)

    def _wb(self, name):
        w, b = _fused_hwio(self.model, name)
        return w.to(torch.bfloat16), b.to(torch.bfloat16)

    def convbn(self, name, x, stride=1):
        w, b = self._wb(name)
        y = _silu(_conv_bf16(x, w, stride) + b)
        self._rec(name, y)
        return y

    def plain_conv(self, name, x):
        w, b = self._wb(name)
        return _conv_bf16(x, w) + b  # logits stay bf16: no quant point

    def add(self, name, a, b):
        y = a + b
        self._rec(name, y)
        return y

    def concat(self, parts):
        return torch.cat(parts, dim=-1)

    def split2(self, x, c):
        return x[..., :c], x[..., c:]

    def maxpool(self, x, k=5):
        return _maxpool(x, k)

    def upsample(self, x):
        return _upsample(x)


class _ScaleVec:
    """Build-phase value: per-channel activation scales of an int8 tensor."""

    def __init__(self, scales: np.ndarray):
        self.scales = np.asarray(scales, np.float32)  # (C,)

    @property
    def shape(self):  # channel count only: the build phase has no spatial data
        return (len(self.scales),)


class _BuildOps:
    """Propagate scales on the host; fold and quantize every conv kernel."""

    def __init__(self, model: YoloV8, absmax: dict[str, float]):
        self.model = model
        self.absmax = absmax
        self.qweights: dict[str, dict[str, np.ndarray]] = {}

    def _scale_of(self, name) -> float:
        # guard against a dead calibration point (all-zero activations)
        return max(self.absmax[name], 1e-6) / 127.0

    def input(self, x: _ScaleVec):
        s = self._scale_of("__input__")
        return _ScaleVec(np.full(x.shape[0], s))

    def _wb(self, name):
        w, b = _fused_hwio(self.model, name)
        return w.detach().float().cpu().numpy(), b.detach().float().cpu().numpy()

    def _fold_quant(self, name, s_in: np.ndarray):
        w, b = self._wb(name)  # (k, k, ic, oc), (oc,)
        w = w * s_in[None, None, :, None]  # absorb per-input-channel scales
        sw = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0  # (oc,)
        wq = np.clip(np.round(w / sw[None, None, None, :]), -127, 127).astype(np.int8)
        self.qweights[name] = {"w": wq, "sw": sw.astype(np.float32), "b": b.astype(np.float32)}
        return w.shape[3]

    def convbn(self, name, x: _ScaleVec, stride=1):
        oc = self._fold_quant(name, x.scales)
        return _ScaleVec(np.full(oc, self._scale_of(name)))

    def plain_conv(self, name, x: _ScaleVec):
        oc = self._fold_quant(name, x.scales)
        return _ScaleVec(np.zeros(oc))  # bf16 logits: scale unused

    def add(self, name, a: _ScaleVec, b: _ScaleVec):
        return _ScaleVec(np.full(a.shape[0], self._scale_of(name)))

    def concat(self, parts):
        return _ScaleVec(np.concatenate([p.scales for p in parts]))

    def split2(self, x: _ScaleVec, c):
        return _ScaleVec(x.scales[:c]), _ScaleVec(x.scales[c:])

    def maxpool(self, x, k=5):
        return x  # max pooling preserves values and therefore scales

    def upsample(self, x):
        return x


class _QT:
    """Apply-phase value: int8 data and its static per-channel scales."""

    __slots__ = ("data", "scales")

    def __init__(self, data, scales):
        self.data = data
        self.scales = scales  # np (C,): static, read by adds only


def _dequant(t: _QT) -> torch.Tensor:
    """float32 data × its float32 scale.  Every add of the topology sees
    tensors whose channels share one scale (a conv output, or a split of
    one), so the scale is a scalar and no table crosses to the device."""
    s = np.asarray(t.scales, np.float32)
    if not (s == s[0]).all():
        raise ValueError("an int8 add expects one scale for all of a tensor's channels")
    return t.data.float() * float(s[0])


class _ApplyOps:
    """The int8 graph over :meth:`QuantizedYolo.device_weights` (``qw``);
    scales are host constants."""

    def __init__(self, qw: dict, absmax: dict):
        self.qw = qw
        self.absmax = absmax

    def _scale_of(self, name) -> float:
        return max(self.absmax[name], 1e-6) / 127.0

    def input(self, x):
        s = self._scale_of("__input__")
        return _QT(_quant(x, s), np.full(x.shape[-1], s))

    def convbn(self, name, x: _QT, stride=1):
        node = self.qw[name]
        s_out = self._scale_of(name)
        y = conv_s8(x.data, node["w"], stride, "silu_q", node["sw"], node["b"], s_out, wp=node["wp"])
        return _QT(y, np.full(y.shape[-1], s_out))

    def plain_conv(self, name, x: _QT):
        node = self.qw[name]
        return conv_s8(x.data, node["w"], 1, "logits", node["sw"], node["b"], wp=node["wp"])

    def add(self, name, a: _QT, b: _QT):
        s_out = self._scale_of(name)
        y = _dequant(a) + _dequant(b)
        return _QT(_quant(y, s_out), np.full(y.shape[-1], s_out))

    def concat(self, parts):
        return _QT(torch.cat([p.data for p in parts], dim=-1), np.concatenate([p.scales for p in parts]))

    def split2(self, x: _QT, c):
        return _QT(x.data[..., :c], x.scales[:c]), _QT(x.data[..., c:], x.scales[c:])

    def maxpool(self, x: _QT, k=5):
        return _QT(_maxpool(x.data, k), x.scales)

    def upsample(self, x: _QT):
        return _QT(_upsample(x.data), x.scales)


# ---------------------------------------------------------------------------
# topology (mirrors YoloV8.forward; pinned by the walker parity test)
# ---------------------------------------------------------------------------


def _bottleneck(ops, name, x, hidden, shortcut):
    y = ops.convbn(f"{name}.cv1", x)
    y = ops.convbn(f"{name}.cv2", y)
    if shortcut:
        y = ops.add(f"{name}.__add__", x, y)
    return y


def _c2f(ops, name, x, out_ch, n, shortcut):
    hidden = out_ch // 2
    y = ops.convbn(f"{name}.cv1", x)
    a, b = ops.split2(y, hidden)
    parts = [a, b]
    for i in range(n):
        parts.append(_bottleneck(ops, f"{name}.m_{i}", parts[-1], hidden, shortcut))
    return ops.convbn(f"{name}.cv2", ops.concat(parts))


def _sppf(ops, name, x, out_ch):
    y = ops.convbn(f"{name}.cv1", x)
    pools = [y]
    for _ in range(3):
        pools.append(ops.maxpool(pools[-1], 5))
    return ops.convbn(f"{name}.cv2", ops.concat(pools))


def _forward(ops, x, nc: int, scale: str):
    x = ops.input(x)
    x = ops.convbn("b0", x, 2)
    return _forward_from_b0(ops, x, nc, scale)


def _forward_from_b0(ops, x, nc: int, scale: str):
    """The graph after the stem, shared with the folded-stem serving entry
    (:meth:`QuantizedYolo.apply_folded`), which computes b0 as letterbox
    matmuls (:func:`wtracker_tpu_torch.models.yolov8.stem_apply_weff`)."""
    depth, width, max_ch = SCALES[scale]

    def chn(c):
        return _make_divisible(min(c, max_ch) * width)

    def rep(n):
        return max(round(n * depth), 1)

    x = ops.convbn("b1", x, 2)
    x = _c2f(ops, "b2", x, chn(128), rep(3), True)
    x = ops.convbn("b3", x, 2)
    p3 = _c2f(ops, "b4", x, chn(256), rep(6), True)
    x = ops.convbn("b5", p3, 2)
    p4 = _c2f(ops, "b6", x, chn(512), rep(6), True)
    x = ops.convbn("b7", p4, 2)
    x = _c2f(ops, "b8", x, chn(1024), rep(3), True)
    p5 = _sppf(ops, "b9", x, chn(1024))

    x = ops.concat([ops.upsample(p5), p4])
    n4 = _c2f(ops, "n12", x, chn(512), rep(3), False)
    x = ops.concat([ops.upsample(n4), p3])
    n3 = _c2f(ops, "n15", x, chn(256), rep(3), False)

    x = ops.convbn("n16", n3, 2)
    x = ops.concat([x, n4])
    n4out = _c2f(ops, "n18", x, chn(512), rep(3), False)
    x = ops.convbn("n19", n4out, 2)
    x = ops.concat([x, p5])
    n5out = _c2f(ops, "n21", x, chn(1024), rep(3), False)

    box_out, cls_out = [], []
    for i, f in enumerate((n3, n4out, n5out)):
        b = ops.convbn(f"head.cv2_{i}_0", f)
        b = ops.convbn(f"head.cv2_{i}_1", b)
        box_out.append(ops.plain_conv(f"head.cv2_{i}_2", b))
        c = ops.convbn(f"head.cv3_{i}_0", f)
        c = ops.convbn(f"head.cv3_{i}_1", c)
        cls_out.append(ops.plain_conv(f"head.cv3_{i}_2", c))
    return box_out, cls_out


class _ShapeOps:
    """The int8 graph's walker over NHWC shapes alone: records each
    convolution as ``((N, H, W, Cin, Cout, k, stride), epilogue)``, Cout and
    k read from the model's layers."""

    def __init__(self, model: YoloV8):
        self.model = model
        self.convs: list[tuple[tuple, str]] = []

    def input(self, x):
        return x

    def _conv(self, name, x, stride, epilogue):
        cout, cin, k, _ = _conv_node(self.model, name).weight.shape
        n, h, w, c = x
        if c != cin:
            raise ValueError(f"{name} takes {cin} channels, the walk reached it with {c}")
        self.convs.append(((n, h, w, cin, cout, k, stride), epilogue))
        pad = k // 2
        return (n, (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1, cout)

    def convbn(self, name, x, stride=1):
        return self._conv(name, x, stride, "silu_q")

    def plain_conv(self, name, x):
        return self._conv(name, x, 1, "logits")

    def add(self, name, a, b):
        return a

    def concat(self, parts):
        return (*parts[0][:3], sum(p[3] for p in parts))

    def split2(self, x, c):
        return (*x[:3], c), (*x[:3], x[3] - c)

    def maxpool(self, x, k=5):
        return x

    def upsample(self, x):
        return (x[0], 2 * x[1], 2 * x[2], x[3])


def conv_shapes(model: YoloV8, n: int, imgsz: tuple[int, int]) -> list[tuple[tuple, str]]:
    """Every convolution of the int8 forward of ``model``'s topology over
    ``n`` views of ``imgsz``, in order: ``((N, H, W, Cin, Cout, k, stride),
    epilogue)``, the shapes :func:`wtracker_tpu_torch.ops.conv_s8.conv_s8`
    receives (the first is b0, which the folded forward skips)."""
    ops = _ShapeOps(model)
    _forward(ops, (n, *imgsz, 3), model.nc, model.scale)
    return ops.convs


def _check_fused_float32(model: YoloV8) -> None:
    if not model.fused:
        raise ValueError("the int8 path expects a BN-fused detector (fuse_conv_bn)")
    if model.compute_dtype != torch.float32:
        raise ValueError(
            f"the detector computes in {model.compute_dtype}: quantize from its float32 fused weights "
            "(fuse in float32, do not cast), since a cast has already rounded them"
        )


@torch.inference_mode()
def forward_bf16_reference(model: YoloV8, x: torch.Tensor):
    """The walker's bf16 forward over a BN-fused float32 model: must equal
    the model cast to bf16 (``tests/test_torch_yolov8_int8.py`` pins this,
    so topology drift is caught)."""
    _check_fused_float32(model)
    return _forward(_CalibOps(model, record=False), x, model.nc, model.scale)


@dataclass(frozen=True)
class QuantizedYolo:
    """Deployment artifact: int8 kernels and folded scales for one detector."""

    nc: int
    scale: str
    absmax: dict  # calibrated per-point abs-max (static floats)
    qweights: dict  # name -> {"w": int8 HWIO, "sw": f32 (oc,), "b": f32 (oc,)}
    reg_max: int = 16

    def device_weights(self, device: str | torch.device = "cuda") -> dict:
        """The weights on ``device`` (upload once, pass per call); each node
        also carries ``"wp"``, the kernel's packed weights."""
        dev = resolve_device(device)
        qw = {}
        for name, node in self.qweights.items():
            qw[name] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in node.items()}
            qw[name]["wp"] = pack_weights(qw[name]["w"])
        return qw

    @torch.inference_mode()
    def apply(self, qw: dict, x: torch.Tensor) -> tuple[list, list]:
        """int8 forward; ``x`` is the preprocessed (B, H, W, 3) batch in
        [0, 1] (any float dtype), ``qw`` = :meth:`device_weights` output."""
        return _forward(self._apply_ops(qw), x.to(torch.bfloat16), self.nc, self.scale)

    @torch.inference_mode()
    def apply_folded(self, qw: dict, views: torch.Tensor, folded) -> tuple[list, list]:
        """int8 forward on raw grayscale views with the stem computed as
        letterbox matmuls (:class:`wtracker_tpu_torch.models.yolov8.FoldedStem`).

        The channel-summed bf16 stem kernel is rebuilt from the quantized b0
        node (:meth:`stem_weff`), the bf16 stem output is requantized at b0's
        calibrated activation scale, and the int8 graph continues from b1.
        """
        ops = self._apply_ops(qw)
        z = stem_apply_weff(folded, self.stem_weff(qw), qw["b0"]["b"], views)
        s_b0 = ops._scale_of("b0")
        xq = _QT(_quant(z, s_b0), np.full(z.shape[-1], s_b0))
        return _forward_from_b0(ops, xq, self.nc, self.scale)

    def stem_weff(self, qw: dict) -> torch.Tensor:
        """Channel-summed (9, out_ch) float32 stem kernel rebuilt from the
        quantized b0 node: ``wq.sum(I)·sw / float32(s_in)``, in that order
        (``s_in`` is the calibrated input scale the build folded in)."""
        s_in = np.float32(max(self.absmax["__input__"], 1e-6) / 127.0)
        b0 = qw["b0"]
        return b0["w"].float().sum(dim=2).reshape(9, -1) * b0["sw"][None, :] / float(s_in)

    def _apply_ops(self, qw: dict) -> _ApplyOps:
        return _ApplyOps(qw, self.absmax)

    # -- serialization ------------------------------------------------------

    def save(self, path) -> None:
        """Write the artifact as one ``.npz`` in the JAX package's format:
        ``name|w`` / ``name|sw`` / ``name|b`` arrays and a JSON ``__meta__``."""
        arrays = {}
        for name, node in self.qweights.items():
            for k, v in node.items():
                arrays[f"{name}|{k}"] = v
        meta = {"nc": self.nc, "scale": self.scale, "reg_max": self.reg_max, "absmax": self.absmax}
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @staticmethod
    def load(path) -> "QuantizedYolo":
        """Inverse of :meth:`save` (either package's artifact)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            qweights: dict[str, dict[str, np.ndarray]] = {}
            for key in z.files:
                if key == "__meta__":
                    continue
                name, k = key.rsplit("|", 1)
                qweights.setdefault(name, {})[k] = z[key]
        return QuantizedYolo(
            nc=meta["nc"], scale=meta["scale"], reg_max=meta["reg_max"], absmax=meta["absmax"], qweights=qweights
        )


class Int8Detector(nn.Module):
    """A :class:`QuantizedYolo` with its weights on a device, as the engines'
    ``detector_model``: the int8 kernels as buffers (so the engines find the
    device), bf16 as the compute dtype (the crop+letterbox kernel's output
    type on the unfolded route), ``reg_max``, and ``forward(x)`` = the int8
    forward, for the mixed-geometry loop.  It holds nothing of the bf16
    detector."""

    def __init__(self, q: QuantizedYolo, qw: dict):
        super().__init__()
        self.q, self.qw = q, qw
        self.reg_max = q.reg_max
        for name, node in qw.items():
            for k, v in node.items():
                self.register_buffer(f"{name.replace('.', '_')}__{k}", v, persistent=False)

    compute_dtype = torch.bfloat16

    def forward(self, x: torch.Tensor):
        return self.q.apply(self.qw, x)


def quantize_detector(model: YoloV8, calib_frames, imgsz: tuple[int, int]) -> QuantizedYolo:
    """Calibrate and quantize a BN-fused float32 detector.

    Args:
        model: the ``fused=True`` float32 model (its weights are quantized as
            they are; a model cast to bf16 raises).
        calib_frames: (B, H, W[, C]) uint8/float frames at source scale; they
            go through the same letterbox as inference, on the model's
            device.
        imgsz: inference size the scales are calibrated at.
    """
    _check_fused_float32(model)
    dev = model.b1.conv.weight.device
    frames = calib_frames if isinstance(calib_frames, torch.Tensor) else torch.from_numpy(np.array(calib_frames))
    x, _ = preprocess_batch(frames.to(dev), imgsz, dtype=torch.bfloat16)
    calib = _CalibOps(model)
    with torch.inference_mode():
        _forward(calib, x, model.nc, model.scale)
    build = _BuildOps(model, calib.absmax)
    _forward(build, _ScaleVec(np.zeros(3)), model.nc, model.scale)
    return QuantizedYolo(nc=model.nc, scale=model.scale, absmax=dict(calib.absmax), qweights=build.qweights)


def detect_top1_int8(q: QuantizedYolo, qw: dict, frames: torch.Tensor, imgsz: tuple[int, int], conf: float):
    """int8 twin of :func:`wtracker_tpu_torch.models.yolov8.detect_top1`:
    (B, H, W[, C]) frames → (B, 4) xywh source-pixel boxes, NaN rows below
    ``conf``."""
    x, geometry = preprocess_batch(frames, imgsz, dtype=torch.bfloat16)
    box_logits, cls_logits = q.apply(qw, x)
    return top1_source_boxes(box_logits, cls_logits, imgsz, q.reg_max, geometry, conf)


def detect_top1_preprocessed_int8(
    q: QuantizedYolo, qw: dict, x: torch.Tensor, geometry, imgsz: tuple[int, int], conf: float
):
    """int8 twin of ``detect_top1_preprocessed``: top-1 detection on an
    already-letterboxed (B, h, w, 3) tensor, e.g. the crop+letterbox kernel's
    output (:func:`wtracker_tpu_torch.ops.preproc.crop_letterbox_views`)."""
    box_logits, cls_logits = q.apply(qw, x)
    return top1_source_boxes(box_logits, cls_logits, imgsz, q.reg_max, geometry, conf)


def detect_top1_int8_folded(
    q: QuantizedYolo, qw: dict, views: torch.Tensor, imgsz: tuple[int, int], conf: float, folded
):
    """Folded-stem twin of :func:`detect_top1_int8`: raw (B, H, W) grayscale
    views, the stem as letterbox matmuls, the int8 graph from b1."""
    box_logits, cls_logits = q.apply_folded(qw, views, folded)
    return top1_source_boxes(box_logits, cls_logits, imgsz, q.reg_max, folded.geometry, conf)


def make_detect_fns(
    q: QuantizedYolo,
    src_hw: tuple[int, int] | None = None,
    imgsz: tuple[int, int] | None = None,
    qw: dict | None = None,
    device: str | torch.device = "cuda",
):
    """``(detect_fn, detect_preprocessed_fn)`` over one quantized detector,
    with the engine hooks' signatures ``detect(model, views, imgsz, conf)``
    and ``detect_preprocessed(model, x, geometry, imgsz, conf)``.  They close
    over ``qw`` (:meth:`QuantizedYolo.device_weights`, uploaded to ``device``
    here when not given) and ignore the model argument.

    With ``src_hw``/``imgsz`` given and a padding-free letterbox, ``detect``
    runs the folded-stem graph (:meth:`QuantizedYolo.apply_folded`) and
    carries ``folds_preproc = True``; otherwise the standard
    preprocess → int8 path.
    """
    if qw is None:
        qw = q.device_weights(device)
    dev = qw["b0"]["w"].device
    folded = None
    if src_hw is not None and imgsz is not None:
        folded = fold_stem_matrices(src_hw, imgsz, dtype=torch.bfloat16, device=dev)

    if folded is not None:
        _imgsz = imgsz

        def detect(model, views, imgsz, conf):
            # the folded geometry is built for _imgsz: the argument is ignored,
            # as in make_folded_detect's bf16 closure
            return detect_top1_int8_folded(q, qw, views, _imgsz, conf, folded)

        detect.folds_preproc = True  # the engines hand it raw views
    else:

        def detect(model, views, imgsz, conf):
            return detect_top1_int8(q, qw, views, imgsz, conf)

    def detect_preprocessed(model, x, geometry, imgsz, conf):
        return detect_top1_preprocessed_int8(q, qw, x, geometry, imgsz, conf)

    return detect, detect_preprocessed


def is_quantized_artifact(path) -> bool:
    """True when ``path`` is a :meth:`QuantizedYolo.save` npz (lets loaders
    tell bf16 weight files from int8 deployment artifacts)."""
    try:
        with np.load(path) as z:
            return "__meta__" in z.files and any("|" in k for k in z.files)
    except (OSError, ValueError):
        return False
