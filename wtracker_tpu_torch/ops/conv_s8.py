"""int8 convolution with its fused epilogue: the int8 detector's one operation.

Counterpart of ``wtracker_tpu/models/yolov8_int8.py``'s ``_conv_s8`` (an
XLA-lowered ``conv_general_dilated`` with int32 accumulation) together with
the epilogues of ``_ApplyOps.convbn`` and ``_ApplyOps.plain_conv``.  The
wrapper :func:`conv_s8` launches the hand-written CUDA kernel
``csrc/conv_s8.cu`` for CUDA tensors and runs the plain version,
:func:`conv_s8_reference`, for CPU tensors.  There is no fallback from the
kernel: a CUDA tensor that the kernel cannot take raises.

Layouts are the JAX package's: activations NHWC int8, kernels HWIO int8.
Epilogues (``sw``, ``b``: float32 per output channel):

- ``"acc"``: the int32 accumulators;
- ``"logits"``: ``bf16(float32(acc)·sw + b)``;
- ``"silu_q"``: ``y = float32(acc)·sw + b``, then SiLU as
  ``0.5·y·(tanh(0.5·y) + 1)``, then :func:`quant` at the output scale.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPILOGUES = ("acc", "logits", "silu_q")
_OUT_DTYPES = {"acc": torch.int32, "logits": torch.bfloat16, "silu_q": torch.int8}


def inv_scale(scale: float) -> float:
    """``float32(1/scale)``: the reciprocal taken in float64, then rounded
    once (the JAX package's ``np.float32(1.0 / scale)``)."""
    return float(np.float32(1.0 / scale))


def quant(y: torch.Tensor, scale: float) -> torch.Tensor:
    """``_quant``: round half to even of ``float32(y)·float32(1/scale)``,
    clipped to ±127, as int8."""
    q = torch.round(y.float() * inv_scale(scale))
    return q.clamp(-127, 127).to(torch.int8)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(k, k, Cin, Cout)`` → the kernel's int32 words
    ``(k·k·ceil(Cin/4), Cout)``: each word holds 4 consecutive input channels
    of one tap, the first in its low byte (Cin padded with zeros to a
    multiple of 4)."""
    k, _, cin, cout = w.shape
    cp = -(-cin // 4) * 4
    wp = torch.zeros((k, k, cp, cout), dtype=torch.int8, device=w.device)
    wp[:, :, :cin] = w
    wp = wp.reshape(k * k * cp // 4, 4, cout).permute(0, 2, 1).reshape(-1, cout * 4)
    return wp.contiguous().view(torch.int32)


def _check(x, w, stride, epilogue, sw, b):
    if x.dtype != torch.int8 or x.ndim != 4 or x.stride(-1) != 1:
        raise ValueError(f"x must be an NHWC int8 tensor with channel stride 1, got {tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.int8 or w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[0] not in (1, 3):
        raise ValueError(f"w must be a 1x1 or 3x3 HWIO int8 kernel, got {tuple(w.shape)} {w.dtype}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"kernel takes {w.shape[2]} channels, x has {x.shape[3]}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if epilogue != "acc":
        cout = w.shape[3]
        for name, t in (("sw", sw), ("b", b)):
            if t is None or t.dtype != torch.float32 or tuple(t.shape) != (cout,) or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous ({cout},) float32 tensor")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def conv_s8(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    epilogue: str = "acc",
    sw: torch.Tensor | None = None,
    b: torch.Tensor | None = None,
    s_out: float | None = None,
    wp: torch.Tensor | None = None,
) -> torch.Tensor:
    """int8 convolution with "same" padding and its epilogue.

    Args:
        x: (N, H, W, Cin) int8, channel stride 1 (a channel slice of a wider
            tensor is taken as it is).
        w: (k, k, Cin, Cout) int8 HWIO kernel, k = 1 or 3.
        stride: 1 or 2.
        epilogue: ``"acc"``, ``"logits"`` or ``"silu_q"``.
        sw, b: (Cout,) float32 weight scales and bias (not for ``"acc"``).
        s_out: the output activation scale (``"silu_q"`` only).
        wp: :func:`pack_weights` of ``w``, packed once by the caller
            (:meth:`QuantizedYolo.device_weights` keeps it beside ``w``);
            required for a CUDA tensor, unread on the CPU.

    Returns (N, Ho, Wo, Cout): int32, bf16 or int8.  Every launch of the
    kernel adds one to ``conv_s8.launches``.
    """
    _check(x, w, stride, epilogue, sw, b)
    if epilogue == "silu_q" and s_out is None:
        raise ValueError("the silu_q epilogue needs s_out")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv_s8_reference(x, w, stride, epilogue, sw, b, s_out)
        raise ValueError(f"no kernel for device {x.device}")
    from wtracker_tpu_torch.ops import _build

    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    if wp is None:
        raise ValueError("the kernel takes the packed weights: pass wp=pack_weights(w), packed once")
    if wp.dtype != torch.int32 or tuple(wp.shape) != (k * k * (-(-cin // 4)), cout) or not wp.is_contiguous():
        raise ValueError(f"wp {tuple(wp.shape)} {wp.dtype} is not the packed form of w {tuple(w.shape)}")
    out = torch.empty((n, ho, wo, cout), dtype=_OUT_DTYPES[epilogue], device=x.device)
    sn, sh, spx, _ = x.stride()
    vec = int(cin % 4 == 0 and x.data_ptr() % 4 == 0 and sn % 4 == 0 and sh % 4 == 0 and spx % 4 == 0)
    dummy = wp  # sw/b are not read by the "acc" epilogue
    lib = _build.load("conv_s8")
    err = lib.conv_s8(
        x.data_ptr(), wp.data_ptr(), (sw if sw is not None else dummy).data_ptr(),
        (b if b is not None else dummy).data_ptr(), out.data_ptr(), n, h, wd, cin, sn, sh, spx, cout, k, stride,
        vec, EPILOGUES.index(epilogue), inv_scale(s_out) if epilogue == "silu_q" else 0.0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"conv_s8 kernel launch failed with CUDA error {err}")
    conv_s8.launches += 1
    return out


conv_s8.launches = 0


def conv_s8_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    epilogue: str = "acc",
    sw: torch.Tensor | None = None,
    b: torch.Tensor | None = None,
    s_out: float | None = None,
) -> torch.Tensor:
    """Plain version of the kernel: the convolution in float64 (exact: every
    partial sum is an integer far below 2^53), then the epilogue as separate
    torch operations, each rounding to float32."""
    k = w.shape[0]
    xd = x.permute(0, 3, 1, 2).to(torch.float64)
    wd = w.permute(3, 2, 0, 1).to(torch.float64)
    acc = F.conv2d(xd, wd, stride=stride, padding=k // 2).permute(0, 2, 3, 1).to(torch.int32)
    if epilogue == "acc":
        return acc.contiguous()
    y = acc.float() * sw + b
    if epilogue == "logits":
        return y.to(torch.bfloat16).contiguous()
    h = 0.5 * y
    return quant(h * (torch.tanh(h) + 1.0), s_out).contiguous()
