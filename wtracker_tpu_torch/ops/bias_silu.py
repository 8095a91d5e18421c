"""Bias + SiLU after a BN-fused convolution, in place: the detector's epilogue.

The JAX package's ``ConvBN`` with fused weights (``wtracker_tpu/models/yolov8.py``)
adds the bias and applies SiLU, ``0.5·y·(tanh(0.5·y) + 1)``, after each
convolution; XLA fuses both into the convolution.  On the card cuDNN returns
the convolution, and eager PyTorch would add the bias and evaluate SiLU in six
passes over the activation.  :func:`bias_silu_` does both in one, with the
hand-written kernel ``csrc/bias_silu.cu``; :func:`bias_silu_reference` is its
plain version.  Both compute in float32 and round once to the tensor's dtype.
There is no fallback from the kernel: a tensor that it cannot take raises.

:class:`~wtracker_tpu_torch.models.yolov8.ConvBN` calls it for a BN-fused
convolution on the card with autograd off; its CPU and training paths keep
the eager form (``_silu``).
"""

from __future__ import annotations

import torch

DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 12288  # kMaxChannels of csrc/bias_silu.cu: float32 biases in 48 KB of shared memory


def layout(x: torch.Tensor) -> str | None:
    """``"channels_last"`` or ``"contiguous"`` (NCHW) for a 4-D tensor dense
    in that layout, else None.  A tensor dense in both (one channel, or one
    pixel a channel) puts each element in the same channel either way."""
    if x.dim() != 4:
        return None
    if x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return "contiguous" if x.is_contiguous() else None


def _check(x: torch.Tensor, bias: torch.Tensor) -> str:
    kind = layout(x)
    if kind is None:
        raise ValueError(
            f"x must be a 4-D tensor, dense channels-last or NCHW-contiguous, got shape {tuple(x.shape)} "
            f"strides {x.stride()}"
        )
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {DTYPES}, got {x.dtype}")
    c = x.shape[1]
    if bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(
            f"bias must be a contiguous ({c},) {x.dtype} tensor on {x.device}, got {tuple(bias.shape)} "
            f"{bias.dtype} on {bias.device}"
        )
    if c > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {c}")
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned (a fresh tensor does; a view into one may not)")
    return kind


def bias_silu_(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x ← silu(x + bias[c])`` in place, computed in float32 and rounded
    once; returns ``x``.

    Args:
        x: (N, C, H, W) CUDA bfloat16 or float32, dense channels-last or
            NCHW-contiguous (the two layouts a convolution returns), 16-byte
            aligned.
        bias: (C,) of ``x``'s dtype and device, contiguous.

    It allocates nothing; every launch of the kernel adds one to
    ``bias_silu_.launches``.
    """
    kind = _check(x, bias)
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    if x.numel():
        from wtracker_tpu_torch.ops import _build

        n, c, h, w = x.shape
        err = _build.load("bias_silu").bias_silu(
            x.data_ptr(), bias.data_ptr(), x.numel(), c, h * w, int(kind == "contiguous"),
            int(x.dtype == torch.bfloat16), _build.sm_count(x.device), torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"bias_silu kernel launch failed with CUDA error {err}")
        bias_silu_.launches += 1
    return x


bias_silu_.launches = 0


def bias_silu_reference(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: ``y = float32(x) + float32(bias[c])``, then
    ``0.5·y·(tanh(0.5·y) + 1)`` in float32, rounded to ``x``'s dtype."""
    y = x.float() + bias.float().view(1, -1, 1, 1)
    return (0.5 * y * (torch.tanh(0.5 * y) + 1.0)).to(x.dtype)
