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

The kernel reads the weights packed once by :func:`pack_weights` (K-major,
as the int8 tensor cores take them), and each launch's tiles and K split
come from :func:`plan`, a function of the shape alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache

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


def _ceil(v: int, to: int) -> int:
    return -(-v // to) * to


# Mirrors of csrc/conv_s8.cu's constants (tests/test_torch_conv_s8.py reads
# them back from the source): pixels a block computes, as a tile of TILE_H
# output rows by TILE_W columns of one view, bytes of the reduction a stage
# holds, stages of the ring, int32 padding of a row of the reduction tile,
# blocks of a cluster.
BLOCK_ROWS = 128  # two 64-row warpgroups
TILE_W = 8
TILE_H = BLOCK_ROWS // TILE_W
BK = 64
STAGES = 4
RED_PAD = 4
MAX_SPLIT = 8
K_ALIGN = 32  # wgmma's k for int8: wp's rows are padded to it
COUT_ALIGN = 8  # wgmma's narrowest n: wp's columns are padded to it
BLOCK_COLS = (8, 32, 64, 128)  # output channels a block computes: the wgmma widths the kernel is built for
SMS = 132  # the H100's streaming multiprocessors: one wave of blocks
SMEM_LIMIT = 232_448  # shared memory a block may use (227 KB)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(k, k, Cin, Cout)`` → the kernel's K-major int8 weights
    ``wp[oc][kidx]``, ``kidx = (kh·k + kw)·Cin + ci`` (the order in which an
    NHWC pixel's taps lie in memory), of shape ``(ceil8(Cout), ceil32(k·k·Cin))``:
    the padding rows and columns are zeros."""
    k, _, cin, cout = w.shape
    kdim = k * k * cin
    wp = torch.zeros((_ceil(cout, COUT_ALIGN), _ceil(kdim, K_ALIGN)), dtype=torch.int8, device=w.device)
    wp[:cout, :kdim] = w.reshape(kdim, cout).t()
    return wp


@dataclass(frozen=True)
class Plan:
    """One convolution's launch: ``tiles`` pixel tiles (TILE_H × TILE_W
    output pixels of one view each) by ``bn`` output channels, the K steps
    of ``BK`` bytes split over ``split`` blocks of one cluster."""

    tiles: int
    cout: int
    kdim: int
    ksteps: int
    bn: int
    split: int

    @property
    def grid(self) -> tuple[int, int, int]:
        """Blocks of the one launch: pixel tiles, Cout tiles, K splits."""
        return (self.tiles, -(-self.cout // self.bn), self.split)

    @property
    def cluster(self) -> tuple[int, int, int]:
        """Blocks of a cluster: a tile's K splits, which add their sums in it."""
        return (1, 1, self.split)

    @property
    def smem_bytes(self) -> int:
        return max(STAGES * (BLOCK_ROWS + self.bn) * BK, BLOCK_ROWS * (self.bn + RED_PAD) * 4)

    def split_steps(self) -> list[int]:
        """K steps each block of a cluster sums (the kernel's partition)."""
        return [(z + 1) * self.ksteps // self.split - z * self.ksteps // self.split for z in range(self.split)]


@cache
def plan(n: int, h: int, w: int, cin: int, cout: int, k: int, stride: int) -> Plan:
    """The tile and K split of one convolution.  ``bn`` is the narrowest
    width the kernel is built for that covers Cout (128 above it).  Where
    the tiles fall below half a wave, K is split over a cluster of up to
    ``MAX_SPLIT`` blocks, never into more parts than it has steps, to reach
    about half a wave of blocks: on the H100 at 12 views no split measured
    slower, and splits toward a full wave no faster (``sweep_conv_s8.py``)."""
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    tiles = n * -(-ho // TILE_H) * -(-wo // TILE_W)
    kdim = k * k * cin
    ksteps = -(-_ceil(kdim, K_ALIGN) // BK)
    bn = next((b for b in BLOCK_COLS if b >= cout), BLOCK_COLS[-1])
    split = max(1, min(MAX_SPLIT, ksteps, -(-(SMS // 2) // (tiles * -(-cout // bn)))))
    return Plan(tiles=tiles, cout=cout, kdim=kdim, ksteps=ksteps, bn=bn, split=split)


def _check(x, w, stride, epilogue, sw, b, wp):
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
    if wp is not None:
        k, _, cin, cout = w.shape
        want = (_ceil(cout, COUT_ALIGN), _ceil(k * k * cin, K_ALIGN))
        if wp.dtype != torch.int8 or tuple(wp.shape) != want or not wp.is_contiguous():
            raise ValueError(
                f"wp {tuple(wp.shape)} {wp.dtype} is not the packed form of w {tuple(w.shape)}: "
                f"a contiguous int8 {want}, pack_weights(w)"
            )
        if wp.device != x.device:
            raise ValueError(f"wp is on {wp.device}, x on {x.device}")


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
            required for a CUDA tensor; on the CPU its layout is checked and
            its values are unread.

    Returns (N, Ho, Wo, Cout): int32, bf16 or int8.  Every launch of the
    kernel adds one to ``conv_s8.launches``.
    """
    _check(x, w, stride, epilogue, sw, b, wp)
    if epilogue == "silu_q" and s_out is None:
        raise ValueError("the silu_q epilogue needs s_out")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv_s8_reference(x, w, stride, epilogue, sw, b, s_out)
        raise ValueError(f"no kernel for device {x.device}")
    from wtracker_tpu_torch.ops import _build

    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    if wp is None:
        raise ValueError("the kernel takes the packed weights: pass wp=pack_weights(w), packed once")
    p = plan(n, h, wd, cin, cout, k, stride)
    pad = k // 2
    out = torch.empty(
        (n, (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1, cout),
        dtype=_OUT_DTYPES[epilogue], device=x.device,
    )
    sn, sh, spx, _ = x.stride()
    # TMA boxes of 32 channels: a box lies in one tap, base and strides 16-byte aligned
    vec = int(cin % 32 == 0 and all(v % 16 == 0 for v in (x.data_ptr(), sn, sh, spx)))
    dummy = wp  # sw/b are not read by the "acc" epilogue
    lib = _build.load("conv_s8")
    err = lib.conv_s8(
        x.data_ptr(), wp.data_ptr(), (sw if sw is not None else dummy).data_ptr(),
        (b if b is not None else dummy).data_ptr(), out.data_ptr(), n, h, wd, cin, sn, sh, spx, cout, k, stride,
        vec, EPILOGUES.index(epilogue), inv_scale(s_out) if epilogue == "silu_q" else 0.0, p.bn, p.split,
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
