"""YOLOv8 detector (CSPDarknet + PAN + decoupled DFL head) in PyTorch.

Port of :mod:`wtracker_tpu.models.yolov8`: the same module tree, layer names
and arithmetic, so Flax weights carry over one to one
(:func:`wtracker_tpu_torch.convert.yolov8_from_flax`).

Layouts at the public functions are the JAX package's: images are NHWC
``(B, H, W, 3)``, per-level logits come back NHWC, boxes are ``(B, 4)``.
Inside :class:`YoloV8` the tensors are NCHW (a permuted view, no copy).

The compute dtype is the dtype of the module's parameters: cast the module
with ``.to(torch.bfloat16)`` for the bf16 detector (the JAX package keeps
float32 parameters and casts them to its ``compute_dtype`` at each layer,
which gives the same values).  The one place that needs the float32 values
of a cast model is the folded stem, which sums the stem kernel over its input
channels before rounding: :class:`YoloV8` keeps a float32 copy of ``b0``'s
weight and bias across casts (:meth:`YoloV8.stem_float32`).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wtracker_tpu_torch.ops.image import _interp_matrix, letterbox
from wtracker_tpu_torch.utils import flax_init
from wtracker_tpu_torch.utils.device import resolve_device

# scale presets: (depth_multiple, width_multiple, max_channels)
SCALES = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}

STRIDES = (8, 16, 32)


def _make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as ``0.5·x·(tanh(x/2)+1)``, the JAX package's form of x·σ(x)."""
    return 0.5 * x * (torch.tanh(0.5 * x) + 1.0)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + SiLU (NCHW).  ``fused=True``: biased conv + SiLU,
    the deployment form after :func:`fuse_conv_bn`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=fused)
        # Flax BatchNorm(epsilon=1e-3, momentum=0.97) = torch momentum 0.03
        self.bn = None if fused else nn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return _silu(x)


class Bottleneck(nn.Module):
    """Two 3x3 ConvBN blocks with an optional residual."""

    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True, fused: bool = False):
        super().__init__()
        self.cv1 = ConvBN(in_ch, out_ch, 3, fused=fused)
        self.cv2 = ConvBN(out_ch, out_ch, 3, fused=fused)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage-partial block: split, chain bottlenecks, concat, fuse."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, shortcut: bool = False, fused: bool = False):
        super().__init__()
        self.hidden = hidden = out_ch // 2
        self.n = n
        self.cv1 = ConvBN(in_ch, 2 * hidden, 1, fused=fused)
        for i in range(n):  # named m_{i} like the Flax tree
            setattr(self, f"m_{i}", Bottleneck(hidden, hidden, shortcut, fused=fused))
        self.cv2 = ConvBN((2 + n) * hidden, out_ch, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).split(self.hidden, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools, concatenated."""

    def __init__(self, in_ch: int, out_ch: int, pool: int = 5, fused: bool = False):
        super().__init__()
        hidden = in_ch // 2
        self.pool = pool
        self.cv1 = ConvBN(in_ch, hidden, 1, fused=fused)
        self.cv2 = ConvBN(4 * hidden, out_ch, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):  # implicit -inf padding, as Flax max_pool pads
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


class DetectHead(nn.Module):
    """Decoupled per-scale head: box-distribution branch + class branch."""

    def __init__(self, in_chs: Sequence[int], nc: int, reg_max: int = 16, fused: bool = False):
        super().__init__()
        self.n_levels = len(in_chs)
        c2 = max(16, in_chs[0] // 4, reg_max * 4)
        c3 = max(in_chs[0], min(nc, 100))
        for i, ch in enumerate(in_chs):
            setattr(self, f"cv2_{i}_0", ConvBN(ch, c2, 3, fused=fused))
            setattr(self, f"cv2_{i}_1", ConvBN(c2, c2, 3, fused=fused))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            setattr(self, f"cv3_{i}_0", ConvBN(ch, c3, 3, fused=fused))
            setattr(self, f"cv3_{i}_1", ConvBN(c3, c3, 3, fused=fused))
            setattr(self, f"cv3_{i}_2", nn.Conv2d(c3, nc, 1))

    def forward(self, feats: Sequence[torch.Tensor]):
        box_out, cls_out = [], []
        for i, f in enumerate(feats):
            b = f
            c = f
            for j in range(3):
                b = getattr(self, f"cv2_{i}_{j}")(b)
                c = getattr(self, f"cv3_{i}_{j}")(c)
            box_out.append(b)
            cls_out.append(c)
        return box_out, cls_out


def _drop_stem_copy(module: "YoloV8", _incompatible_keys) -> None:
    """Weights loaded into a cast model would leave its float32 stem copy
    stale: drop it, so :meth:`YoloV8.stem_float32` raises instead."""
    module._stem_f32 = None


class YoloV8(nn.Module):
    """Full detector graph: NHWC ``(B, H, W, 3)`` images → per-level NHWC
    ``(box_logits, cls_logits)``."""

    def __init__(self, nc: int = 1, scale: str = "s", reg_max: int = 16, fused: bool = False):
        super().__init__()
        self.nc, self.scale, self.reg_max, self.fused = nc, scale, reg_max, fused
        depth, width, max_ch = SCALES[scale]

        def chn(c):
            return _make_divisible(min(c, max_ch) * width)

        def rep(n):
            return max(round(n * depth), 1)

        kw = dict(fused=fused)
        c64, c128, c256, c512, c1024 = chn(64), chn(128), chn(256), chn(512), chn(1024)
        self.b0 = ConvBN(3, c64, 3, 2, **kw)  # /2
        self.b1 = ConvBN(c64, c128, 3, 2, **kw)  # /4
        self.b2 = C2f(c128, c128, rep(3), True, **kw)
        self.b3 = ConvBN(c128, c256, 3, 2, **kw)  # /8
        self.b4 = C2f(c256, c256, rep(6), True, **kw)
        self.b5 = ConvBN(c256, c512, 3, 2, **kw)  # /16
        self.b6 = C2f(c512, c512, rep(6), True, **kw)
        self.b7 = ConvBN(c512, c1024, 3, 2, **kw)  # /32
        self.b8 = C2f(c1024, c1024, rep(3), True, **kw)
        self.b9 = SPPF(c1024, c1024, 5, **kw)
        # PAN neck: top-down, then bottom-up
        self.n12 = C2f(c1024 + c512, c512, rep(3), False, **kw)
        self.n15 = C2f(c512 + c256, c256, rep(3), False, **kw)
        self.n16 = ConvBN(c256, c256, 3, 2, **kw)
        self.n18 = C2f(c256 + c512, c512, rep(3), False, **kw)
        self.n19 = ConvBN(c512, c512, 3, 2, **kw)
        self.n21 = C2f(c512 + c1024, c1024, rep(3), False, **kw)
        self.head = DetectHead((c256, c512, c1024), nc, reg_max, **kw)
        # float32 copy of b0's parameters and buffers while they are in
        # another dtype (see _apply); None while they are float32
        self._stem_f32: dict | None = None
        self.register_load_state_dict_post_hook(_drop_stem_copy)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.b1.conv.weight.dtype

    def _apply(self, fn, recurse=True):
        """Every ``.to``/``.cuda``/``.float`` goes through here: keep b0's
        float32 values when the cast leaves float32, move them with the
        module otherwise, and put them back when a cast returns to float32."""
        was_f32 = self.b0.conv.weight.dtype == torch.float32
        keep = {k: v.detach().clone() for k, v in self.b0.state_dict().items()} if was_f32 else self._stem_f32
        out = super()._apply(fn, recurse)
        w = self.b0.conv.weight
        if w.dtype == torch.float32:
            if keep is not None and not was_f32:
                self.b0.load_state_dict(keep)
            self._stem_f32 = None
        else:
            self._stem_f32 = None if keep is None else {k: v.to(w.device) for k, v in keep.items()}
        return out

    def stem_state_float32(self) -> dict:
        """``b0``'s state dict (``conv.weight``, ``bn.running_var``, ...) in
        float32: the model's own values while it is float32, else the copy
        kept when it was cast (the JAX package's parameters stay float32
        whatever its compute dtype)."""
        if self.b0.conv.weight.dtype == torch.float32:
            return self.b0.state_dict()
        if self._stem_f32 is None:
            raise ValueError(
                f"the stem's float32 values are unknown: the model was cast to {self.b0.conv.weight.dtype} "
                "and then loaded; load the weights in float32 before the cast"
            )
        return self._stem_f32

    def stem_float32(self) -> dict:
        """``{"weight": (out, 3, 3, 3), "bias": (out,) or None}`` of ``b0``'s
        conv in float32 (:meth:`stem_state_float32`)."""
        state = self.stem_state_float32()
        return {"weight": state["conv.weight"], "bias": state.get("conv.bias")}

    def forward(self, x: torch.Tensor, external_stem: bool = False):
        """``external_stem=True``: ``x`` is the NHWC output of ``b0`` (the
        folded stem, :func:`make_folded_detect`), and the graph starts at
        ``b1``; the JAX package's ``YoloV8(external_stem=True)``."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if not external_stem:
            x = self.b0(x)
        x = self.b2(self.b1(x))
        p3 = self.b4(self.b3(x))
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))

        def up2(t):  # x2 nearest: output pixel i reads input pixel i // 2
            return F.interpolate(t, scale_factor=2, mode="nearest")

        n4 = self.n12(torch.cat([up2(p5), p4], dim=1))
        n3 = self.n15(torch.cat([up2(n4), p3], dim=1))  # /8 out
        n4out = self.n18(torch.cat([self.n16(n3), n4], dim=1))  # /16 out
        n5out = self.n21(torch.cat([self.n19(n4out), p5], dim=1))  # /32 out
        box, cls = self.head([n3, n4out, n5out])
        nhwc = [t.permute(0, 2, 3, 1) for t in box], [t.permute(0, 2, 3, 1) for t in cls]
        return nhwc


# ---------------------------------------------------------------------------
# BatchNorm folding (inference deployment)
# ---------------------------------------------------------------------------


@torch.no_grad()
def fuse_conv_bn(model: YoloV8) -> YoloV8:
    """Fold every ConvBN's BatchNorm into its conv weight + bias.

    Returns a new ``fused=True`` model on the same device and dtype:
    ``W' = W · s/√(v+ε)``, ``b' = β − μ·s/√(v+ε)``, computed in float32 in the
    JAX package's order.  ``b0`` of a cast model is fused from its kept
    float32 values (:meth:`YoloV8.stem_state_float32`).
    """
    fused = YoloV8(model.nc, model.scale, model.reg_max, fused=True)
    src = dict(model.named_modules())
    if model.b0.conv.weight.dtype != torch.float32:  # b0 from its float32 copy
        src["b0"] = copy.deepcopy(model.b0).float()
        src["b0"].load_state_dict(model.stem_state_float32())
    state = {}
    for name, mod in fused.named_modules():
        if isinstance(mod, ConvBN):
            old = src[name]
            w = old.conv.weight.float()
            if old.bn is None:
                bias = old.conv.bias.float()
            else:
                bn = old.bn
                factor = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
                w = w * factor[:, None, None, None]
                bias = bn.bias.float() - bn.running_mean.float() * factor
            state[f"{name}.conv.weight"] = w
            state[f"{name}.conv.bias"] = bias
        elif isinstance(mod, nn.Conv2d) and not name.endswith(".conv"):
            old = src[name]
            state[f"{name}.weight"] = old.weight.float()
            state[f"{name}.bias"] = old.bias.float()
    fused.load_state_dict(state)
    ref = model.b1.conv.weight
    return fused.to(device=ref.device, dtype=ref.dtype).eval()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def make_anchors(imgsz: tuple[int, int], strides: Sequence[int] = STRIDES, offset: float = 0.5):
    """Anchor-center coordinates (in stride units) and per-anchor strides
    (host numpy, float32)."""
    points, strd = [], []
    h, w = imgsz
    for s in strides:
        gh, gw = h // s, w // s
        ys, xs = np.meshgrid(np.arange(gh) + offset, np.arange(gw) + offset, indexing="ij")
        points.append(np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1))
        strd.append(np.full((gh * gw, 1), s, dtype=np.float32))
    return np.concatenate(points, 0).astype(np.float32), np.concatenate(strd, 0)


def decode_predictions(
    box_logits: Sequence[torch.Tensor],
    cls_logits: Sequence[torch.Tensor],
    imgsz: tuple[int, int],
    reg_max: int = 16,
):
    """DFL decode of NHWC per-level logits: (B, A, 4) float32 xyxy boxes in
    input pixels and (B, A, nc) sigmoid scores, anchors in level order."""
    b = box_logits[0].shape[0]
    dev = box_logits[0].device
    box_flat = torch.cat([t.reshape(b, -1, 4 * reg_max) for t in box_logits], dim=1)
    cls_flat = torch.cat([t.reshape(b, -1, t.shape[-1]) for t in cls_logits], dim=1)

    anchors, strides = (torch.from_numpy(a).to(dev) for a in make_anchors(imgsz))
    dist = box_flat.reshape(b, -1, 4, reg_max).float()
    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    e = torch.exp(dist - dist.amax(dim=-1, keepdim=True))
    ltrb = (e * bins).sum(dim=-1) / e.sum(dim=-1)  # (B, A, 4)

    tl = (anchors[None] - ltrb[..., :2]) * strides[None]
    br = (anchors[None] + ltrb[..., 2:]) * strides[None]
    return torch.cat([tl, br], dim=-1), torch.sigmoid(cls_flat.float())


def decode_top1(
    box_logits: Sequence[torch.Tensor],
    cls_logits: Sequence[torch.Tensor],
    imgsz: tuple[int, int],
    reg_max: int = 16,
    strides: Sequence[int] = STRIDES,
):
    """Top-1 decode of NHWC per-level logits: best xyxy box (B, 4) float32 +
    its sigmoid score (B,).

    The winning anchor is picked on raw class logits, level by level, with
    first-maximum tie-breaks within a level and across levels (concatenation
    order); the DFL expectation runs for that one anchor only.  Anchor
    centres are computed from the winning index on the device (the same
    values as :func:`make_anchors`), so no table crosses from the host.
    """
    del imgsz  # the feature maps carry the grid
    b = box_logits[0].shape[0]
    dev = box_logits[0].device
    rows = torch.arange(b, device=dev)

    lvl_best, lvl_dist, lvl_anchor, lvl_stride = [], [], [], []
    for box_t, cls_t, s in zip(box_logits, cls_logits, strides):
        gw = cls_t.shape[2]
        top_l = cls_t.float().amax(dim=-1).reshape(b, -1)  # (B, Al)
        idx_l = top_l.argmax(dim=-1)  # first maximum
        iy, ix = idx_l // gw, idx_l % gw
        lvl_best.append(top_l[rows, idx_l])
        lvl_dist.append(box_t[rows, iy, ix])  # (B, 4·reg_max)
        lvl_anchor.append(torch.stack([ix, iy], dim=-1).float() + 0.5)
        lvl_stride.append(torch.full((b, 1), float(s), dtype=torch.float32, device=dev))

    best = torch.stack(lvl_best, dim=1)  # (B, L)
    lvl = best.argmax(dim=-1)
    best_score = torch.sigmoid(best[rows, lvl])

    dist = torch.stack(lvl_dist, dim=1)[rows, lvl].float().reshape(b, 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    e = torch.exp(dist - dist.amax(dim=-1, keepdim=True))
    ltrb = (e * bins).sum(dim=-1) / e.sum(dim=-1)  # (B, 4)

    anchor = torch.stack(lvl_anchor, dim=1)[rows, lvl]
    stride = torch.stack(lvl_stride, dim=1)[rows, lvl]
    tl = (anchor - ltrb[:, :2]) * stride
    br = (anchor + ltrb[:, 2:]) * stride
    return torch.cat([tl, br], dim=-1), best_score


def top1_source_boxes(
    box_logits,
    cls_logits,
    imgsz: tuple[int, int],
    reg_max: int,
    geometry: tuple[float, int, int],
    conf: float,
) -> torch.Tensor:
    """Top-1 decode → letterbox un-mapping → confidence mask: (B, 4) float32
    xywh in source pixels, NaN rows below ``conf``.  ``geometry`` is the
    letterbox ``(scale, pad_top, pad_left)``: numbers shared by the batch, or
    (B,) float32 tensors, one geometry a view (mixed-geometry batches)."""
    scale, pad_top, pad_left = geometry
    best_box, best_score = decode_top1(box_logits, cls_logits, imgsz, reg_max)
    if isinstance(scale, torch.Tensor):
        scale = scale[:, None]
    xy = torch.stack([best_box[:, 0] - pad_left, best_box[:, 1] - pad_top], dim=-1) / scale
    wh = (best_box[:, 2:] - best_box[:, :2]) / scale
    out = torch.cat([xy, wh], dim=-1)
    return torch.where((best_score >= conf)[:, None], out, torch.nan)


def stem_weff(stem_weight: torch.Tensor) -> torch.Tensor:
    """Channel-summed (9, out_ch) float32 stem kernel for the folded-stem
    matmul chain, taps in ``p·3 + q`` order (grayscale sources broadcast to 3
    identical channels, so the kernel's input-channel axis sums out).
    ``stem_weight`` is the (out, 3, 3, 3) conv weight in float32: the sum is
    taken before any rounding to the compute dtype."""
    return stem_weight.float().sum(dim=1).permute(1, 2, 0).reshape(9, -1)


# ---------------------------------------------------------------------------
# preprocessing (letterbox) and the end-to-end detector
# ---------------------------------------------------------------------------


def letterbox_params(src_hw: tuple[int, int], dst_hw: tuple[int, int]):
    """Scale + padding of a ratio-preserving letterbox resize (pad value 114):
    ``(scale, new_h, new_w, pad_top, pad_left)``."""
    sh, sw = src_hw
    dh, dw = dst_hw
    scale = min(dh / sh, dw / sw)
    new_h, new_w = round(sh * scale), round(sw * scale)
    pad_top = (dh - new_h) // 2
    pad_left = (dw - new_w) // 2
    return scale, new_h, new_w, pad_top, pad_left


def preprocess_batch(frames: torch.Tensor, imgsz: tuple[int, int], dtype=torch.float32):
    """uint8 (B, H, W[, C]) frames → normalized letterboxed (B, h, w, 3)
    ``dtype`` plus the (scale, pad_top, pad_left) geometry."""
    return letterbox(frames, imgsz, dtype=dtype)


def detect_top1_preprocessed(
    model: YoloV8,
    x: torch.Tensor,
    geometry: tuple[float, int, int],
    imgsz: tuple[int, int],
    conf: float,
) -> torch.Tensor:
    """Top-1 detection on an already-letterboxed (B, h, w, 3) tensor, e.g.
    the output of :func:`wtracker_tpu_torch.ops.preproc.crop_letterbox_views`."""
    box_logits, cls_logits = model(x)
    return top1_source_boxes(box_logits, cls_logits, imgsz, model.reg_max, geometry, conf)


def detect_top1(model: YoloV8, frames: torch.Tensor, imgsz: tuple[int, int], conf: float) -> torch.Tensor:
    """(B, H, W[, C]) uint8 frames → (B, 4) xywh in source pixels; NaN rows
    when the best score is below ``conf``."""
    x, geometry = preprocess_batch(frames, imgsz, dtype=model.compute_dtype)
    return detect_top1_preprocessed(model, x, geometry, imgsz, conf)


# ---------------------------------------------------------------------------
# folded stem: b0 computed as part of the letterbox matmuls
# ---------------------------------------------------------------------------


class FoldedStem(NamedTuple):
    """Geometry part of the letterbox + stem-conv fusion (weight-free).

    For grayscale sources the letterbox is two constant matmuls
    ``img = Ah @ V @ Awᵀ`` (:mod:`wtracker_tpu_torch.ops.image`), and each of
    the nine taps of the 3×3 stride-2 stem conv is a row/column-shifted
    variant of the same product, so the stem output is exactly

        z[b, y, x, oc] = Σ_{p,q} Weff[p·3+q, oc] · (Ah[2y+p-1] @ V[b] @ Aw[2x+q-1]ᵀ)

    — twelve matmuls plus a (9 → out_ch) projection, with no (B, h, w, 3)
    letterboxed tensor and no 3-channel convolution.  Only the interpolation
    matrices live here; ``Weff`` is computed from the model at each call.
    """

    by: torch.Tensor  # (3, h/2, src_h) row matrices, 1/255 normalize folded in
    bx: torch.Tensor  # (3, w/2, src_w) column matrices
    geometry: tuple  # (scale, pad_top, pad_left) of the letterbox


def _shifted(a: np.ndarray, tap: int, n_out: int) -> np.ndarray:
    """Rows ``2i + tap - 1`` of ``a`` (stride 2, pad 1), zero outside."""
    m = np.zeros((n_out, a.shape[1]), np.float32)
    r = 2 * np.arange(n_out) + tap - 1
    ok = (r >= 0) & (r < a.shape[0])
    m[ok] = a[r[ok]]
    return m


@lru_cache(maxsize=16)
def _fold_stem_matrices(src_hw, imgsz, dtype, device):
    scale, new_h, new_w, pad_top, pad_left = letterbox_params(src_hw, imgsz)
    if (new_h, new_w) != imgsz or pad_top or pad_left or new_h % 2 or new_w % 2:
        return None
    ah = _interp_matrix(src_hw[0], new_h) * np.float32(1.0 / 255.0)
    aw = _interp_matrix(src_hw[1], new_w)
    by = np.stack([_shifted(ah, t, new_h // 2) for t in range(3)])
    bx = np.stack([_shifted(aw, t, new_w // 2) for t in range(3)])
    by, bx = (torch.tensor(m, dtype=torch.float32, device=device).to(dtype) for m in (by, bx))
    return FoldedStem(by, bx, (scale, pad_top, pad_left))


def fold_stem_matrices(
    src_hw: tuple[int, int],
    imgsz: tuple[int, int],
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> FoldedStem | None:
    """The :class:`FoldedStem` matrices on ``device``, built in float32 and
    rounded once to ``dtype``, or ``None`` when the letterbox pads (source
    and target aspect ratios differ) or the target size is odd.  Cached per
    geometry, dtype and device: callers must not modify the tensors."""
    return _fold_stem_matrices(tuple(src_hw), tuple(imgsz), dtype, resolve_device(device))


def stem_apply_weff(folded: FoldedStem, weff: torch.Tensor, bias: torch.Tensor, views: torch.Tensor) -> torch.Tensor:
    """Folded-stem matmul chain on a channel-summed (9, out_ch) float32
    kernel: (B, H, W[, 1]) views → (B, h/2, w/2, out_ch) in the matrices'
    dtype.

    As in the JAX package, the views, ``weff`` and both intermediate
    products are rounded to the compute dtype and the bias is added in
    float32.  The products run in float32 on the rounded values (exact
    products, float32 sums: the JAX package's einsums with
    ``preferred_element_type=float32``).
    """
    if views.ndim == 4:  # tolerate a trailing singleton channel
        views = views[..., 0]
    dt = folded.by.dtype
    v = views.to(dt).float()
    u = torch.einsum("pyh,bhw->pbyw", folded.by.float(), v).to(dt).float()
    t = torch.einsum("pbyw,qxw->byxpq", u, folded.bx.float()).to(dt).float()
    b, h, w = t.shape[:3]
    z = torch.matmul(t.reshape(b, h, w, 9), weff.to(dt).float())
    return _silu((z + bias.float()).to(dt))


def stem_apply(folded: FoldedStem, stem_params: dict, views: torch.Tensor) -> torch.Tensor:
    """(B, H, W) grayscale views → (B, h/2, w/2, out_ch) stem output.
    ``stem_params`` is the BN-fused ``b0`` conv in float32,
    ``{"weight", "bias"}`` (:meth:`YoloV8.stem_float32`)."""
    return stem_apply_weff(folded, stem_weff(stem_params["weight"]), stem_params["bias"], views)


def can_fold_stem(model: YoloV8) -> bool:
    """BN-fused model with the standard 3×3×3 stem kernel?"""
    conv = model.b0.conv
    return model.fused and conv.bias is not None and tuple(conv.weight.shape[1:]) == (3, 3, 3)


def make_folded_detect(model: YoloV8, src_hw: tuple[int, int], imgsz: tuple[int, int]):
    """Engine-hook detect function running the folded-stem graph, or
    ``None`` where the geometry pads.

    Returns ``detect(model, views, imgsz, conf) -> (B, 4)`` xywh (the
    engines' ``detect_fn`` contract); its ``imgsz`` argument is ignored in
    favour of the folded geometry, and the model argument supplies the
    weights.  The matrices are built on ``model``'s device in its compute
    dtype.  Requires a BN-fused model (check with :func:`can_fold_stem`).
    ``detect.folds_preproc`` is ``True``: the engines hand it raw views, not
    the crop+letterbox kernel's output.
    """
    folded = fold_stem_matrices(src_hw, imgsz, dtype=model.compute_dtype, device=model.b1.conv.weight.device)
    if folded is None:
        return None

    def detect(model, views, _imgsz, conf):
        z = stem_apply(folded, model.stem_float32(), views)
        box_logits, cls_logits = model(z, external_stem=True)
        return top1_source_boxes(box_logits, cls_logits, imgsz, model.reg_max, folded.geometry, conf)

    detect.folds_preproc = True
    return detect


@dataclass
class YoloV8Detector:
    """End-to-end worm-head detector: preprocess → forward → decode → top-1.

    The model holds its weights (the JAX package's ``variables`` argument has
    no counterpart here).
    """

    model: YoloV8
    imgsz: tuple[int, int] = (384, 384)
    conf: float = 0.1

    @torch.inference_mode()
    def detect(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W[, C]) uint8 → (B, 4) xywh in source pixels; NaN = no hit."""
        return detect_top1(self.model, frames, self.imgsz, self.conf)

    @torch.inference_mode()
    def raw(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every anchor's decoded box and scores (:func:`decode_predictions`),
        on a float32 letterbox, as the JAX package's ``raw``."""
        x, _ = preprocess_batch(frames, self.imgsz)
        box_logits, cls_logits = self.model(x)
        return decode_predictions(box_logits, cls_logits, self.imgsz, self.model.reg_max)

    def fuse(self) -> "YoloV8Detector":
        """Inference-fused copy: BN folded into conv weights and biases."""
        return YoloV8Detector(fuse_conv_bn(self.model), self.imgsz, self.conf)

    def to(self, dtype: torch.dtype) -> "YoloV8Detector":
        """Copy computing in ``dtype`` (e.g. ``torch.bfloat16``)."""
        return YoloV8Detector(copy.deepcopy(self.model).to(dtype), self.imgsz, self.conf)

    @staticmethod
    def init_random(
        nc: int = 1,
        scale: str = "s",
        imgsz: int | tuple[int, int] = (384, 384),
        conf: float = 0.1,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> "YoloV8Detector":
        """Fresh float32 detector holding the weights that the JAX package's
        ``init_random`` draws from the same seed (Flax's default init, drawn
        in numpy: :func:`_flax_init`)."""
        dev = resolve_device(device)
        if isinstance(imgsz, int):
            imgsz = (imgsz, imgsz)
        model = YoloV8(nc=nc, scale=scale)
        _flax_init(model, seed)
        return YoloV8Detector(model.to(dev).eval(), tuple(imgsz), conf)

    @staticmethod
    def load(
        path: str,
        imgsz: int | tuple[int, int] = 384,
        conf: float = 0.1,
        device: str | torch.device = "cuda",
    ) -> "YoloV8Detector":
        """Load float32 weights, chosen by the file's suffix as the JAX
        package does: a ``.pt`` state dict in the ultralytics layout
        (:func:`wtracker_tpu_torch.models.yolo_port.load_ultralytics_checkpoint`),
        else a Flax ``.npz`` export (``__meta__`` plus ``/``-joined keys, as
        either package's :meth:`save` writes it)."""
        dev = resolve_device(device)
        if isinstance(imgsz, int):
            imgsz = (imgsz, imgsz)
        if str(path).endswith(".pt"):
            from wtracker_tpu_torch.models.yolo_port import load_ultralytics_checkpoint

            return load_ultralytics_checkpoint(path, imgsz=imgsz, conf=conf, device=dev)
        from wtracker_tpu_torch.convert import load_flax_npz, yolov8_from_flax

        meta, variables = load_flax_npz(path)
        state = yolov8_from_flax(variables)
        fused = not any(k.endswith(".bn.weight") for k in state)
        model = YoloV8(nc=meta["nc"], scale=meta["scale"], fused=fused)
        model.load_state_dict(state)
        return YoloV8Detector(model.to(dev).eval(), imgsz, conf)

    def save(self, path: str) -> None:
        """Write the JAX package's ``.npz`` layout: ``__meta__`` (nc, scale)
        plus the Flax variables under ``/``-joined keys, float32."""
        from wtracker_tpu_torch.convert import state_dict_to_flax_flat

        m = self.model
        if m.b0.conv.weight.dtype != torch.float32:
            raise ValueError(f"save a float32 model, not a {m.b0.conv.weight.dtype} one (cast it back first)")
        flat = state_dict_to_flax_flat(m.state_dict())
        flat["__meta__"] = np.array({"nc": m.nc, "scale": m.scale}, dtype=object)
        np.savez(path, **flat)


# Flax's constant bias inits of the head's last convolutions: box bins start
# at 1.0, class logits at a ~1 % objectness prior
_HEAD_BIAS_INIT = {"cv2": 1.0, "cv3": -4.595}


def _flax_init(model: YoloV8, seed: int) -> None:
    """The weights of the JAX package's ``YoloV8.init(PRNGKey(seed), ...)``:
    each convolution kernel ``lecun_normal`` over fan-in kh·kw·Cin, drawn in
    Flax's (kh, kw, Cin, Cout) layout from the key of its module path
    (:mod:`wtracker_tpu_torch.utils.flax_init`); the head's constant biases;
    BatchNorm at identity, as torch's starts."""
    root = flax_init.key(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, nn.Conv2d):
                continue
            out_ch, in_ch, kh, kw = mod.weight.shape
            kernel = flax_init.lecun_normal(flax_init.param_key(root, tuple(name.split(".")), 1), (kh, kw, in_ch, out_ch))
            mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
            if mod.bias is not None:  # before fusing, only the head's last convolutions have one
                mod.bias.fill_(_HEAD_BIAS_INIT[name.split(".")[-1][:3]])
