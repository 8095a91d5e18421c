"""Image ops: matmul-form bilinear resizing, letterboxing, batched crops.

Port of :mod:`wtracker_tpu.ops.image`: the video loop's resize, letterbox
and crops, the mixed-geometry letterbox of the sweep engine
(:func:`make_letterbox_matrices`, :func:`letterbox_indexed`) and
:func:`replicate_pad`.  A bilinear resize of a fixed shape is two constant
interpolation matrices, ``out = A_h @ x @ A_wᵀ``; the matrices are built on
the host with the same float64 arithmetic as the JAX package and stored as
float32.

The products run in float32 even for a bfloat16 detector: products of
bfloat16 values are exact in float32, so this is the JAX package's bfloat16
einsum with ``preferred_element_type=float32``, and the results are rounded
to the working type at the same two places.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from wtracker_tpu_torch.utils.device import resolve_device


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix (half-pixel centers, the
    source clamped to ``[0, n_in - 1]``).  Read-only: the array is shared by
    every caller."""
    out = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = np.clip(lo, 0, n_in - 1)
        hi_c = np.clip(lo + 1, 0, n_in - 1)
        out[i, lo_c] += 1.0 - frac
        out[i, hi_c] += frac
    out.setflags(write=False)
    return out


@lru_cache(maxsize=64)
def _matrix(n_in: int, n_out: int, device: torch.device, dtype=torch.float32, factor=None) -> torch.Tensor:
    """:func:`_interp_matrix` as a tensor on ``device``, optionally scaled by
    a float32 ``factor`` before the cast to ``dtype``.  Cached, so a loop
    copies each matrix to the card once; callers must not modify it."""
    m = _interp_matrix(n_in, n_out)
    if factor is not None:
        m = m * np.float32(factor)
    return torch.tensor(m, dtype=torch.float32, device=device).to(dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear float32 resize of ``(..., H, W)`` or ``(..., H, W, C)`` images
    (C in 1 or 3) via two matmuls."""
    h_out, w_out = out_hw
    x = x.to(torch.float32)
    if x.ndim >= 3 and x.shape[-1] in (1, 3):
        a_h = _matrix(x.shape[-3], h_out, x.device)
        a_w = _matrix(x.shape[-2], w_out, x.device)
        y = torch.einsum("oh,...hwc->...owc", a_h, x)
        return torch.einsum("pw,...owc->...opc", a_w, y)
    a_h = _matrix(x.shape[-2], h_out, x.device)
    a_w = _matrix(x.shape[-1], w_out, x.device)
    y = torch.einsum("oh,...hw->...ow", a_h, x)
    return torch.einsum("pw,...ow->...op", a_w, y)


def letterbox(
    frames: torch.Tensor,
    imgsz: tuple[int, int],
    pad_value: float = 114 / 255.0,
    dtype=torch.float32,
) -> tuple[torch.Tensor, tuple[float, int, int]]:
    """Ratio-preserving resize + center padding of (B, H, W[, C]) frames.

    Returns normalized (B, h, w, 3) ``dtype`` in [0, 1] plus the (scale,
    pad_top, pad_left) geometry for mapping boxes back.  As in the JAX
    package, the 1/255 normalization is folded into the row matrix (rounded to
    ``dtype`` with it), gray inputs are resized as one channel and broadcast
    to 3 after padding, and the row pass is rounded to ``dtype`` before the
    column pass.
    """
    gray = frames.ndim == 3 or frames.shape[-1] == 1
    if frames.ndim == 4 and frames.shape[-1] == 1:
        frames = frames[..., 0]

    sh, sw = frames.shape[1:3]
    dh, dw = imgsz
    scale = min(dh / sh, dw / sw)
    new_h, new_w = round(sh * scale), round(sw * scale)
    pad_top = (dh - new_h) // 2
    pad_left = (dw - new_w) // 2
    pad_lrtb = (pad_left, dw - new_w - pad_left, pad_top, dh - new_h - pad_top)

    dev = frames.device
    a_h = _matrix(sh, new_h, dev, dtype, factor=1.0 / 255.0).to(torch.float32)
    a_w = _matrix(sw, new_w, dev, dtype).to(torch.float32)
    src = frames.to(dtype).to(torch.float32)

    if gray:
        y = torch.einsum("oh,bhw->bow", a_h, src).to(dtype).to(torch.float32)
        y = torch.einsum("pw,bow->bop", a_w, y).to(dtype)
        y = F.pad(y, pad_lrtb, value=pad_value)
        x = y[..., None].expand(*y.shape, 3)
    else:
        y = torch.einsum("oh,bhwc->bowc", a_h, src).to(dtype).to(torch.float32)
        y = torch.einsum("pw,bowc->bopc", a_w, y).to(dtype)
        x = F.pad(y, (0, 0, *pad_lrtb), value=pad_value)
    return x, (scale, pad_top, pad_left)


def crop_views(
    frames: torch.Tensor,
    top_lefts: torch.Tensor,
    view_hw: tuple[int, int],
    frame_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched crops: (B, H, W) frames + (B, 2) (x, y) → (B, h, w).

    With ``frame_idx`` (B,), ``frames`` is a (C, H, W) chunk and view ``i``
    is cut from ``frames[frame_idx[i]]`` without gathering whole frames
    first.  Crop origins are clamped into the frame, as
    ``jax.lax.dynamic_slice`` clamps them, and frame indices into the chunk.
    """
    h, w = view_hw
    H, W = frames.shape[-2:]
    dev = frames.device
    b = top_lefts.shape[0]
    if frame_idx is None:
        fi = torch.arange(b, device=dev)
    else:
        fi = frame_idx.long().clamp(0, frames.shape[0] - 1)
    x0 = top_lefts[:, 0].long().clamp(0, W - w)
    y0 = top_lefts[:, 1].long().clamp(0, H - h)
    rows = y0[:, None] + torch.arange(h, device=dev)
    cols = x0[:, None] + torch.arange(w, device=dev)
    return frames[fi[:, None, None], rows[:, :, None], cols[:, None, :]]


def make_letterbox_matrices(
    src_hws: list[tuple[int, int]],
    canvas_hw: tuple[int, int],
    imgsz: tuple[int, int],
    dtype=torch.float32,
    device: str | torch.device = "cuda",
):
    """Per-geometry letterbox operators for mixed-size view batches.

    Each source geometry ``(h, w)`` (content in the top-left of a shared
    ``canvas_hw`` canvas) gets a row matrix (imgsz_h, canvas_h) and a column
    matrix (imgsz_w, canvas_w) that perform its ratio-preserving resize and
    centre placement in one pair of matmuls; rows and columns that land in
    the padding are zero, and the coverage vectors give the pad fill weight
    (``1 − cov_y ⊗ cov_x``).  The 1/255 normalization is folded into the row
    matrices (in float32, then rounded to ``dtype``), as in :func:`letterbox`.

    Returns ``(mat_y, mat_x, cov_y, cov_x, geoms)`` stacked over geometries
    on ``device`` (matrices in ``dtype``, coverage in float32), with
    ``geoms`` the per-geometry ``(scale, pad_top, pad_left)``.
    """
    dev = resolve_device(device)
    ch, cw = canvas_hw
    dh, dw = imgsz
    mat_y, mat_x, cov_y, cov_x, geoms = [], [], [], [], []
    for sh, sw in src_hws:
        if sh > ch or sw > cw:
            raise ValueError(f"source {(sh, sw)} exceeds the canvas {canvas_hw}")
        scale = min(dh / sh, dw / sw)
        new_h, new_w = round(sh * scale), round(sw * scale)
        pad_top = (dh - new_h) // 2
        pad_left = (dw - new_w) // 2

        my = np.zeros((dh, ch), dtype=np.float32)
        my[pad_top : pad_top + new_h, :sh] = _interp_matrix(sh, new_h) * np.float32(1.0 / 255.0)
        mx = np.zeros((dw, cw), dtype=np.float32)
        mx[pad_left : pad_left + new_w, :sw] = _interp_matrix(sw, new_w)
        cy = np.zeros((dh,), dtype=np.float32)
        cy[pad_top : pad_top + new_h] = 1.0
        cx = np.zeros((dw,), dtype=np.float32)
        cx[pad_left : pad_left + new_w] = 1.0

        mat_y.append(my)
        mat_x.append(mx)
        cov_y.append(cy)
        cov_x.append(cx)
        geoms.append((scale, pad_top, pad_left))
    return (
        torch.tensor(np.stack(mat_y), device=dev).to(dtype),
        torch.tensor(np.stack(mat_x), device=dev).to(dtype),
        torch.tensor(np.stack(cov_y), device=dev),
        torch.tensor(np.stack(cov_x), device=dev),
        geoms,
    )


def letterbox_indexed(
    views: torch.Tensor,
    geom_ids: torch.Tensor,
    mat_y: torch.Tensor,
    mat_x: torch.Tensor,
    cov_y: torch.Tensor,
    cov_x: torch.Tensor,
    pad_value: float = 114 / 255.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Letterbox a batch of canvas views, each by its own geometry's operator.

    Args:
        views: (B, canvas_h, canvas_w) grayscale views in [0, 255].
        geom_ids: (B,) index into the matrices of :func:`make_letterbox_matrices`.

    Returns normalized (B, imgsz_h, imgsz_w, 3) ``dtype`` in [0, 1].  The
    products take ``dtype`` values and accumulate in float32 (batched
    float32 matmuls of the rounded values: a product of two bfloat16 values
    is exact in float32), rounded to ``dtype`` after each pass; the fill term
    is rounded to ``dtype`` and added in ``dtype``, as in the JAX package.
    """
    a_h = mat_y[geom_ids].to(torch.float32)  # (B, dh, ch)
    a_w = mat_x[geom_ids].to(torch.float32)  # (B, dw, cw)
    src = views.to(dtype).to(torch.float32)
    y = torch.bmm(a_h, src).to(dtype).to(torch.float32)
    y = torch.bmm(y, a_w.transpose(1, 2))
    fill = 1.0 - cov_y[geom_ids][:, :, None] * cov_x[geom_ids][:, None, :]
    y = y.to(dtype) + (fill * pad_value).to(dtype)
    return y[..., None].expand(*y.shape, 3)


def replicate_pad(frame: torch.Tensor, pad_xy: tuple[int, int]) -> torch.Tensor:
    """Edge-replicate padding of a (H, W, ...) frame by (pad_x, pad_y) on each
    side, for any dtype — the world padding of the view controller."""
    pad_x, pad_y = pad_xy
    h, w = frame.shape[:2]
    rows = torch.arange(-pad_y, h + pad_y, device=frame.device).clamp(0, h - 1)
    cols = torch.arange(-pad_x, w + pad_x, device=frame.device).clamp(0, w - 1)
    return frame[rows][:, cols]
