"""Fused camera crop → bilinear resize → normalize of the video loop.

Counterpart of :mod:`wtracker_tpu.ops.pallas_preproc`.  The wrapper
:func:`crop_letterbox_views` launches the hand-written CUDA kernel
``csrc/crop_letterbox.cu`` for CUDA tensors; it replaces the Pallas kernel
``wtracker_tpu/ops/pallas_preproc.py::crop_letterbox_views``.  For CPU
tensors it runs the plain version, :func:`crop_letterbox_reference`.  There
is no fallback from the kernel: a CUDA tensor that the kernel cannot take
raises.

The kernel reads its interpolation taps from :func:`tap_table`, which takes
them out of the plain version's matrix (:func:`~wtracker_tpu_torch.ops.image._interp_matrix`),
so both compute with the same weights.

The Pallas kernel's tile-aligned DMA window (``_win_hw``), its chunk padding
(``padded_chunk_hw``) and the folding of the residual shift into its
interpolation matrices are not ported: the CUDA kernel reads a crop at any
offset, so the frame chunk is stored unpadded.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from wtracker_tpu_torch.ops.image import _interp_matrix, crop_views, resize_bilinear

_INV255 = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))  # float32(1/255), exactly
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_MAX_VIEWS = 65535  # gridDim.y
BAND_ROWS = 4  # output rows of one view per block: kBandRows of csrc/crop_letterbox.cu


@lru_cache(maxsize=64)
def tap_table(cam: int, imgsz: int) -> tuple[np.ndarray, np.ndarray]:
    """The two taps of each output coordinate of a ``cam → imgsz`` resize.

    Returns ``(lo, hi)`` int32 source indices and ``(w_lo, w_hi)`` float32
    weights, each ``(imgsz, 2)``, read out of ``_interp_matrix(cam, imgsz)``:
    row ``o`` of the matrix is ``w_lo`` at ``lo`` plus ``w_hi`` at ``hi``.
    Where a row has one nonzero weight (at both clamped edges, and where the
    source coordinate is a pixel's centre) ``lo == hi`` and ``w_hi = 0``, so
    the kernel reads no source row that it weighs by 0.  Read-only: the
    arrays are shared by every caller.
    """
    m = _interp_matrix(cam, imgsz)
    rows = np.arange(imgsz)
    lo = (m != 0).argmax(axis=1)  # every row has a positive weight at its lower tap
    nxt = np.minimum(lo + 1, cam - 1)
    hi = np.where(m[rows, nxt] != 0, nxt, lo)
    w_hi = np.where(hi != lo, m[rows, hi], np.float32(0))
    idx = np.stack([lo, hi], axis=1).astype(np.int32)
    w = np.stack([m[rows, lo], w_hi], axis=1).astype(np.float32)
    idx.setflags(write=False)
    w.setflags(write=False)
    return idx, w


@lru_cache(maxsize=64)
def _device_taps(cam: int, imgsz: int, device: torch.device) -> torch.Tensor:
    """:func:`tap_table` packed as the kernel reads it, ``(imgsz, 4)`` 32-bit
    words ``(lo, hi, w_lo, w_hi)``, on ``device``.  Cached, so a loop copies
    it to the card once."""
    idx, w = tap_table(cam, imgsz)
    return torch.from_numpy(np.concatenate([idx, w.view(np.int32)], axis=1)).to(device)


@lru_cache(maxsize=64)
def _band_src_rows(cam: int, imgsz: int) -> int:
    """The most source rows that a band of ``BAND_ROWS`` output rows reads:
    the kernel's shared memory holds that many."""
    idx, _ = tap_table(cam, imgsz)
    starts = np.arange(0, imgsz, BAND_ROWS)
    ends = np.minimum(starts + BAND_ROWS, imgsz) - 1
    return int((idx[ends, 1] - idx[starts, 0]).max()) + 1


def _check(frames, frame_idx, top_lefts, cam: int, imgsz: int, out_dtype) -> None:
    if frames.dtype != torch.uint8 or frames.ndim != 3:
        raise ValueError(f"frames must be a (C, H, W) uint8 tensor, got {tuple(frames.shape)} {frames.dtype}")
    n = frame_idx.shape[0] if frame_idx.ndim == 1 else -1
    if frame_idx.dtype != torch.int32 or n < 0:
        raise ValueError(f"frame_idx must be an (N,) int32 tensor, got {tuple(frame_idx.shape)} {frame_idx.dtype}")
    if top_lefts.dtype != torch.int32 or tuple(top_lefts.shape) != (n, 2):
        raise ValueError(f"top_lefts must be an ({n}, 2) int32 tensor, got {tuple(top_lefts.shape)} {top_lefts.dtype}")
    if not (frame_idx.device == top_lefts.device == frames.device):
        raise ValueError("frames, frame_idx and top_lefts must be on one device")
    if not (frames.is_contiguous() and frame_idx.is_contiguous() and top_lefts.is_contiguous()):
        raise ValueError("frames, frame_idx and top_lefts must be contiguous")
    _, h, w = frames.shape
    if not (0 < cam <= min(h, w)) or not 0 < imgsz:
        raise ValueError(f"camera {cam} must fit the {h}x{w} frames and imgsz {imgsz} must be positive")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    if n > _MAX_VIEWS:
        raise ValueError(f"at most {_MAX_VIEWS} views per launch, got {n}")


def crop_letterbox_views(
    frames: torch.Tensor,
    frame_idx: torch.Tensor,
    top_lefts: torch.Tensor,
    cam: int,
    imgsz: int,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Fused preprocessing of N square camera views.

    Args:
        frames: (C, H, W) uint8 resident frame chunk, contiguous.
        frame_idx: (N,) int32 frame index of each view into the chunk.
        top_lefts: (N, 2) int32 crop top-left (x, y), pre-clamped so crops fit
            inside the frame (the kernel clamps again, as ``dynamic_slice``
            would).
        cam: crop size (square camera view).
        imgsz: detector input size (square).

    Returns:
        (N, imgsz, imgsz, 3) ``out_dtype`` normalized views (the three
        channels are one broadcast plane).

    Every launch of the kernel adds one to ``crop_letterbox_views.launches``.
    """
    _check(frames, frame_idx, top_lefts, cam, imgsz, out_dtype)
    if not frames.is_cuda:
        if frames.device.type == "cpu":
            return crop_letterbox_reference(frames, frame_idx, top_lefts, cam, imgsz, out_dtype)
        raise ValueError(f"no kernel for device {frames.device}")
    from wtracker_tpu_torch.ops import _build

    n = frame_idx.shape[0]
    c, h, w = frames.shape
    device = frames.device
    # the kernel writes one plane; stride 0 broadcasts it to three channels
    out = torch.empty_strided((n, imgsz, imgsz, 3), (imgsz * imgsz, imgsz, 1, 0), dtype=out_dtype, device=device)
    if n:
        lib = _build.load("crop_letterbox")
        err = lib.crop_letterbox(
            frames.data_ptr(), frame_idx.data_ptr(), top_lefts.data_ptr(),
            _device_taps(cam, imgsz, device).data_ptr(), out.data_ptr(),
            n, c, h, w, cam, imgsz, _band_src_rows(cam, imgsz),
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream(device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"crop_letterbox kernel launch failed with CUDA error {err}")
        crop_letterbox_views.launches += 1
    return out


crop_letterbox_views.launches = 0


def crop_letterbox_reference(
    frames: torch.Tensor,
    frame_idx: torch.Tensor,
    top_lefts: torch.Tensor,
    cam: int,
    imgsz: int,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the kernel: crop → float32 resize → broadcast, one
    rounding to ``out_dtype`` at the end (as
    ``wtracker_tpu.ops.pallas_preproc.crop_letterbox_reference``)."""
    views = crop_views(frames, top_lefts, (cam, cam), frame_idx=frame_idx)
    x = views.to(torch.float32) * _INV255
    z = resize_bilinear(x, (imgsz, imgsz))
    return z[..., None].expand(*z.shape, 3).to(out_dtype)
