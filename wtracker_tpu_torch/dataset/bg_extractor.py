"""Background extraction from an experiment's frames.

Port of :mod:`wtracker_tpu.dataset.bg_extractor`: the background is the
per-pixel median (or mean) over uniformly or randomly sampled probe frames.
Probe selection and decoding stay on the host (numpy); the reduction runs on
the device in row bands.

The median of an even number of probes is the JAX package's: the mean of
the two middle values, truncated to uint8, so ⌊(lo + hi) / 2⌋.
``torch.median`` returns the lower middle value instead, so the two middle
order statistics are taken from a sort.  The mean is the float64 mean
truncated to uint8; its sum is exact in int64 on the device and the
division is made on the host (a CUDA tensor divided by a number is a product
with the reciprocal, which can land an ulp below an integer mean).
"""

from __future__ import annotations

import numpy as np
import torch

from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.frame_reader import FrameReader

# elements of one band of the probe stack: the sort keeps its uint8 values
# and int64 indices (9 bytes an element) plus temporaries, a few GB a band
BAND_ELEMENTS = 256 * 1024 * 1024


class BGExtractor:
    """Computes a static background image for a frame sequence."""

    def __init__(self, reader: FrameReader):
        self.reader = reader

    def calc_background(
        self,
        num_probes: int,
        sampling: str = "uniform",
        method: str = "median",
        device: str | torch.device = "cuda",
    ) -> np.ndarray:
        """Estimate the background.

        Args:
            num_probes: number of probe frames to sample.
            sampling: "uniform" (evenly spaced) or "random" probe selection.
            method: "median" (better) or "mean" (faster) per-pixel reduction.
            device: where the reduction runs.
        """
        if sampling not in ("random", "uniform"):
            raise ValueError(f"sampling must be 'random' or 'uniform', not {sampling!r}")
        if method not in ("median", "mean"):
            raise ValueError(f"method must be 'median' or 'mean', not {method!r}")
        dev = resolve_device(device)

        length = len(self.reader)
        size = min(num_probes, length)
        if sampling == "random":
            frame_ids = np.random.choice(length, size=size, replace=False)
        else:
            frame_ids = np.unique(np.linspace(0, length - 1, num=size).astype(int, copy=False))
        probes = self.reader.read_batch([int(i) for i in frame_ids])
        return background_of(probes, method, dev)


def background_of(probes: np.ndarray, method: str, device: torch.device) -> np.ndarray:
    """The per-pixel (per channel) median or mean of an (N, H, W[, C]) uint8
    probe stack, as uint8 of the frame shape."""
    n, h = probes.shape[0], probes.shape[1]
    flat = probes.reshape(n, h, -1)  # channels fold into the row axis
    w = flat.shape[2]
    band = max(1, min(h, BAND_ELEMENTS // max(n * w, 1)))
    lo_k, hi_k = (n - 1) // 2, n // 2

    if method == "mean":
        sums = np.empty((h, w), dtype=np.int64)
        for y0 in range(0, h, band):
            x = torch.from_numpy(flat[:, y0 : y0 + band]).to(device)
            sums[y0 : y0 + band] = x.sum(dim=0, dtype=torch.int64).cpu().numpy()
        bg = sums / np.float64(n)
    else:
        bg = np.empty((h, w), dtype=np.uint8)
        for y0 in range(0, h, band):
            x = torch.from_numpy(flat[:, y0 : y0 + band]).to(device)
            ordered = torch.sort(x, dim=0).values
            mid = (ordered[lo_k].to(torch.int16) + ordered[hi_k].to(torch.int16)) // 2
            bg[y0 : y0 + band] = mid.to(torch.uint8).cpu().numpy()
            del x, ordered
    return bg.reshape(probes.shape[1:]).astype(np.uint8, copy=False)
