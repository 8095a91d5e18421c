"""The crop+letterbox kernel's tap table against the interpolation matrix.

The CUDA kernel (``wtracker_tpu_torch/csrc/crop_letterbox.cu``) weighs
pixels with the two taps per output coordinate of
``wtracker_tpu_torch.ops.preproc.tap_table``.  Rebuilt as a dense matrix, the
table must be exactly the interpolation matrix of the port's plain version
and of the JAX package, so that the kernel computes with their weights.  The
shapes cover upscale, odd size, identity, downscale and both clamped edges.
"""

import re

import numpy as np
import pytest

from wtracker_tpu.ops.image import _interp_matrix as jax_interp_matrix
from wtracker_tpu_torch.ops._build import CSRC
from wtracker_tpu_torch.ops.image import _interp_matrix
from wtracker_tpu_torch.ops.preproc import BAND_ROWS, _band_src_rows, tap_table

SHAPES = [(360, 416), (48, 64), (30, 64), (36, 36), (480, 416), (640, 416)]
SHAPE_IDS = ["deploy", "up", "up-odd", "same", "down", "down-far"]


@pytest.mark.parametrize("cam, imgsz", SHAPES, ids=SHAPE_IDS)
def test_tap_table_rebuilds_the_interpolation_matrix(cam, imgsz):
    idx, w = tap_table(cam, imgsz)
    assert idx.shape == w.shape == (imgsz, 2) and idx.dtype == np.int32 and w.dtype == np.float32
    lo, hi = idx.T
    assert ((0 <= lo) & (lo <= hi) & (hi <= np.minimum(lo + 1, cam - 1))).all()
    # a row with one weight (a clamped edge, a pixel's centre) keeps it in w_lo
    m = _interp_matrix(cam, imgsz)
    np.testing.assert_array_equal(lo == hi, (m != 0).sum(axis=1) == 1)
    assert (w[lo == hi, 1] == 0).all()

    dense = np.zeros((imgsz, cam), np.float32)
    rows = np.arange(imgsz)
    np.add.at(dense, (rows, lo), w[:, 0])
    np.add.at(dense, (rows, hi), w[:, 1])
    np.testing.assert_array_equal(dense, m)
    np.testing.assert_array_equal(dense, jax_interp_matrix(cam, imgsz))


@pytest.mark.parametrize("cam, imgsz", SHAPES, ids=SHAPE_IDS)
def test_band_src_rows_hold_every_tap_of_a_band(cam, imgsz):
    """A block stages crop rows from its first row's lower tap to its last
    row's upper tap, at most ``_band_src_rows`` of them: every tap of its
    band must lie among them, and the count is no larger than the tallest
    band needs."""
    idx, _ = tap_table(cam, imgsz)
    n_src = _band_src_rows(cam, imgsz)
    spans = []
    for row0 in range(0, imgsz, BAND_ROWS):
        taps = idx[row0 : row0 + BAND_ROWS]
        assert taps.min() == taps[0, 0] and taps.max() == taps[-1, 1]
        spans.append(int(taps[-1, 1]) - int(taps[0, 0]) + 1)
    assert n_src == max(spans)


def test_band_rows_is_the_kernels_band_height():
    """The wrapper sizes the kernel's shared memory for bands of
    ``BAND_ROWS`` rows: the kernel must write bands of that height."""
    src = (CSRC / "crop_letterbox.cu").read_text()
    assert re.findall(r"constexpr int kBandRows = (\d+);", src) == [str(BAND_ROWS)]
