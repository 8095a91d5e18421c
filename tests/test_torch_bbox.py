"""The port's numpy box utilities against the JAX package's.

Reference: ``wtracker_tpu/utils/bbox.py`` (format conversions, centres,
outward rounding, ``discretize``, the ``BoxUtils``/``BoxConverter``
facades), on seeded boxes with non-finite and degenerate rows.  Both are
numpy code, so the results must be identical arrays of the same dtype.
"""

import numpy as np
import pytest

from wtracker_tpu.utils import bbox as jb
from wtracker_tpu_torch.utils import bbox as tb

FORMATS = ["XYWH", "XYXY", "YOLO"]


@pytest.fixture(scope="module")
def boxes():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-20, 200, (64, 2))
    wh = rng.uniform(0, 40, (64, 2))
    b = np.concatenate([xy, wh], axis=1)
    b[5] = np.nan
    b[9, 2] = np.inf
    b[12, 2:] = 0.0  # degenerate
    return b.reshape(8, 8, 4)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_formats_are_the_reference_enum():
    assert [(f.name, f.value) for f in tb.BoxFormat] == [(f.name, f.value) for f in jb.BoxFormat]


@pytest.mark.parametrize("dst", FORMATS)
@pytest.mark.parametrize("src", FORMATS)
def test_conversions_match_jax(src, dst, boxes):
    got = tb.change_format(boxes.copy(), tb.BoxFormat[src], tb.BoxFormat[dst])
    _same(got, jb.change_format(boxes.copy(), jb.BoxFormat[src], jb.BoxFormat[dst]))
    _same(tb.BoxConverter.change_format(boxes, tb.BoxFormat[src], tb.BoxFormat[dst]), got)


@pytest.mark.parametrize("fmt", FORMATS)
def test_center_round_discretize_match_jax(fmt, boxes):
    finite = np.nan_to_num(boxes, nan=1.0, posinf=1.0)
    with np.errstate(invalid="ignore"):
        _same(tb.center(boxes, tb.BoxFormat[fmt]), jb.center(boxes, jb.BoxFormat[fmt]))
    if fmt == "YOLO":  # both packages convert the int32 corners to centres in place, which numpy refuses
        for mod in (tb, jb):
            with pytest.raises(TypeError, match="Cannot cast"):
                mod.round_boxes(finite, mod.BoxFormat.YOLO)
        return
    _same(tb.round_boxes(finite, tb.BoxFormat[fmt]), jb.round_boxes(finite, jb.BoxFormat[fmt]))
    got = tb.discretize(boxes, (120, 150), tb.BoxFormat[fmt])
    _same(got, jb.discretize(boxes, (120, 150), jb.BoxFormat[fmt]))
    assert not got[1].all() and got[1].any()  # legal and illegal boxes both occur
    _same(tb.BoxUtils.discretize(boxes, (120, 150), tb.BoxFormat[fmt]), got)


def test_pack_unpack_match_jax(boxes):
    parts = tb.unpack(boxes)
    for g, w in zip(parts, jb.unpack(boxes)):
        _same(g, w)
    _same(tb.BoxUtils.pack(*parts), jb.pack(*jb.unpack(boxes)))
    assert tb.is_bbox(boxes) and not tb.BoxUtils.is_bbox(boxes[..., :3])


def test_unknown_target_format_raises(boxes):
    with pytest.raises(ValueError):
        tb.change_format(boxes, tb.BoxFormat.XYWH, "xywh")
