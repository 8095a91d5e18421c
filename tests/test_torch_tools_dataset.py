"""The port's dataset generator and held-out set against the JAX package's.

Reference: ``tools/make_synthetic_dataset.py`` (host numpy; it writes PNGs
with OpenCV) and the held-out set of ``tests/test_trained_detector.py``
(letterboxed with ``cv2.resize``).  ``render_image`` is held bit for bit,
labels as text, PNGs by their decoded pixels; the held-out letterbox
(``resize_gray_uint8``) within one grey level of OpenCV's, boxes exactly.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from wtracker_tpu_torch.tools import gates
from wtracker_tpu_torch.tools import make_synthetic_dataset as tmsd
from wtracker_tpu_torch.utils.image_codec import imread

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import make_synthetic_dataset as jmsd  # noqa: E402  (the JAX package's tool)


def _draw(draw: int):
    """Geometry and scene flag of draw ``draw``: the deployment camera and
    every mixed geometry, scene-exact or not."""
    hw = (360, 360) if draw % 2 else tmsd.DEFAULT_GEOMETRIES[1 + draw // 2 % (len(tmsd.DEFAULT_GEOMETRIES) - 1)]
    return hw, draw % 4 == 1


@pytest.mark.parametrize("draw", range(16))
def test_render_image_equals_jax(draw):
    """Both geometries (deployment and mixed) and both worm families, from
    one seeded stream a draw."""
    hw, scene_exact = _draw(draw)
    rng_t, rng_j = np.random.default_rng(100 + draw), np.random.default_rng(100 + draw)
    got, got_boxes = tmsd.render_image(rng_t, hw, scene_exact)
    want, want_boxes = jmsd.render_image(rng_j, hw, scene_exact)
    assert got.dtype == np.uint8 and got.shape == hw
    np.testing.assert_array_equal(got, want)
    assert got_boxes == want_boxes
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


def test_render_image_draws_both_worm_families(monkeypatch):
    """The 16 draws above reach blob and curved worms (an image that is not
    scene-exact picks a family per worm)."""
    calls = []

    def counting(name, fn):
        def wrapper(*args):
            calls.append(name)
            return fn(*args)

        return wrapper

    for name in ("render_blob_worm", "render_curved_worm"):
        monkeypatch.setattr(tmsd, name, counting(name, getattr(tmsd, name)))
    for draw in range(16):
        tmsd.render_image(np.random.default_rng(100 + draw), *_draw(draw))
    assert {"render_blob_worm", "render_curved_worm"} <= set(calls)


def test_main_writes_jax_labels_and_pixels(tmp_path, monkeypatch):
    tmsd.main(["--output", str(tmp_path / "port"), "--count", "6", "--seed", "3"])
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", "--output", str(tmp_path / "jax"), "--count", "6",
                                      "--seed", "3"])
    jmsd.main()
    names = sorted(os.listdir(tmp_path / "jax" / "labels"))
    assert names == sorted(os.listdir(tmp_path / "port" / "labels")) and len(names) == 6
    for name in names:
        assert (tmp_path / "port" / "labels" / name).read_text() == (tmp_path / "jax" / "labels" / name).read_text()
        png = name.replace(".txt", ".png")
        got = imread(str(tmp_path / "port" / "images" / png), -1)
        want = cv2.imread(str(tmp_path / "jax" / "images" / png), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.ndim == 2
        np.testing.assert_array_equal(got, want)


def _jax_heldout(n: int, seed: int = 12345, imgsz: int = 416, max_gt: int = 4):
    """tests/test_trained_detector.py's held-out set (its fixture's body)."""
    rng = np.random.default_rng(seed)
    images, gts, masks = [], [], []
    for _ in range(n):
        scene_exact = rng.uniform() < 0.5
        hw = (360, 360) if scene_exact else jmsd.DEFAULT_GEOMETRIES[int(rng.integers(1, len(jmsd.DEFAULT_GEOMETRIES)))]
        img, boxes = jmsd.render_image(rng, hw, scene_exact)
        sh, sw = img.shape
        scale = min(imgsz / sh, imgsz / sw)
        nh, nw = round(sh * scale), round(sw * scale)
        pt, pl = (imgsz - nh) // 2, (imgsz - nw) // 2
        canvas = np.full((imgsz, imgsz), 114, np.uint8)
        canvas[pt : pt + nh, pl : pl + nw] = cv2.resize(img, (nw, nh)) if (nh, nw) != (sh, sw) else img
        gt = np.zeros((max_gt, 4), np.float32)
        mask = np.zeros((max_gt,), bool)
        for j, (x0, y0, x1, y1) in enumerate(boxes[:max_gt]):
            gt[j] = (x0 * scale + pl, y0 * scale + pt, x1 * scale + pl, y1 * scale + pt)
            mask[j] = True
        images.append(np.repeat(canvas[..., None], 3, -1).astype(np.float32) / 255.0)
        gts.append(gt)
        masks.append(mask)
    return np.stack(images), np.stack(gts), np.stack(masks)


def test_heldout_set_matches_jax_letterbox():
    images, gt, mask = gates.heldout_set(24)
    want_images, want_gt, want_mask = _jax_heldout(24)
    assert images.shape == want_images.shape == (24, 416, 416, 3)
    assert np.abs(np.round(images * 255) - np.round(want_images * 255)).max() <= 1
    np.testing.assert_array_equal(gt, want_gt)
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.any(axis=1).mean() > 0.5  # the set has worms to find
