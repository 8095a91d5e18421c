"""The port's classical worm detector (``ops/morphology.py``) against the JAX
package's, exactly: erosion, dilation and opening at the borders, the
largest component's box (edge blobs, equal blobs, empty masks, a snake that
the flood cap cuts short, batches that converge at different floods) and
the batched frame pipeline.  Masks and frames come from numpy seeds."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.ops import morphology as jm
from wtracker_tpu_torch.ops import morphology as tm


def _random_mask(seed: int, hw=(37, 53), p=0.55) -> np.ndarray:
    mask = np.random.default_rng(seed).uniform(size=hw) > p
    mask[0, :] = mask[:, -1] = True  # set pixels along two borders
    return mask


@pytest.mark.parametrize("size", [3, 4, 5, 11])
@pytest.mark.parametrize("op", ["erode", "dilate", "opening"])
def test_window_ops_equal_jax_at_the_borders(op, size):
    for seed in range(3):
        mask = _random_mask(seed)
        want = np.asarray(getattr(jm, op)(jnp.asarray(mask), size))
        got = getattr(tm, op)(torch.from_numpy(mask), size).numpy()
        np.testing.assert_array_equal(got, want)
    # batched input: the same per frame
    masks = np.stack([_random_mask(s) for s in range(3)])
    got = getattr(tm, op)(torch.from_numpy(masks), size).numpy()
    np.testing.assert_array_equal(got, np.stack([np.asarray(getattr(jm, op)(jnp.asarray(m), size)) for m in masks]))


def _components(mask: np.ndarray, max_iters: int = 512):
    jb, jf = jm.largest_component_bbox(jnp.asarray(mask), max_iters=max_iters)
    tb, tf = tm.largest_component_bbox(torch.from_numpy(mask), max_iters=max_iters)
    return (np.asarray(jb), bool(jf)), (tb.numpy(), bool(tf))


def test_blob_touching_the_edge():
    mask = np.zeros((30, 40), bool)
    mask[0:7, 33:40] = True  # the top-right corner
    mask[20:23, 5:9] = True
    want, got = _components(mask)
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and tuple(got[0]) == (33, 0, 7, 7)


def test_equal_blobs_the_first_label_wins():
    mask = np.zeros((30, 40), bool)
    mask[18:22, 25:30] = True  # 20 pixels, later in raster order
    mask[3:7, 2:7] = True  # 20 pixels, first in raster order
    mask[10:14, 30:35] = True  # 20 pixels, between them
    want, got = _components(mask)
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[0]) == (2, 3, 5, 4)


def test_empty_mask():
    want, got = _components(np.zeros((12, 9), bool))
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[0]) == (0, 0, 0, 0) and got[1] is False and want[1] is False


def _snake(hw=(21, 25)) -> np.ndarray:
    """A one-pixel serpentine: its far end is ~150 floods from its root."""
    mask = np.zeros(hw, bool)
    for r in range(0, hw[0], 4):
        mask[r, 1:-1] = True
        end = hw[1] - 2 if (r // 4) % 2 == 0 else 1
        mask[r : r + 4, end] = True
    mask[hw[0] - 1, :] = False
    return mask


@pytest.mark.parametrize("max_iters", [0, 1, 5, 9, 20, 512])
def test_snake_cut_short_by_the_flood_cap(max_iters):
    mask = _snake()
    want, got = _components(mask, max_iters)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_batch_runs_until_every_frame_converged():
    """A batch where one frame converges after a few floods and the snake
    needs many: each frame's box equals JAX's vmapped loop, and no more than
    max_iters + 1 floods run."""
    small = np.zeros((21, 25), bool)
    small[3:6, 4:9] = True
    masks = np.stack([small, _snake(), np.zeros((21, 25), bool)])
    for max_iters in (7, 512):
        want_b, want_f = jax.vmap(partial(jm.largest_component_bbox, max_iters=max_iters))(jnp.asarray(masks))
        tm.largest_component_bbox.floods = 0
        got_b, got_f = tm.largest_component_bbox(torch.from_numpy(masks), max_iters=max_iters)
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert 1 <= tm.largest_component_bbox.floods <= max_iters + 1


def _worm_frames(seed: int, n=6, hw=(120, 160)):
    """A noisy static background and a bright elongated blob a frame (none
    in the last frame), some blobs at the frame's edge, plus speckle that
    the opening removes."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(20, 40, hw, dtype=np.uint8)
    frames = np.repeat(bg[None], n, axis=0).copy()
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    for i in range(n - 1):
        cy, cx = rng.uniform(0, hw[0]), rng.uniform(0, hw[1])
        if i == 1:
            cy, cx = 2.0, hw[1] - 3.0  # at the corner
        blob = 180 * np.exp(-0.5 * (((xx - cx) / 6.0) ** 2 + ((yy - cy) / 3.0) ** 2))
        frames[i] = np.clip(frames[i] + blob, 0, 255).astype(np.uint8)
    speck = rng.uniform(size=frames.shape) > 0.995
    frames[speck] = 250
    return frames, bg


@pytest.mark.parametrize("seed", [0, 1])
def test_worm_bboxes_batch_equals_jax(seed):
    frames, bg = _worm_frames(seed)
    want_b, want_f = jm.worm_bboxes_batch(jnp.asarray(frames), jnp.asarray(bg))
    got_b, got_f = tm.worm_bboxes_batch(torch.from_numpy(frames), torch.from_numpy(bg))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f.numpy()[:-1].all() and not got_f.numpy()[-1]
    # one frame, another threshold and window sizes
    wb, wf = jm.worm_bbox_from_frame(jnp.asarray(frames[2]), jnp.asarray(bg), 35, 3, 7)
    gb, gf = tm.worm_bbox_from_frame(torch.from_numpy(frames[2]), torch.from_numpy(bg), 35, 3, 7)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    assert bool(gf) == bool(wf)


def test_difference_is_taken_without_wrapping():
    """A frame darker than the background: uint8 subtraction would wrap to a
    large difference everywhere."""
    bg = np.full((40, 50), 200, np.uint8)
    frame = bg.copy()
    frame[10:20, 12:30] = 20  # a dark worm
    frame[30:, :] = 199  # one gray level darker: below any threshold
    got_b, got_f = tm.worm_bboxes_batch(torch.from_numpy(frame[None]), torch.from_numpy(bg))
    want_b, _ = jm.worm_bboxes_batch(jnp.asarray(frame[None]), jnp.asarray(bg))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert bool(got_f[0])
