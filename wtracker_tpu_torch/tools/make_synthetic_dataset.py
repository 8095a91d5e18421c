"""Render the detector's synthetic training set (YOLO-format images and labels).

Port of the JAX package's ``tools/make_synthetic_dataset.py``, the generator
of the set the shipped detector (``models/yolov8s_worm416.npz``) was trained
on.  Every image is an agar-textured field (the ``SyntheticScene`` texture
formula with randomised level, amplitude, frequencies and phase) carrying 0-3
worms of two families: *blob* worms (rotated anisotropic Gaussians spanning
``SyntheticScene``'s appearance) and *curved* worms (tapered tubes around a
smoothed random-walk backbone), plus dust specks, a dim smudge, sensor noise
and mixed non-square geometries, so the training letterbox scales and pads.
A fixed fraction renders at the deployment camera geometry (360x360) with
the scene's own texture.  Boxes come from the rendered intensity mask (pixels
above 15 % of the worm's peak).

Host numpy, as in the JAX tool: from the same ``np.random.default_rng(seed)``
the functions below give the same pixels and boxes bit for bit.  Images are
written as PNGs by :mod:`wtracker_tpu_torch.utils.image_codec`, so no OpenCV
is needed.

Usage::

    python -m wtracker_tpu_torch.tools.make_synthetic_dataset --output DIR [--count 1800] [--seed 7]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from wtracker_tpu_torch.utils.image_codec import imwrite

# SyntheticScene texture family (sim/synthetic.py TEX_*), jittered per image
BASE_FX1, BASE_FY1 = 0.07, 0.05
BASE_FX2, BASE_FY2 = 0.013, 0.017

DEFAULT_GEOMETRIES = (
    (360, 360),   # deployment camera view (4 mm @ 90 px/mm, configs/exp0)
    (500, 500),
    (360, 480),
    (480, 360),
    (312, 416),
    (640, 400),
    (320, 512),
)


def _texture(hw: tuple[int, int], rng: np.random.Generator, scene_exact: bool) -> np.ndarray:
    h, w = hw
    if scene_exact:
        level, amp = 40.0, 10.0
        fx1, fy1, fx2, fy2 = BASE_FX1, BASE_FY1, BASE_FX2, BASE_FY2
        # a random arena position: views render at absolute coords in the sim
        ox, oy = rng.uniform(0, 1400, 2)
    else:
        level = rng.uniform(25, 60)
        amp = rng.uniform(5, 16)
        jit = lambda f: f * rng.uniform(0.6, 1.5)
        fx1, fy1, fx2, fy2 = jit(BASE_FX1), jit(BASE_FY1), jit(BASE_FX2), jit(BASE_FY2)
        ox, oy = rng.uniform(0, 10_000, 2)
    ys = np.arange(h, dtype=np.float32)[:, None] + oy
    xs = np.arange(w, dtype=np.float32)[None, :] + ox
    tex = np.sin(xs * fx1) * np.cos(ys * fy1) + 0.5 * np.sin(xs * fx2 + ys * fy2)
    return (level + amp * tex).astype(np.float32)


def _mask_box(patch: np.ndarray, peak: float, x0: int, y0: int) -> tuple[float, float, float, float] | None:
    """xyxy box of the rendered-intensity mask (>15% of peak), in image coords."""
    mask = patch > 0.15 * peak
    if not mask.any():
        return None
    ys, xs = np.nonzero(mask)
    return (x0 + xs.min(), y0 + ys.min(), x0 + xs.max() + 1.0, y0 + ys.max() + 1.0)


def _paste(img: np.ndarray, patch: np.ndarray, x0: int, y0: int) -> None:
    img[y0 : y0 + patch.shape[0], x0 : x0 + patch.shape[1]] += patch


def _patch_grid(cx: float, cy: float, half: int, hw: tuple[int, int]):
    """Clipped patch bounds + pixel-coordinate grids around (cx, cy)."""
    h, w = hw
    x0 = int(np.clip(round(cx) - half, 0, max(w - 1, 0)))
    y0 = int(np.clip(round(cy) - half, 0, max(h - 1, 0)))
    x1 = int(np.clip(round(cx) + half, 1, w))
    y1 = int(np.clip(round(cy) + half, 1, h))
    if x1 <= x0 or y1 <= y0:
        return None
    xs = np.arange(x0, x1, dtype=np.float32)
    ys = np.arange(y0, y1, dtype=np.float32)
    return x0, y0, np.meshgrid(xs, ys)


def render_blob_worm(img: np.ndarray, rng: np.random.Generator, scene_exact: bool):
    """SyntheticScene-family worm: rotated anisotropic Gaussian."""
    h, w = img.shape
    if scene_exact:
        sx = 5.0 * rng.uniform(0.85, 1.15)
        sy = 3.0 * rng.uniform(0.85, 1.15)
        intensity = 160.0 * rng.uniform(0.8, 1.2)
    else:
        sx = rng.uniform(3.0, 8.0)
        sy = rng.uniform(2.0, 5.5)
        intensity = rng.uniform(90, 210)
    angle = rng.uniform(0, np.pi)
    cx, cy = rng.uniform(4, w - 4), rng.uniform(4, h - 4)

    grid = _patch_grid(cx, cy, int(5 * max(sx, sy)) + 2, img.shape)
    if grid is None:
        return None
    x0, y0, (gx, gy) = grid
    dx, dy = gx - cx, gy - cy
    ca, sa = np.cos(angle), np.sin(angle)
    u = (ca * dx + sa * dy) / sx
    v = (-sa * dx + ca * dy) / sy
    patch = intensity * np.exp(-0.5 * (u * u + v * v))
    _paste(img, patch, x0, y0)
    return _mask_box(patch, intensity, x0, y0)


def render_curved_worm(img: np.ndarray, rng: np.random.Generator):
    """Elongated worm: tapered tube around a smoothed random-walk backbone."""
    h, w = img.shape
    length = rng.uniform(25, 90)
    n_seg = 18
    width = rng.uniform(1.8, 4.5)  # body half-width (sigma)
    intensity = rng.uniform(90, 210)

    theta = rng.uniform(0, 2 * np.pi) + np.cumsum(rng.normal(0, 0.28, n_seg))
    theta = np.convolve(theta, np.ones(5) / 5, mode="same")
    steps = (length / n_seg) * np.stack([np.cos(theta), np.sin(theta)], 1)
    pts = np.concatenate([[[0.0, 0.0]], np.cumsum(steps, 0)])
    pts -= pts.mean(0)
    cx, cy = rng.uniform(6, w - 6), rng.uniform(6, h - 6)
    pts += [cx, cy]

    grid = _patch_grid(cx, cy, int(length / 2 + 6 * width) + 2, img.shape)
    if grid is None:
        return None
    x0, y0, (gx, gy) = grid
    px = np.stack([gx.ravel(), gy.ravel()], 1)  # (Np, 2)

    # min over segments of (distance / local sigma); width tapers at the ends
    frac = (np.arange(n_seg) + 0.5) / n_seg
    sigma_s = width * (0.55 + 0.45 * np.sin(np.pi * frac))
    q = np.full(px.shape[0], np.inf, np.float32)
    for i in range(n_seg):
        a, b = pts[i], pts[i + 1]
        ab = b - a
        t = np.clip(((px - a) @ ab) / max(float(ab @ ab), 1e-9), 0.0, 1.0)
        d = np.linalg.norm(px - (a + t[:, None] * ab), axis=1)
        q = np.minimum(q, d / sigma_s[i])
    patch = (intensity * np.exp(-0.5 * q * q)).reshape(gx.shape)
    _paste(img, patch, x0, y0)
    return _mask_box(patch, intensity, x0, y0)


def render_distractors(img: np.ndarray, rng: np.random.Generator) -> None:
    """Dust specks and dim smudges — bright-ish clutter a detector must ignore."""
    h, w = img.shape
    for _ in range(rng.integers(0, 5)):
        s = rng.uniform(0.7, 1.8)
        amp = rng.uniform(25, 85)  # weaker than any worm
        cx, cy = rng.uniform(2, w - 2), rng.uniform(2, h - 2)
        grid = _patch_grid(cx, cy, int(5 * s) + 1, img.shape)
        if grid is None:
            continue
        x0, y0, (gx, gy) = grid
        _paste(img, amp * np.exp(-0.5 * (((gx - cx) ** 2 + (gy - cy) ** 2) / s**2)), x0, y0)
    if rng.uniform() < 0.3:  # one large dim smudge
        s = rng.uniform(8, 25)
        amp = rng.uniform(8, 25)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        grid = _patch_grid(cx, cy, int(3 * s), img.shape)
        if grid is not None:
            x0, y0, (gx, gy) = grid
            _paste(img, amp * np.exp(-0.5 * (((gx - cx) ** 2 + (gy - cy) ** 2) / s**2)), x0, y0)


def render_image(rng: np.random.Generator, hw: tuple[int, int], scene_exact: bool):
    """One labeled image: texture + worms + distractors + noise.

    Returns (uint8 image, list of xyxy boxes).
    """
    img = _texture(hw, rng, scene_exact)
    render_distractors(img, rng)

    n_worms = int(rng.choice([0, 1, 1, 1, 2, 2, 3], p=[0.05, 0.3, 0.2, 0.15, 0.15, 0.1, 0.05]))
    boxes = []
    for _ in range(n_worms):
        if scene_exact or rng.uniform() < 0.4:
            box = render_blob_worm(img, rng, scene_exact)
        else:
            box = render_curved_worm(img, rng)
        if box is not None:
            boxes.append(box)

    img += rng.normal(0, rng.uniform(0.8, 2.5), img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", required=True, help="dataset root (images/ + labels/ created inside)")
    ap.add_argument("--count", type=int, default=1800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scene-exact-frac",
        type=float,
        default=0.3,
        help="fraction rendered at the deployment camera geometry with scene-default texture",
    )
    args = ap.parse_args(argv)

    img_dir = os.path.join(args.output, "images")
    lbl_dir = os.path.join(args.output, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    n_boxes = 0
    for i in range(args.count):
        scene_exact = rng.uniform() < args.scene_exact_frac
        hw = (360, 360) if scene_exact else DEFAULT_GEOMETRIES[int(rng.integers(1, len(DEFAULT_GEOMETRIES)))]
        img, boxes = render_image(rng, hw, scene_exact)
        path = os.path.join(img_dir, f"w{i:05d}.png")
        if not imwrite(path, img):
            raise OSError(f"cannot write {path}")
        h, w = hw
        with open(os.path.join(lbl_dir, f"w{i:05d}.txt"), "w") as f:
            for x0, y0, x1, y1 in boxes:
                f.write(
                    f"0 {(x0 + x1) / 2 / w:.6f} {(y0 + y1) / 2 / h:.6f} "
                    f"{(x1 - x0) / w:.6f} {(y1 - y0) / h:.6f}\n"
                )
        n_boxes += len(boxes)
    print(f"{args.count} images ({n_boxes} boxes) -> {args.output}")


if __name__ == "__main__":
    main()
