"""Synthetic worm trajectories (host numpy) and the on-device renderer.

Port of :mod:`wtracker_tpu.sim.synthetic`: :func:`make_trajectory` and
:class:`SyntheticScene`, which renders camera views of a ground-truth
trajectory on the device that holds its inputs — a textured agar-like
background plus an anisotropic worm blob, as a function of (frame index,
camera position) — so a closed-loop run with a live detector needs no image
storage or host→device traffic.  The JAX package renders one view and
``vmap``s it; here N views are one batched computation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def make_trajectory(
    num_frames: int,
    arena_hw: tuple[int, int],
    seed: int = 0,
    speed: float = 0.9,
    drift: float = 0.25,
    margin: int = 40,
) -> np.ndarray:
    """A smooth random-walk worm trajectory, (F, 2) float64 (x, y)."""
    rng = np.random.default_rng(seed)
    h, w = arena_hw
    steps = rng.normal(0, speed, size=(num_frames - 1, 2)) + drift
    # smooth with a running average for worm-like motion
    kernel = np.ones(15) / 15
    steps[:, 0] = np.convolve(steps[:, 0], kernel, mode="same")
    steps[:, 1] = np.convolve(steps[:, 1], kernel, mode="same")
    pos = np.concatenate([[[w / 2, h / 2]], steps]).cumsum(axis=0)
    pos[:, 0] = margin + np.abs(pos[:, 0] - margin) % (2 * (w - 2 * margin)) % (w - 2 * margin)
    pos[:, 1] = margin + np.abs(pos[:, 1] - margin) % (2 * (h - 2 * margin)) % (h - 2 * margin)
    return pos


# texture frequencies of SyntheticScene._texture, exposed for analysis
# tooling that reproduces the texture analytically
TEX_FX1, TEX_FY1 = 0.07, 0.05  # sin(FX1·X)·cos(FY1·Y)
TEX_FX2, TEX_FY2 = 0.013, 0.017  # 0.5·sin(FX2·X + FY2·Y), expanded separably
TEXTURE_BOUND = 1.5
"""Peak |texture| in units of ``texture_amp`` (one unit-amplitude separable
product plus half a unit-amplitude phase-sum sinusoid)."""


@dataclass(frozen=True)
class SyntheticScene:
    """Parametric scene: background texture + worm appearance.

    The background texture is separable (the mixed-frequency term expands
    via sin(a+b) = sin·cos + cos·sin), so per view only O(h+w) sin/cos
    evaluate; the worm Gaussian evaluates on a ``worm_window``² patch around
    the worm (beyond ~5σ it is zero at float32) and is placed into the view
    by an exact scatter.
    """

    worm_sigma_x: float = 5.0
    worm_sigma_y: float = 3.0
    worm_intensity: float = 160.0
    bg_level: float = 40.0
    texture_amp: float = 10.0
    worm_window: int = 64
    """Static side of the patch the worm blob is evaluated on (≥ ~10σ)."""

    def _texture(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """Separable agar texture over absolute coords (stable under camera
        motion). ``xs``/``ys`` are broadcastable row/column coordinate arrays."""
        cross = torch.sin(xs * TEX_FX2) * torch.cos(ys * TEX_FY2) + torch.cos(xs * TEX_FX2) * torch.sin(ys * TEX_FY2)
        tex = torch.sin(xs * TEX_FX1) * torch.cos(ys * TEX_FY1) + 0.5 * cross
        return self.bg_level + self.texture_amp * tex

    def _worm_blob(self, dx: torch.Tensor, dy: torch.Tensor, frame_idx: torch.Tensor) -> torch.Tensor:
        """Anisotropic Gaussian at offset (dx, dy) from the worm center;
        ``frame_idx`` broadcasts against the offsets."""
        t = frame_idx.to(torch.float32)
        angle = 0.35 * torch.sin(0.13 * t)
        ca, sa = torch.cos(angle), torch.sin(angle)
        # reciprocal sigmas rounded to float32 once, as the JAX package does
        inv_sx = float(np.float32(1.0 / self.worm_sigma_x))
        inv_sy = float(np.float32(1.0 / self.worm_sigma_y))
        u = (ca * dx + sa * dy) * inv_sx
        v = (-sa * dx + ca * dy) * inv_sy
        return self.worm_intensity * torch.exp(-0.5 * (u * u + v * v))

    def render_view(
        self,
        worm_xy: torch.Tensor,
        cam_tl: torch.Tensor,
        view_hw: tuple[int, int],
        frame_idx: torch.Tensor | int = 0,
        content_wh: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Render one camera view, (h, w) float32 in [0, 255].

        Args:
            worm_xy: (2,) ground-truth worm center in arena coordinates.
            cam_tl: (2,) camera top-left in arena coordinates.
            view_hw: static (h, w) of the view.
            frame_idx: seeds slight per-frame wiggle of the worm shape.
            content_wh: optional (w, h) content extent within the view
                canvas: the worm window clamps against it, so the content
                region equals a render at that size.
        """
        fi = torch.as_tensor(frame_idx, device=worm_xy.device).reshape(1)
        cwh = None if content_wh is None else content_wh[None]
        return self.render_views(worm_xy[None], cam_tl[None], view_hw, fi, cwh)[0]

    def render_views(
        self,
        worm_xys: torch.Tensor,
        cam_tls: torch.Tensor,
        view_hw: tuple[int, int],
        frame_idx: torch.Tensor,
        content_whs: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Batched rendering: (N, 2) worms + (N, 2) float32 camera top-lefts
        + (N,) frame indices → (N, h, w) float32, on their device.

        ``content_whs`` (N, 2) optionally gives each view its own content
        extent inside the shared canvas (mixed-geometry batches).
        """
        h, w = view_hw
        n = worm_xys.shape[0]
        dev = worm_xys.device
        cam_tls = cam_tls.to(torch.float32)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + cam_tls[:, 1, None, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + cam_tls[:, 0, None, None]
        bg = self._texture(xs, ys)  # (N, h, w)

        win = min(self.worm_window, h, w)
        if content_whs is None:
            clamp_w = torch.full((n,), w - win, dtype=torch.int32, device=dev)
            clamp_h = torch.full((n,), h - win, dtype=torch.int32, device=dev)
        else:
            clamp_w = (content_whs[:, 0] - win).clamp_min(0).to(torch.int32)
            clamp_h = (content_whs[:, 1] - win).clamp_min(0).to(torch.int32)
        # patch top-left in view coords, clamped inside the view; the Gaussian
        # is ≤1e-9·intensity beyond the patch, invisible at image scale
        wx = worm_xys[:, 0] - cam_tls[:, 0]
        wy = worm_xys[:, 1] - cam_tls[:, 1]
        # round half to even, like jnp.round
        tx = torch.minimum((torch.round(wx).to(torch.int32) - win // 2).clamp_min(0), clamp_w)
        ty = torch.minimum((torch.round(wy).to(torch.int32) - win // 2).clamp_min(0), clamp_h)

        k = torch.arange(win, device=dev)
        pys = (k.to(torch.float32)[None, :] + ty.to(torch.float32)[:, None]) - wy[:, None]  # (N, win)
        pxs = (k.to(torch.float32)[None, :] + tx.to(torch.float32)[:, None]) - wx[:, None]
        blob = self._worm_blob(pxs[:, None, :], pys[:, :, None], frame_idx[:, None, None])  # (N, win, win)

        # the JAX package places the patch with two 0/1 selection matmuls
        # (one exact product per output cell); a scatter into zeros gives
        # the same floats
        rows = (ty[:, None] + k)[:, :, None]
        cols = (tx[:, None] + k)[:, None, :]
        views = torch.arange(n, device=dev)[:, None, None]
        placed = torch.zeros((n, h, w), dtype=torch.float32, device=dev).index_put_((views, rows, cols), blob)
        return (bg + placed).clamp(0, 255)

    def gt_bboxes(self, worm_xys: torch.Tensor, k_sigma: float = 2.0) -> torch.Tensor:
        """Ground-truth xywh boxes implied by the worm blob extent."""
        wx = 2 * k_sigma * self.worm_sigma_x
        wy = 2 * k_sigma * self.worm_sigma_y
        lead = worm_xys.shape[:-1]
        return torch.cat(
            [
                worm_xys[..., 0:1] - wx / 2,
                worm_xys[..., 1:2] - wy / 2,
                torch.full((*lead, 1), wx, dtype=worm_xys.dtype, device=worm_xys.device),
                torch.full((*lead, 1), wy, dtype=worm_xys.dtype, device=worm_xys.device),
            ],
            dim=-1,
        )
