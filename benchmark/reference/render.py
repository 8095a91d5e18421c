"""The synthetic microscope scene: an agar texture in arena coordinates and an
anisotropic Gaussian worm whose angle wiggles with the frame index, clipped to
[0, 255], float32.  The worm is evaluated on a 64 px window around it (clamped
into the view, or into a view's content extent); beyond it the Gaussian is
below float32's resolution of the texture."""

from __future__ import annotations

import numpy as np
import torch

WORM_SIGMA = (5.0, 3.0)
WORM_INTENSITY = 160.0
BG_LEVEL = 40.0
TEXTURE_AMP = 10.0
WINDOW = 64


def _texture(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    # sin(0.07x)cos(0.05y) + 0.5 sin(0.013x + 0.017y), the phase sum expanded
    cross = torch.sin(xs * 0.013) * torch.cos(ys * 0.017) + torch.cos(xs * 0.013) * torch.sin(ys * 0.017)
    return BG_LEVEL + TEXTURE_AMP * (torch.sin(xs * 0.07) * torch.cos(ys * 0.05) + 0.5 * cross)


def render(worm_xy: torch.Tensor, cam_tl: torch.Tensor, view_hw: tuple[int, int], frame_idx: torch.Tensor,
           content_wh: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 2) worm centres and (N, 2) camera top-lefts in arena px, (N,) frame
    indices -> (N, h, w) float32 views."""
    h, w = view_hw
    dev = worm_xy.device
    n = worm_xy.shape[0]
    cam = cam_tl.to(torch.float32)
    worm = worm_xy.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + cam[:, 1, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + cam[:, 0, None, None]
    out = _texture(xs, ys)

    win = min(WINDOW, h, w)
    if content_wh is None:
        lim_x = torch.full((n,), w - win, device=dev)
        lim_y = torch.full((n,), h - win, device=dev)
    else:
        lim_x = (content_wh[:, 0].long() - win).clamp_min(0)
        lim_y = (content_wh[:, 1].long() - win).clamp_min(0)
    wx = worm[:, 0] - cam[:, 0]
    wy = worm[:, 1] - cam[:, 1]
    x0 = torch.minimum((torch.round(wx).long() - win // 2).clamp_min(0), lim_x)
    y0 = torch.minimum((torch.round(wy).long() - win // 2).clamp_min(0), lim_y)

    t = frame_idx.to(torch.float32)
    angle = 0.35 * torch.sin(0.13 * t)
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    k = torch.arange(win, device=dev)
    dy = ((k[None, :] + y0[:, None]).to(torch.float32) - wy[:, None])[:, :, None]
    dx = ((k[None, :] + x0[:, None]).to(torch.float32) - wx[:, None])[:, None, :]
    u = (ca * dx + sa * dy) * float(np.float32(1.0 / WORM_SIGMA[0]))
    v = (-sa * dx + ca * dy) * float(np.float32(1.0 / WORM_SIGMA[1]))
    blob = WORM_INTENSITY * torch.exp(-0.5 * (u * u + v * v))

    rows = (y0[:, None] + k)[:, :, None]
    cols = (x0[:, None] + k)[:, None, :]
    idx = torch.arange(n, device=dev)[:, None, None]
    out[idx, rows, cols] = out[idx, rows, cols] + blob
    return out.clamp(0, 255)
