"""Render a synthetic recording at experiment geometry as BMP frames.

Port of the JAX package's ``tools/bench_video.py --generate``: whole
1400x1600 frames (the exp0 geometry) of ``SyntheticScene`` along a seeded
``make_trajectory`` track, rendered on the device in batches, rounded to
uint8 and written as 8-bit gray BMPs (``frame_NNNNNN.bmp``, OpenCV's bytes,
through :mod:`wtracker_tpu_torch.utils.image_codec`: no OpenCV needed).  The
track is saved beside the directory (``<dir>.trajectory.npy``), since the
frames directory must hold only frames.  A 1400x1600 frame is 2.24 MB on
disk.

Usage::

    python -m wtracker_tpu_torch.tools.recording --output DIR [--frames 1200] [--arena 1400 1600] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from wtracker_tpu_torch.utils.image_codec import imwrite

ARENA = (1400, 1600)  # (h, w): exp0's resolution


def write_frames(out_dir: str, frames: np.ndarray, start: int = 0) -> int:
    """Write (N, H, W) uint8 ``frames`` as ``frame_{start + i:06d}.bmp`` into
    ``out_dir``; returns the bytes written."""
    written = 0
    for i, frame in enumerate(frames):
        path = os.path.join(out_dir, f"frame_{start + i:06d}.bmp")
        if not imwrite(path, frame):
            raise OSError(f"cannot write frame {start + i} as {path}")
        written += os.path.getsize(path)
    return written


def render_frames(traj: np.ndarray, start: int, count: int, arena=ARENA, device="cuda") -> np.ndarray:
    """Frames ``start .. start + count - 1`` of the recording along ``traj``
    (F, 2): whole ``arena`` views of ``SyntheticScene``, rounded half to even
    and clipped to uint8, as the JAX tool renders them."""
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    worm = torch.tensor(traj[start : start + count], dtype=torch.float32, device=device)
    tls = torch.zeros((count, 2), dtype=torch.float32, device=device)
    fidx = torch.arange(start, start + count, device=device)
    views = SyntheticScene().render_views(worm, tls, tuple(arena), fidx)
    return views.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def generate(out_dir: str, n_frames: int, seed: int = 0, arena=ARENA, batch: int = 15, device="cuda") -> dict:
    """Render and write the whole recording; returns its size and timing."""
    from wtracker_tpu_torch.sim.synthetic import make_trajectory
    from wtracker_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    traj = make_trajectory(n_frames, tuple(arena), seed=seed)
    t0 = time.perf_counter()
    written = 0
    for s in range(0, n_frames, batch):
        n = min(batch, n_frames - s)
        written += write_frames(out_dir, render_frames(traj, s, n, arena, dev), s)
    np.save(out_dir.rstrip("/") + ".trajectory.npy", traj)
    return {"dir": out_dir, "frames": n_frames, "arena": list(arena), "bytes": written,
            "seconds": time.perf_counter() - t0, "device": str(dev)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", required=True, help="frames directory (holds only the frames)")
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arena", type=int, nargs=2, default=list(ARENA), metavar=("H", "W"))
    ap.add_argument("--device", default="cuda", help="torch device of the renderer (default: cuda)")
    args = ap.parse_args(argv)
    out = generate(args.output, args.frames, args.seed, tuple(args.arena), device=args.device)
    print(f"generated {out['frames']} frames ({out['bytes'] / 1e9:.2f} GB) in {out['seconds']:.1f} s -> {out['dir']}")
    return out


if __name__ == "__main__":
    main()
