"""The general traffic generator: a traffic mix is a data file
``traffic/<name>.json`` of rigs (arena, optics, timing, streams) and run
lengths, and this module turns it and a seed into each stream's geometry,
worm track and start position.

The track generator is a copy of ``wtracker_tpu_torch/sim/synthetic.py::
make_trajectory`` (the port's, itself the JAX package's), kept here so that
a change to the program does not change the traffic.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def make_trajectory(num_frames: int, arena_hw: tuple[int, int], rng: np.random.Generator, speed: float = 0.9,
                    drift: float = 0.25, margin: int = 40) -> np.ndarray:
    """A smooth random-walk worm track, (F, 2) float64 (x, y), starting at the
    arena's centre and folded back into it ``margin`` px from its edges."""
    h, w = arena_hw
    steps = rng.normal(0, speed, size=(num_frames - 1, 2)) + drift
    kernel = np.ones(15) / 15  # a running average: worm-like motion
    steps[:, 0] = np.convolve(steps[:, 0], kernel, mode="same")
    steps[:, 1] = np.convolve(steps[:, 1], kernel, mode="same")
    pos = np.concatenate([[[w / 2, h / 2]], steps]).cumsum(axis=0)
    pos[:, 0] = margin + np.abs(pos[:, 0] - margin) % (2 * (w - 2 * margin)) % (w - 2 * margin)
    pos[:, 1] = margin + np.abs(pos[:, 1] - margin) % (2 * (h - 2 * margin)) % (h - 2 * margin)
    return pos


@dataclass(frozen=True)
class Rig:
    """One rig of a traffic mix: its arena and optics, as an experiment's
    configuration states them, and how many streams track on it."""

    name: str
    streams: int
    orig_resolution_hw: tuple[int, int]
    px_per_mm: float
    frames_per_sec: float
    imaging_ms: float
    pred_ms: float
    moving_ms: float
    camera_mm: tuple[float, float]
    micro_mm: tuple[float, float]
    init_xy: tuple[int, int] | None  # None: each stream starts on its worm

    def frames(self, ms: float) -> int:
        """ms -> frames, rounded up (the timing configuration's rule)."""
        return math.ceil(ms / (1000 / self.frames_per_sec))

    @property
    def schedule(self) -> tuple[int, int, int]:
        """(imaging, prediction, moving) frames of a cycle."""
        return self.frames(self.imaging_ms), self.frames(self.pred_ms), self.frames(self.moving_ms)

    @property
    def camera_px(self) -> tuple[int, int]:
        """(w, h) of the camera in px (mm -> px rounded)."""
        return round(self.px_per_mm * self.camera_mm[0]), round(self.px_per_mm * self.camera_mm[1])

    @property
    def frame_bounds_hw(self) -> tuple[int, int]:
        """(h, w) the platform is clamped to: the arena padded by half a
        camera on each side (the simulator's headless frame; its (w, h)
        padding zipped onto (h, w), as the reference does)."""
        h, w = self.orig_resolution_hw
        cw, ch = self.camera_px
        return h + cw // 2 * 2, w + ch // 2 * 2


@dataclass(frozen=True)
class Streams:
    """Every stream of a run, stream-major in rig order."""

    rig_of: np.ndarray  # (S,) index into ``rigs``
    tracks: np.ndarray  # (S, F, 2) float64 worm (x, y)
    init_xy: np.ndarray  # (S, 2) int64 platform start
    camera_wh: np.ndarray  # (S, 2) int32
    bounds_wh: np.ndarray  # (S, 2) int32 platform clamp bounds


def calibration_inputs(streams: Streams, rig: Rig, n: int):
    """Worm centres, camera top-lefts and frame indices of the int8
    calibration views: the first ``n`` frames of stream 0's track, the camera
    centred on the worm and kept inside the arena."""
    cam_w, cam_h = rig.camera_px
    xy = streams.tracks[0, :n].astype(np.float32)
    hi = np.array([rig.orig_resolution_hw[1] - cam_w, rig.orig_resolution_hw[0] - cam_h], np.float32)
    tl = np.minimum(np.maximum(xy - np.array([cam_w / 2, cam_h / 2], np.float32), 0), hi)
    return xy, tl, np.arange(n)


def load(name: str) -> dict:
    """The traffic file ``traffic/<name>.json``."""
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def rigs(traffic: dict) -> list[Rig]:
    out = []
    for r in traffic["rigs"]:
        init = r.get("init_xy")
        out.append(Rig(name=r["name"], streams=int(r["streams"]), orig_resolution_hw=tuple(r["orig_resolution_hw"]),
                       px_per_mm=float(r["px_per_mm"]), frames_per_sec=float(r["frames_per_sec"]),
                       imaging_ms=float(r["imaging_ms"]), pred_ms=float(r["pred_ms"]),
                       moving_ms=float(r["moving_ms"]), camera_mm=tuple(r["camera_mm"]),
                       micro_mm=tuple(r["micro_mm"]), init_xy=None if init is None else tuple(init)))
    if len({rig.schedule for rig in out}) != 1:
        raise ValueError("every rig of one traffic mix runs the same cycle schedule")
    return out


def streams(traffic: dict, seed: int) -> Streams:
    """Each stream's track from ``seed`` (one numpy stream a track, keyed by
    the seed and the stream's index), its start and its geometry.  Every seed
    gives the same number of streams, tracks of the same length and the same
    geometry."""
    rig_list = rigs(traffic)
    n_frames = int(traffic["track_frames"])
    kw = {k: traffic["track"][k] for k in ("speed", "drift", "margin")}
    rig_of, tracks, init, cams, bounds = [], [], [], [], []
    for r_i, rig in enumerate(rig_list):
        for _ in range(rig.streams):
            s = len(tracks)
            rng = np.random.default_rng([int(seed), s])
            t = make_trajectory(n_frames, rig.orig_resolution_hw, rng, **kw)
            tracks.append(t)
            init.append(rig.init_xy if rig.init_xy is not None else np.round(t[0]).astype(np.int64))
            rig_of.append(r_i)
            cams.append(rig.camera_px)
            bh, bw = rig.frame_bounds_hw
            bounds.append((bw, bh))
    return Streams(rig_of=np.asarray(rig_of), tracks=np.stack(tracks), init_xy=np.asarray(init, dtype=np.int64),
                   camera_wh=np.asarray(cams, dtype=np.int32), bounds_wh=np.asarray(bounds, dtype=np.int32))


def check_sample(traffic: dict, seed: int, n_streams: int) -> np.ndarray:
    """The streams whose every logged frame the reference checks: the first
    and the last stream (the first and the last rows of the detector's
    batches) and others drawn from the seed, ``check_streams`` in all."""
    k = max(2, min(int(traffic["check_streams"]), n_streams))
    order = np.random.default_rng([int(seed), 1 << 20]).permutation(n_streams)
    picked = [0, n_streams - 1] + [int(s) for s in order if s not in (0, n_streams - 1)]
    return np.unique(picked[:k])
