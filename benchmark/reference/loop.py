"""The tracking loop's decision and motor, as the reference states them, over
a run's logs: each cycle the ResMLP reads the ring of past imaging-phase
detections at the predictor's frame offsets (newest first, relative to the
newest box), its clipped output plus the newest box's offset from the camera
centre is the move (or, while the history has a gap, the kickoff frame's
box centred, or no move), rounded half to even; the sine motor spreads it
over the moving phase with residual-carrying rounding in float64, clamping
the platform after every step.

:func:`move_excess` follows the program's own logged boxes and positions, so
one detection that differs does not carry into later cycles: for each stream
and cycle it finds the integer moves that reproduce the logged motor
positions and reports how far the nearest lies beyond rounding (0 when the
program rounded the reference's move)."""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch's BatchNorm1d, as the ResMLP is trained with


def mlp(weights: list[dict], x: torch.Tensor) -> torch.Tensor:
    """The residual MLP: an input layer, residual blocks of layers
    (Linear -> BatchNorm -> ReLU, ``x + block(x)``) and a linear head.
    ``weights``: the benchmark's layer list (see ``system.predictor_weights``)."""
    def layer(p, h):
        h = F.linear(h, p["w"], p["b"])
        if "bn_mean" in p:
            h = (h - p["bn_mean"]) / torch.sqrt(p["bn_var"] + BN_EPS) * p["bn_gamma"] + p["bn_beta"]
            h = torch.relu(h)
        return h

    h = layer(weights[0], x)
    for block in weights[1:-1]:
        y = h
        for p in block:
            y = layer(p, y)
        h = h + y
    return layer(weights[-1], h)


def sine_weights(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (np.cos(i * np.pi / n) - np.cos((i + 1) * np.pi / n)) / 2


def motor(pos: np.ndarray, move: np.ndarray, weights: np.ndarray, bounds: np.ndarray):
    """(S, 2) start, (S, 2) integer moves -> the (S, n, 2) positions logged
    before each step and the (S, 2) end, clamped to [0, bound - 1]."""
    resid = np.zeros(move.shape, np.float64)
    p = pos.astype(np.int64)
    logged = []
    for w in weights:
        raw = w * move.astype(np.float64) + resid
        s = np.round(raw)  # half to even
        resid = raw - s
        logged.append(p)
        p = np.minimum(np.maximum(p + s.astype(np.int64), 0), bounds - 1)
    return np.stack(logged, 1), p


def raw_moves(net_weights, ring: np.ndarray, kickoff: int, input_frames: np.ndarray, cam_tl: np.ndarray,
              cam_wh: np.ndarray, max_dist: float, device) -> np.ndarray:
    """(S, 2) float64 moves before rounding, from (S, R, 4) rings."""
    R = ring.shape[1]
    f_in = kickoff + input_frames
    feats = np.where((f_in >= 0)[None, :, None], ring[:, f_in % R, :], np.nan).astype(np.float32)
    cam_center = cam_tl.astype(np.float32) + (cam_wh / 2).astype(np.float32)
    valid = np.isfinite(feats).all(axis=(1, 2))
    rel = feats[:, 0, :2] - cam_center
    x = np.concatenate([feats[:, :, :2] - feats[:, :1, :2], feats[:, :, 2:]], 2).reshape(len(feats), -1)
    x = np.where(valid[:, None], x, 0.0).astype(np.float32)
    with torch.no_grad():
        pred = mlp(net_weights, torch.from_numpy(x).to(device)).clamp(-max_dist, max_dist).cpu().numpy()
    mlp_move = pred[:, :2] + rel
    det = ring[:, kickoff % R, :].astype(np.float32)
    det_ok = np.isfinite(det).all(axis=1)
    det_move = det[:, :2] + det[:, 2:] / 2 - cam_center
    out = np.where(valid[:, None], mlp_move, np.where(det_ok[:, None], det_move, 0.0))
    return out.astype(np.float64)


def move_excess(positions: np.ndarray, boxes: np.ndarray, net_weights, *, imaging_n: int, pred_n: int,
                input_frames, ring_size: int, cam_wh: np.ndarray, bounds_wh: np.ndarray, max_dist: float,
                device) -> tuple[float, int]:
    """Over (C, S, L, 2) logged positions and (C, S, L, 4) logged boxes: the
    largest amount by which a move that reproduces the program's logged motor
    positions lies beyond 0.5 px of the reference's unrounded move (1e9 where
    no integer move reproduces them), and the number of moves checked."""
    C, S, L, _ = positions.shape
    mv = L - imaging_n
    weights = sine_weights(mv)
    cam_half = cam_wh // 2
    ring = np.full((S, ring_size, 4), np.nan)
    frames = np.asarray(input_frames)
    worst = 0.0
    for c in range(C):
        img = c * L + np.arange(imaging_n)
        ring[:, img % ring_size] = boxes[c, :, :imaging_n]
        pos = positions[c, :, 0].astype(np.int64)
        cam_tl = pos - cam_half
        r = raw_moves(net_weights, ring, c * L + imaging_n - pred_n, frames, cam_tl, cam_wh, max_dist, device)
        logged = positions[c, :, imaging_n:].astype(np.int64)
        end = positions[c + 1, :, 0].astype(np.int64) if c + 1 < C else None
        best = np.full(S, np.inf)
        cands = [np.stack([np.floor(r[:, 0]) + i, np.floor(r[:, 1]) + j], 1) for i, j in itertools.product((0, 1), (0, 1))]
        if end is not None:
            cands.append((end - pos).astype(np.float64))
        for m in cands:
            lg, fin = motor(pos, m.astype(np.int64), weights, bounds_wh)
            ok = (lg == logged).all(axis=(1, 2))
            if end is not None:
                ok &= (fin == end).all(axis=1)
            best = np.where(ok, np.minimum(best, np.abs(m - r).max(axis=1)), best)
        excess = np.where(np.isfinite(best), np.maximum(best - 0.5, 0.0), 1e9)
        worst = max(worst, float(excess.max()))
    return worst, C * S
