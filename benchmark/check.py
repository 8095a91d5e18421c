"""What decides ``correct``: the timed path's own outputs against the plain
reference (``reference/``), each number beside its limit.

The numbers, each the worst over what it covers:

- ``render_max_abs`` (grey levels): one recorded render call of the window's
  last engine run (its arguments and its views) against the reference
  scene rendered from the same arguments;
- ``head_rel_err``: the detector's raw head outputs of the detect call on
  those views (box and class logits of every anchor) against the reference
  detector's on the reference's views, as ||program - reference|| over the
  reference's spread about each output channel's mean (a constant bias, as
  in the untrained head, would otherwise hide every error);
- ``box_err_px``: every logged frame of the sampled streams
  (``traffic.check_sample``), re-rendered at the program's logged camera
  position and detected by the reference: the distance (largest coordinate,
  px) from the logged box to the nearest reference box among the anchors
  whose class logit lies within ``TIE_WINDOW`` of the reference's best;
- ``presence_gap`` (logit): on the same frames, how far the reference's best
  class logit lies on the other side of the confidence threshold where the
  program logged a box and the reference finds none, or the other way round;
- ``move_excess_px``: every stream and cycle of the run, the program's own
  logged boxes and positions followed by the reference's predictor and motor
  (``reference/loop.py::move_excess``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from benchmark import traffic as traffic_mod
from benchmark.reference.loop import move_excess
from benchmark.reference.render import render
from benchmark.reference.yolo import Detector, letterbox

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TIE_WINDOW = 1.0  # logits: anchors this close to the best are the same answer up to rounding
BLOCK = 96  # views a reference forward


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def reference_detector(config: dict, precision: str, traffic: dict, seed: int, device, bits: int | None = None):
    """The reference detector for ``precision``: float32 for bf16, the
    fake-quantized form (``bits``: 8, or 4 for the int8 configuration's
    control) calibrated on its own renders of the calibration views."""
    det = Detector(str(REPO / config["weights"]), device)
    if precision == "int8" or bits:
        rig = traffic_mod.rigs(traffic)[0]
        streams = traffic_mod.streams(traffic, seed)
        xy, tl, fi = traffic_mod.calibration_inputs(streams, rig, int(config["calibration_views"]))
        cam_w, cam_h = rig.camera_px
        views = render(torch.from_numpy(xy).to(device), torch.from_numpy(tl).to(device), (cam_h, cam_w),
                       torch.from_numpy(fi).to(device))
        det.calibrate(letterbox(views, (cam_h, cam_w), int(config["imgsz"]))[0], bits or 8)
    return det


def _forward_views(det: Detector, views: torch.Tensor, content_wh: np.ndarray, imgsz: int, cam_tl: torch.Tensor):
    """Reference heads (NHWC per level, as the program gives them) and every
    anchor's logit and arena box, over views grouped by content size."""
    n = views.shape[0]
    heads, logits, boxes = None, None, None
    for wh in np.unique(content_wh, axis=0):
        rows = np.flatnonzero((content_wh == wh).all(axis=1))
        for lo in range(0, len(rows), BLOCK):
            r = torch.from_numpy(rows[lo: lo + BLOCK]).to(views.device)
            x, geom = letterbox(views[r], (int(wh[1]), int(wh[0])), imgsz)
            box, cls = det.forward(x)
            lg, bx = det.decode(box, cls, geom, cam_tl[r])
            if heads is None:
                heads = ([torch.empty((n, *t.shape[2:], t.shape[1]), device=t.device) for t in box],
                         [torch.empty((n, *t.shape[2:], t.shape[1]), device=t.device) for t in cls])
                logits = torch.empty((n, lg.shape[1]), dtype=lg.dtype, device=lg.device)
                boxes = torch.empty((n, *bx.shape[1:]), dtype=bx.dtype, device=bx.device)
            for dst, src in zip(heads[0] + heads[1], box + cls):
                dst[r] = src.permute(0, 2, 3, 1)
            logits[r], boxes[r] = lg, bx
    return heads, logits, boxes


def _detections(logits: torch.Tensor, boxes: torch.Tensor, logged: torch.Tensor, conf: float):
    """(presence gap, box error) over frames: reference logits (N, A), boxes
    (N, A, 4), the program's logged (N, 4) boxes (NaN: none)."""
    thr = math.log(conf / (1 - conf))
    present = torch.isfinite(logged).all(dim=1)
    best = logits.max(dim=1).values
    violation = torch.where(present, thr - best, best - thr)
    gap = float(violation.clamp_min(0).max()) if len(best) else 0.0
    both = present & (best >= thr)
    if not bool(both.any()):
        return gap, 0.0
    lg, bx, p = logits[both], boxes[both], logged[both]
    dist = (bx - p[:, None, :]).abs().amax(dim=-1)
    dist = torch.where(lg >= lg.max(dim=1, keepdim=True).values - TIE_WINDOW, dist, torch.inf)
    return gap, float(dist.min(dim=1).values.max())


def numbers(loop, positions: np.ndarray, boxes: np.ndarray, det: Detector, config: dict, traffic: dict,
            seed: int, device) -> dict:
    """Every compared number of one engine run (its logs on the host, its
    recorded render and detect call in ``loop.recorder``)."""
    imgsz, conf = int(config["imgsz"]), float(config["loop"]["conf"])
    streams = loop.streams
    out: dict = {}
    with torch.no_grad():
        rec, heads = loop.recorder.render, loop.recorder.heads
        if rec is None or heads is None:
            raise RuntimeError("the armed engine run recorded no render call or no detect call")
        ref_views = render(rec["worm_xy"], rec["cam_tl"], rec["view_hw"], rec["frame_idx"], rec["content_wh"])
        out["render_max_abs"] = float((rec["views"].float() - ref_views).abs().max())
        h, w = rec["view_hw"]
        content = (np.tile([w, h], (len(ref_views), 1)) if rec["content_wh"] is None
                   else rec["content_wh"].cpu().numpy())
        ref_heads, _, _ = _forward_views(det, ref_views, content, imgsz, rec["cam_tl"].float())
        num = den = 0.0
        for p, r in zip(heads[0] + heads[1], ref_heads[0] + ref_heads[1]):
            r = r.double()
            num += float(((p.double() - r) ** 2).sum())
            den += float(((r - r.mean(dim=(0, 1, 2))) ** 2).sum())
        out["head_rel_err"] = math.sqrt(num / den)

        sample = traffic_mod.check_sample(traffic, seed, len(streams.rig_of))
        C, S, L, _ = positions.shape
        F = streams.tracks.shape[1]
        fidx = np.arange(C * L)
        cam_half = streams.camera_wh // 2
        gap = err = 0.0
        for s in sample:
            cam_w, cam_h = (int(v) for v in streams.camera_wh[s])
            tl = positions[:, s].reshape(C * L, 2).astype(np.int64) - cam_half[s]
            worm = streams.tracks[s, np.minimum(fidx, F - 1)].astype(np.float32)
            views = render(torch.from_numpy(worm).to(device), torch.from_numpy(tl).to(device), (cam_h, cam_w),
                           torch.from_numpy(fidx).to(device))
            tl_t = torch.from_numpy(tl).to(device).float()
            _, logits, bx = _forward_views(det, views, np.tile([cam_w, cam_h], (C * L, 1)), imgsz, tl_t)
            logged = torch.from_numpy(boxes[:, s].reshape(C * L, 4)).to(device)
            g, e = _detections(logits, bx, logged, conf)
            gap, err = max(gap, g), max(err, e)
        out["box_err_px"] = err
        out["presence_gap"] = gap
    imaging_n, pred_n, _ = loop.schedule
    out["move_excess_px"], _ = move_excess(
        positions, boxes, loop.weights, imaging_n=imaging_n, pred_n=pred_n,
        input_frames=config["predictor"]["input_frames"], ring_size=int(config["loop"]["ring_size"]),
        cam_wh=streams.camera_wh.astype(np.int64), bounds_wh=streams.bounds_wh.astype(np.int64),
        max_dist=float(config["loop"]["max_dist_per_pred"]), device=device)
    out["frames_checked"] = int(len(sample) * C * L)
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit (a number
    passes at or under its limit; NaN fails)."""
    compared = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


def reference_detect_fn(det: Detector, imgsz: int, recorder):
    """The reference detector as the loop's detect hook (raw views in, top-1
    xywh boxes in view px out, NaN below the threshold): the int8
    configuration's control puts the reference at int4 here."""
    def detect(model, views, _imgsz, conf):
        n, h, w = views.shape
        x, geom = letterbox(views, (h, w), imgsz)
        box, cls = det.forward(x)
        recorder.on_heads([t.permute(0, 2, 3, 1) for t in box], [t.permute(0, 2, 3, 1) for t in cls])
        lg, bx = det.decode(box, cls, geom, torch.zeros((n, 2), device=views.device))
        best = lg.argmax(dim=1)
        top = bx[torch.arange(n, device=views.device), best].float()
        ok = lg.max(dim=1).values >= math.log(conf / (1 - conf))
        return torch.where(ok[:, None], top, torch.nan)

    detect.folds_preproc = True
    return detect
