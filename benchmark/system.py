"""The system under test: the port's closed tracking loop for one cell, built
from the port's entry points (``wtracker_tpu_torch``), and nothing else of the
port.

- ``"fused"`` traffic runs ``sim/engine_live.py::make_stream_batch_fused``
  through ``sim/engine.py::run_engine_streams(delayed_log=True)``: one
  detector batch a cycle (the previous cycle's moving phase and this one's
  imaging phase), the folded stem where the detector folds it;
- ``"hetero"`` traffic runs ``sim/engine_hetero.py::yolo_mlp_controller_hetero``
  through ``run_engine_streams(batched_controller=True)``: rigs with
  different cameras in one batch, ``letterbox_indexed`` and the standard stem.

The benchmark observes the timed path without changing its work: the scene
it hands the loop records the arguments and views of one render call, and a
forward hook (the bf16 module, the int8 module) or an override of
``QuantizedYolo.apply_folded`` records the head outputs of the detect call
that follows; both clone only that one call's tensors.  ``fault=`` breaks
the path for the harness's own tests (see ``FAULTS``).
"""

from __future__ import annotations

import copy
import hashlib
import math
import types
from dataclasses import fields
from pathlib import Path

import torch

from benchmark import traffic as traffic_mod

REPO = Path(__file__).resolve().parents[1]
FAULTS = ("state_unchanged", "half_batch", "box_altered", "move_altered", "view_altered")


class Recorder:
    """Keeps clones of the ``target``-th render call and detect call of an
    armed engine run."""

    def __init__(self):
        self.armed = False
        self.target = -1
        self.renders = self.detects = 0
        self.render: dict | None = None
        self.heads: tuple | None = None

    def arm(self, target: int) -> None:
        self.armed, self.target = True, target
        self.renders = self.detects = 0
        self.render = self.heads = None

    def on_render(self, worm_xy, cam_tl, view_hw, frame_idx, content_wh, views) -> None:
        if self.armed:
            if self.renders == self.target:
                self.render = {"worm_xy": worm_xy.clone(), "cam_tl": cam_tl.clone(), "view_hw": tuple(view_hw),
                               "frame_idx": frame_idx.clone(), "views": views.clone(),
                               "content_wh": None if content_wh is None else content_wh.clone()}
            self.renders += 1

    def on_heads(self, box, cls) -> None:
        if self.armed:
            if self.detects == self.target:
                self.heads = ([t.clone() for t in box], [t.clone() for t in cls])
            self.detects += 1


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def pick_chunks(n_views: int, target_views: int) -> int:
    """Detect sub-batches of a batch of ``n_views``: the divisor whose
    sub-batch lies nearest ``target_views`` (the bench's rule)."""
    divisors = [d for d in range(1, n_views + 1) if n_views % d == 0]
    return min(divisors, key=lambda d: abs(n_views / d - target_views))


def _sub_batches(n_views: int, chunks: int, cycles: int) -> tuple[int, int]:
    """(views a detect call, calls) of a batch the loop splits into ``chunks``
    sub-batches once a cycle (one batch where ``chunks`` does not divide it)."""
    if chunks <= 1 or n_views % chunks:
        return n_views, cycles
    return n_views // chunks, cycles * chunks


def load_detector(config: dict, device):
    """The configuration's detector as the port loads it: the BN-fused
    float32 model, read from the configuration's checkpoint, whose hash is
    checked."""
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

    path = REPO / config["weights"]
    if sha256(path) != config["weights_sha256"]:
        raise RuntimeError(f"{config['weights']} is not the checkpoint this configuration states")
    raw = YoloV8Detector.load(str(path), imgsz=int(config["imgsz"]), device=device)
    if raw.model.scale != config["scale"] or raw.model.nc != int(config["nc"]):
        raise RuntimeError("the checkpoint's scale or class count differs from the configuration's")
    return raw.fuse().model


def predictor_weights(config: dict, seed: int, device) -> list:
    """The ResMLP's weights drawn from ``seed`` on ``device`` (the repository
    ships no trained predictor): each Linear's kernel normal with standard
    deviation 1/sqrt(fan-in) (LeCun), biases 0, BatchNorm at identity.
    Layout: [input layer, block 0's layers, ..., head]."""
    p = config["predictor"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    in_dim = 4 * len(p["input_frames"])
    width, dims = int(p["block_in_dim"]), [int(d) for d in p["block_dims"]]

    def layer(fan_in, fan_out, bn=True):
        w = torch.randn((fan_out, fan_in), generator=gen, device=device) / math.sqrt(fan_in)
        out = {"w": w, "b": torch.zeros(fan_out, device=device)}
        if bn:
            out.update(bn_gamma=torch.ones(fan_out, device=device), bn_beta=torch.zeros(fan_out, device=device),
                       bn_mean=torch.zeros(fan_out, device=device), bn_var=torch.ones(fan_out, device=device))
        return out

    blocks = []
    for _ in range(int(p["n_blocks"])):
        d_in, block = width, []
        for d in dims:
            block.append(layer(d_in, d))
            d_in = d
        blocks.append(block)
    return [layer(in_dim, width), *blocks, layer(width, 2 * len(p["pred_frames"]), bn=False)]


def _port_state(weights: list) -> dict:
    """The weights under the port's ResMLP names."""
    def put(prefix, p, out):
        out[f"{prefix}dense.weight" if "bn_mean" in p else f"{prefix}weight"] = p["w"]
        out[f"{prefix}dense.bias" if "bn_mean" in p else f"{prefix}bias"] = p["b"]
        if "bn_mean" in p:
            out.update({f"{prefix}bn.weight": p["bn_gamma"], f"{prefix}bn.bias": p["bn_beta"],
                        f"{prefix}bn.running_mean": p["bn_mean"], f"{prefix}bn.running_var": p["bn_var"],
                        f"{prefix}bn.num_batches_tracked": torch.tensor(0)})

    out: dict = {}
    put("input.", weights[0], out)
    for i, block in enumerate(weights[1:-1]):
        for j, p in enumerate(block):
            put(f"block_{i}.layer_{j}.", p, out)
    put("output.", weights[-1], out)
    return out


def make_predictor(config: dict, weights: list, device):
    from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
    from wtracker_tpu_torch.neural.config import IOConfig

    p = config["predictor"]
    pred = make_rmlp_predictor(IOConfig(list(p["input_frames"]), list(p["pred_frames"])),
                               block_in_dim=int(p["block_in_dim"]), block_dims=tuple(p["block_dims"]),
                               n_blocks=int(p["n_blocks"]), device=device)
    pred.model.load_state_dict(_port_state(weights))
    return pred


def _recording_scene(recorder: Recorder, fault: str | None):
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    class RecordingScene(SyntheticScene):
        def render_views(self, worm_xys, cam_tls, view_hw, frame_idx, content_whs=None):
            if fault == "half_batch":  # the second half of the views left out, the first half's in their place
                n, h = worm_xys.shape[0], (worm_xys.shape[0] + 1) // 2
                first = super().render_views(worm_xys[:h], cam_tls[:h], view_hw, frame_idx[:h],
                                             None if content_whs is None else content_whs[:h])
                views = torch.cat([first, first[: n - h]])
            else:
                views = super().render_views(worm_xys, cam_tls, view_hw, frame_idx, content_whs)
            if fault == "view_altered":
                views = views.clone()
                views[0, :16, :16] += 8.0
            recorder.on_render(worm_xys, cam_tls, view_hw, frame_idx, content_whs, views)
            return views

    return RecordingScene()


def _int8_path(model32, config, streams, rig, scene, size, recorder, device, folded: bool):
    """The post-training int8 detector, calibrated on the calibration views
    through the port's ``quantize_detector``: (engine module, detect hook)."""
    from wtracker_tpu_torch.models.yolov8_int8 import Int8Detector, QuantizedYolo, make_detect_fns, quantize_detector

    xy, tl, fi = traffic_mod.calibration_inputs(streams, rig, int(config["calibration_views"]))
    cam_w, cam_h = rig.camera_px
    calib = scene.render_views(torch.from_numpy(xy).to(device), torch.from_numpy(tl).to(device), (cam_h, cam_w),
                               torch.from_numpy(fi).to(device))
    q = quantize_detector(model32, calib, size)

    class RecordingQuantized(QuantizedYolo):
        def apply_folded(self, qw, views, folded_stem):
            box, cls = super().apply_folded(qw, views, folded_stem)
            recorder.on_heads(box, cls)
            return box, cls

    q = RecordingQuantized(**{f.name: getattr(q, f.name) for f in fields(q)})
    qw = q.device_weights(device)
    module = Int8Detector(q, qw)
    if folded:
        detect, _ = make_detect_fns(q, src_hw=(cam_h, cam_w), imgsz=size, qw=qw)
        return module, detect
    module.register_forward_hook(lambda m, args, out: recorder.on_heads(*out))
    return module, None


def _wrap_faults(ctl, fault: str | None):
    if fault == "state_unchanged":
        decide = ctl.decide

        def stuck(consts, state, ctx):
            return state, decide(consts, state, ctx)[1]

        return ctl._replace(decide=stuck)
    if fault == "move_altered":
        decide = ctl.decide

        def altered(consts, state, ctx):
            state, dxdy = decide(consts, state, ctx)
            return state, dxdy + torch.tensor([[1, 0]], dtype=dxdy.dtype, device=dxdy.device)

        return ctl._replace(decide=altered)
    if fault == "box_altered":
        predict_all = ctl.predict_all

        def altered_rows(consts, state, cycle, positions):
            rows = predict_all(consts, state, cycle, positions).clone()
            rows[:, 0, 0] += 4.0
            return rows

        return ctl._replace(predict_all=altered_rows)
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return ctl


def build(config: dict, traffic: dict, seed: int, device, model32, *, precision: str | None = None,
          fault: str | None = None, detect_override=None):
    """The cell's loop over ``seed``'s streams.  ``precision`` replaces the
    configuration's (the control runs the bf16 cells' loop through the int8
    path); ``detect_override(recorder)`` gives a ``(module, detect_fn)`` to
    put in the detector's place (the int8 configuration's control: the
    reference at int4).  Returns a namespace:
    ``run(cycles)`` (one engine run, its logs on the host), ``recorder``, the
    streams and the geometry the reference needs."""
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams, headless_frame_shape, run_engine_streams
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused

    dev = torch.device(device)
    precision = precision or config["precision"]
    rigs = traffic_mod.rigs(traffic)
    streams = traffic_mod.streams(traffic, seed)
    S = len(streams.rig_of)
    n_cycles = int(traffic["cycles_per_run"])
    size = (int(config["imgsz"]),) * 2
    recorder = Recorder()
    scene = _recording_scene(recorder, fault)
    weights = predictor_weights(config, seed, dev)
    predictor = make_predictor(config, weights, dev)

    exps, timings = [], []
    for rig in rigs:
        exps.append(ExperimentConfig(rig.name, int(traffic["track_frames"]), rig.frames_per_sec,
                                     tuple(rig.orig_resolution_hw), rig.px_per_mm, (0, 0)))
        timings.append(TimingConfig(experiment_config=exps[-1], imaging_time_ms=rig.imaging_ms,
                                    pred_time_ms=rig.pred_ms, moving_time_ms=rig.moving_ms,
                                    camera_size_mm=tuple(rig.camera_mm), micro_size_mm=tuple(rig.micro_mm)))
    imaging_n, pred_n, moving_n = rigs[0].schedule
    cycle_n = imaging_n + moving_n
    loop = traffic["controller"]
    batch = S * (cycle_n if loop == "fused" else imaging_n)
    chunks = pick_chunks(batch, int(config["batch_views"][precision]))
    cfg = LiveLoopConfig(imgsz=size, conf=float(config["loop"]["conf"]), ring_size=int(config["loop"]["ring_size"]),
                         log_mode=True, max_dist_per_pred=float(config["loop"]["max_dist_per_pred"]),
                         detect_chunks=chunks)

    if detect_override is not None:
        module, detect_fn = detect_override(recorder)
    elif precision == "int8":
        module, detect_fn = _int8_path(model32, config, streams, rigs[0], scene, size, recorder, dev,
                                       folded=loop == "fused")
    elif precision == "bf16":
        module, detect_fn = copy.deepcopy(model32).to(torch.bfloat16), None
        module.register_forward_hook(lambda m, args, out: recorder.on_heads(*out))
    else:
        raise ValueError(f"unknown precision {precision!r}")

    if loop == "fused":
        if len(rigs) != 1:
            raise ValueError("the fused loop runs one rig's geometry")
        params = EngineParams.from_timing(timings[0], headless_frame_shape(timings[0], exps[0].orig_resolution))
        ctl = make_stream_batch_fused(params, cfg, scene, streams.tracks, module, predictor, detect_fn=detect_fn,
                                      device=dev)
        run_kw, device_cycles = dict(delayed_log=True), n_cycles + 1
        batches = [_sub_batches(S * cycle_n, chunks, device_cycles)]
    elif loop == "hetero":
        from wtracker_tpu_torch.sim.engine_hetero import StreamGeometry, geometry_from_configs, yolo_mlp_controller_hetero

        params, per_rig = geometry_from_configs(timings, exps)
        geometry = StreamGeometry(*(a[streams.rig_of] for a in per_rig))
        canvas = (int(streams.camera_wh[:, 1].max()), int(streams.camera_wh[:, 0].max()))
        ctl = yolo_mlp_controller_hetero(params, geometry, cfg, scene, streams.tracks, module, predictor,
                                         canvas_hw=canvas, device=dev)
        run_kw, device_cycles = dict(batched_controller=True), n_cycles
        batches = [_sub_batches(S * imaging_n, chunks, device_cycles), _sub_batches(S * moving_n, chunks, device_cycles)]
    else:
        raise ValueError(f"unknown loop {loop!r}")
    ctl = _wrap_faults(ctl, fault)

    def run(cycles: int = n_cycles):
        logs = run_engine_streams(params, ctl, streams.init_xy, cycles, device=dev, **run_kw)
        return logs.positions.cpu().numpy(), logs.worm_bboxes.cpu().numpy()

    return types.SimpleNamespace(
        run=run, recorder=recorder, streams=streams, weights=weights, batches=batches, calls=sum(c for _, c in batches),
        device_cycles=device_cycles, frames_per_run=n_cycles * S * cycle_n, views_per_run=device_cycles * S * cycle_n,
        schedule=(imaging_n, pred_n, moving_n), precision=precision, stem_folded=loop == "fused", module=module,
        controller=ctl,
    )
