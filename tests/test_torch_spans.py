"""The program's spans (``wtracker_tpu_torch/utils/profiling.py::span``) in
the closed tracking loop, on the CPU at a tiny size: the fused loop (the
YOLOv8 "n" detector at 64 px with the folded stem, 2 streams, 2 cycles, 2
detect sub-batches) and the mixed-geometry loop (2 rigs' cameras, 2
streams each, ``letterbox_indexed``, 2 sub-batches a phase).

With no profiler running a span enters no ``record_function``; inside a
``torch.profiler`` session the spans nest as the layers do
(``wt.run`` > ``wt.cycle`` > ``wt.detect`` > {``wt.render``,
``wt.preprocess``, ``wt.detector``, ``wt.decode``}, and ``wt.predict`` and
``wt.motor`` in the cycle), their counts are the loop's cycles and
sub-batches, no span synchronises, and the logs are bit-identical with and
without the session."""

import types
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine import run_engine_streams
from wtracker_tpu_torch.sim.engine_hetero import StreamGeometry, geometry_from_configs, yolo_mlp_controller_hetero
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig, make_stream_batch_fused
from wtracker_tpu_torch.sim.synthetic import SyntheticScene, make_trajectory
from wtracker_tpu_torch.tools import trace_profile
from wtracker_tpu_torch.tools.bench import build_flagship
from wtracker_tpu_torch.utils.profiling import span

torch.set_num_threads(2)

CYCLES, CHUNKS = 2, 2
LAYERS = ("wt.render", "wt.preprocess", "wt.detector", "wt.decode")
PARENT = {"wt.cycle": "wt.run", "wt.detect": "wt.cycle", "wt.predict": "wt.cycle", "wt.motor": "wt.cycle",
          **{name: "wt.detect" for name in LAYERS}}


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    path = tmp_path_factory.mktemp("nano") / "nano.npz"
    YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=3, device="cpu").save(str(path))
    return str(path)


def _fused(nano):
    ctx = build_flagship(S=2, n_cycles=CYCLES, chunks=CHUNKS, detector=nano, imgsz=64, device="cpu")
    # the bf16 loop with every view's box logged (the random detector scores low)
    ctl = make_stream_batch_fused(ctx.params, replace(ctx.cfg, conf=0.0), ctx.scene, ctx.trajs, ctx.det_model,
                                  ctx.predictor, device="cpu")
    return types.SimpleNamespace(run=lambda: ctx.run(ctl), cycles=CYCLES + 1, detects=CHUNKS * (CYCLES + 1))


def _hetero(nano):
    exps = [ExperimentConfig(name=f"rig{i}", num_frames=400, frames_per_sec=60, orig_resolution=res, px_per_mm=ppm,
                             init_position=(200, 200))
            for i, (res, ppm) in enumerate((((400, 420), 90), ((380, 440), 92)))]
    timings = [TimingConfig(experiment_config=e, imaging_time_ms=200.0, pred_time_ms=40.0, moving_time_ms=50.0,
                            camera_size_mm=(1.2, 1.1), micro_size_mm=(0.25, 0.25)) for e in exps]
    params, per_rig = geometry_from_configs(timings, exps)
    rig_of = np.array([0, 0, 1, 1])
    geometry = StreamGeometry(*(a[rig_of] for a in per_rig))
    trajs = np.stack([make_trajectory(400, tuple(geometry.bounds[i][::-1]), seed=20 + i) for i in range(4)])
    model = YoloV8Detector.load(nano, imgsz=64, device="cpu").fuse().model.eval()
    predictor = make_rmlp_predictor(IOConfig([0, -2, -4], [3]), block_in_dim=8, block_dims=(8,), n_blocks=1,
                                    device="cpu")
    cfg = LiveLoopConfig(imgsz=(64, 64), conf=0.0, ring_size=32, max_dist_per_pred=20.0, detect_chunks=CHUNKS)
    ctl = yolo_mlp_controller_hetero(params, geometry, cfg, SyntheticScene(), trajs, model, predictor, device="cpu")
    init = np.full((4, 2), 200)

    def run():
        return run_engine_streams(params, ctl, init, CYCLES, batched_controller=True, device="cpu")

    return types.SimpleNamespace(run=run, cycles=CYCLES, detects=2 * CHUNKS * CYCLES)


LOOPS = {"fused": _fused, "hetero": _hetero}


def _spans(prof) -> list[tuple[str, int, int]]:
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("wt.")), key=lambda sp: (sp[1], -sp[2]))


def _parents(spans) -> list[str | None]:
    """The innermost span enclosing each span (they nest: one thread)."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return out


def test_span_is_one_null_context_without_a_profiler():
    assert span("wt.cycle") is span("wt.detector")
    with span("wt.cycle") as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        inside = span("wt.cycle")
        assert inside is not span("wt.cycle")
        with inside:
            pass
    assert span("wt.cycle") is span("wt.motor")


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_no_record_function_without_a_profiler(kind, nano, monkeypatch):
    loop = LOOPS[kind](nano)

    def refused(*args, **kwargs):
        raise AssertionError("a span entered record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    logs = loop.run()
    assert torch.isfinite(logs.worm_bboxes).all()


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_spans_nest_and_count_in_a_traced_loop(kind, nano, monkeypatch):
    loop = LOOPS[kind](nano)
    plain = loop.run()

    def refused(*args, **kwargs):
        raise AssertionError("a span synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = loop.run()
    spans = _spans(prof)
    names = [name for name, _, _ in spans]
    counts = {name: names.count(name) for name in set(names)}
    assert counts == {"wt.run": 1, "wt.cycle": loop.cycles, "wt.detect": loop.detects, "wt.predict": loop.cycles,
                      "wt.motor": loop.cycles, **{name: loop.detects for name in LAYERS}}
    for (name, _, _), parent in zip(spans, _parents(spans)):
        assert parent == PARENT.get(name), (name, parent)
    # what trace_profile reads from the same session
    layers = {row["name"]: row for row in trace_profile.span_layers(prof)}
    assert {name: row["calls"] for name, row in layers.items()} == counts
    assert all(row["host_ms"] > 0 and row["device_ms"] == row["self_device_ms"] == 0 for row in layers.values())
    # the logs are bit-identical with and without the session
    for a, b in ((plain.positions, traced.positions), (plain.worm_bboxes, traced.worm_bboxes)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint8), b.numpy().view(np.uint8))
