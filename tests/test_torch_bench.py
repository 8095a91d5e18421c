"""The port's benches (``wtracker_tpu_torch/tools/bench.py`` and
``bench_video.py``) against the JAX package's ``bench.py``, on the CPU.

* ``build_flagship`` at S = 1, 4 and 96: the engine parameters, the loop
  configuration, the initial positions, the steps a window, the bf16 and
  int8 detect sub-batches (with and without the ``BENCH_CHUNKS*``
  overrides) and the first 400 frames of every track equal JAX's.  The JAX
  builder runs in a child process: it sets the JAX compilation cache.
* ``make_decide("bf16", 1)``: the camera origin bit for bit, the views
  within the renderer's tolerance (``tests/test_torch_engine_live.py``).
* ``_tails_ms`` and ``measure_decision_cadence`` (on a stand-in decision
  that sleeps) give JAX's numbers.
* The decision latency on the CPU has host samples and no ``device``
  field; on a card (``cuda`` marker, skipped here) each call's busy time
  from a ``torch.profiler`` trace, within its host time.  ``call_busy_s``
  (the trace's attribution: each call's kernels by time, their intervals'
  union) on synthetic records.
* ``_measure``'s JSON line (a nano detector at 64 px) has every field of
  JAX's line but ``vs_baseline``, and the card; the video bench over a
  2-cycle recording returns its frames, cycles and decode share, with ROI
  statistics when streaming windows.
* ``bench_video --generate --cpu`` writes ``recording.write_frames``'s
  bytes.  Without a card, ``python -m wtracker_tpu_torch.tools.bench``
  prints the unavailable line and exits 1, and the entry points raise.

YOLOv8s@416 is only loaded here, never run.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import asdict

import numpy as np
import pytest
import torch

import bench as jax_bench
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.sim.synthetic import make_trajectory
from wtracker_tpu_torch.tools import bench, bench_video, recording, trace_profile

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = (1, 4, 96)
OVERRIDES = {"BENCH_CHUNKS": "7", "BENCH_CHUNKS_INT8": "11"}  # at S=4: 60 views -> 6 and 10 sub-batches
CFG_FIELDS = ("imgsz", "conf", "ring_size", "log_mode", "max_dist_per_pred", "detect_chunks")
KNOBS = ("BENCH_STREAMS", "BENCH_CYCLES", "BENCH_REPEATS", "BENCH_CHUNKS", "BENCH_CHUNKS_BF16", "BENCH_CHUNKS_INT8",
         "BENCH_WEIGHTS", "BENCH_INT8", "BENCH_LATENCY", "BENCH_VIDEO", "BENCH_VIDEO_DIR", "BENCH_VIDEO_ROI")

JAX_SIDE = r"""
import dataclasses, json, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import bench

def record(ctx):
    cells = dict(zip(ctx.make_ctl.__code__.co_freevars, ctx.make_ctl.__closure__))
    return {
        "params": {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(ctx.params).items()},
        "cfg": {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(ctx.cfg).items()},
        "chunks_int8": ctx.chunks_int8, "n_cycles": ctx.n_cycles, "steps": ctx.steps,
        "init_pos": np.asarray(ctx.init_pos).tolist(),
    }, np.asarray(cells["trajs"].cell_contents)[:, :400]

out, arrays = {}, {}
for S in (1, 4, 96):
    out[S], arrays[f"trajs{S}"] = record(bench.build_flagship(S, n_cycles=1))
    if S == 1:
        decide, views, cam_tl = bench.build_flagship(1, n_cycles=1).make_decide("bf16", 1)
        arrays["views"], arrays["cam_tl"] = np.asarray(views), np.asarray(cam_tl)
os.environ.update(%(overrides)r)
out["overrides"], _ = record(bench.build_flagship(4, n_cycles=1))
np.savez(sys.argv[1], **arrays)
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def jax_flagship(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_bench")
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp / "cache"), PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", JAX_SIDE % {"overrides": OVERRIDES}, str(tmp / "arrays.npz")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), dict(np.load(tmp / "arrays.npz"))


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    path = tmp_path_factory.mktemp("nano") / "nano.npz"
    YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=3, device="cpu").save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """A 2-cycle recording (31 whole 1400x1600 frames) along a seeded
    track, written as BMPs by ``recording.write_frames``."""
    out = tmp_path_factory.mktemp("rec") / "frames"
    out.mkdir()
    traj = make_trajectory(31, recording.ARENA, seed=0)
    recording.write_frames(str(out), recording.render_frames(traj, 0, 31, recording.ARENA, "cpu"))
    return str(out)


def _record(ctx) -> dict:
    return {
        "params": {k: list(v) if isinstance(v, tuple) else v for k, v in asdict(ctx.params).items()},
        "cfg": {k: list(v) if isinstance(v, tuple) else v for k, v in asdict(ctx.cfg).items() if k in CFG_FIELDS},
        "chunks_int8": ctx.chunks_int8, "n_cycles": ctx.n_cycles, "steps": ctx.steps,
        "init_pos": np.asarray(ctx.init_pos).tolist(),
    }


def _jax_record(want: dict) -> dict:
    return {**want, "cfg": {k: want["cfg"][k] for k in CFG_FIELDS}}


@pytest.mark.parametrize("S", STREAMS)
def test_build_flagship_matches_jax(jax_flagship, S):
    want, arrays = jax_flagship
    ctx = bench.build_flagship(S, n_cycles=1, device="cpu")
    assert _record(ctx) == _jax_record(want[str(S)])
    assert ctx.trajs.shape == (S, 60_000, 2)
    np.testing.assert_array_equal(ctx.trajs[:, :400], arrays[f"trajs{S}"])
    assert ctx.det_model.scale == "s" and ctx.det_model.compute_dtype == torch.bfloat16


def test_chunk_overrides_match_jax(jax_flagship, monkeypatch):
    want, _ = jax_flagship
    monkeypatch.setenv("BENCH_CHUNKS", OVERRIDES["BENCH_CHUNKS"])
    monkeypatch.setenv("BENCH_CHUNKS_INT8", OVERRIDES["BENCH_CHUNKS_INT8"])
    ctx = bench.build_flagship(4, n_cycles=1, device="cpu")
    assert _record(ctx) == _jax_record(want["overrides"])
    assert (ctx.cfg.detect_chunks, ctx.chunks_int8) == (6, 10)


def test_make_decide_inputs_match_jax(jax_flagship):
    _, arrays = jax_flagship
    decide, views, cam_tl = bench.build_flagship(1, n_cycles=1, device="cpu").make_decide("bf16", 1)
    assert cam_tl.dtype == torch.float32 and views.shape == (1, 5, 360, 360)
    np.testing.assert_array_equal(cam_tl.numpy(), arrays["cam_tl"])
    np.testing.assert_allclose(views.numpy(), arrays["views"], atol=1e-3)


def test_one_flagship_builder():
    """``trace_profile`` builds its loop with the bench's builder."""
    assert not hasattr(trace_profile, "build_loop") and not hasattr(trace_profile, "pick_chunks")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tails_ms_matches_jax(seed):
    samples = list(np.random.default_rng(seed).gamma(2.0, 0.004, 37 + seed))
    assert bench._tails_ms(samples) == jax_bench._tails_ms(samples)


class _SleepingDecision:
    """A stand-in context whose decision sleeps ``sleep_s`` a call."""

    def __init__(self, sleep_s: float):
        self.sleep_s = sleep_s

    def make_decide(self, variant, S):
        def decide(views, cam_tl):
            time.sleep(self.sleep_s)
            return torch.zeros((S, 2), dtype=torch.int32)

        return decide, torch.zeros((S, 5, 8, 8)), torch.zeros((S, 2))


@pytest.mark.parametrize("sleep_s, misses", [(0.0, 0), (0.08, 4)], ids=["fast", "slow"])
def test_decision_cadence_matches_jax(sleep_s, misses):
    got = bench.measure_decision_cadence(_SleepingDecision(sleep_s), "bf16", 40.0, n=4)
    want = jax_bench.measure_decision_cadence(_SleepingDecision(sleep_s), "bf16", 40.0, n=4)
    assert set(got) == set(want)
    assert (got["misses"], got["n"], got["period_ms"]) == (want["misses"], want["n"], want["period_ms"]) == (misses, 4, 250.0)
    assert "tunnel" not in got["verdict"] and f"{misses}/4" in got["verdict"]


def test_decision_latency_on_the_cpu(nano):
    ctx = bench.build_flagship(1, n_cycles=1, detector=nano, imgsz=64, device="cpu")
    moves = []
    out = bench.measure_decision_latency(ctx, "bf16", 1, n=4, moves=moves)
    assert set(out) == {"n", "e2e_ms", "e2e"}  # no device span without a card, and no host time in its place
    assert out["n"] == len(moves) == 4 and set(out["e2e"]) == {"p50_ms", "p95_ms", "max_ms"}
    assert 0 < out["e2e_ms"] <= out["e2e"]["p50_ms"] <= out["e2e"]["p95_ms"] <= out["e2e"]["max_ms"]
    assert all(m.shape == (1, 2) and m.dtype == torch.int32 and torch.equal(m, moves[0]) for m in moves)


@pytest.mark.cuda
def test_decision_latency_on_the_card(nano):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device time is read from a trace of the card")
    ctx = bench.build_flagship(1, n_cycles=1, detector=nano, imgsz=64, device="cuda")
    samples = {}
    out = bench.measure_decision_latency(ctx, "bf16", 4, n=6, samples=samples)
    assert set(out) == {"n", "device_ms", "e2e_ms", "e2e", "device"} and out["n"] == 6
    d = out["device"]
    assert 0 < d["p50_ms"] <= d["p95_ms"] <= d["max_ms"] and out["device_ms"] > 0
    assert len(samples["device"]) == len(samples["traced_e2e"]) == 6
    assert all(0 < dev <= host for dev, host in zip(samples["device"], samples["traced_e2e"]))


def test_call_busy_time_is_the_union_of_each_calls_kernels():
    """Synthetic trace records (ns): each call starts on an idle card, so its
    kernels are those that start from its range's start until the next
    call's; overlapping kernels count once, gaps not at all; kernels before
    the first call are not counted; a call without a kernel raises."""
    calls = [(100, 200), (3_000, 3_100), (5_000, 5_100)]
    kernels = [
        (10, 90),  # before the first call: nobody's
        (1_000, 1_300), (1_200, 1_500), (1_400, 1_450),  # call 0: overlaps, union 1_000-1_500
        (1_600, 1_700),  # call 0 again after a gap
        (3_050, 3_060),  # call 1, starting inside its range
        (6_000, 6_050), (6_050, 6_070),  # call 2: touching intervals
    ]
    busy = bench.call_busy_s(calls, kernels)
    np.testing.assert_allclose(busy, [600e-9, 10e-9, 70e-9], rtol=0, atol=1e-18)
    # a kernel that starts at a call's first instant belongs to it
    assert bench.call_busy_s([(0, 10), (20, 30)], [(0, 5), (20, 21)]) == [5e-9, 1e-9]
    with pytest.raises(RuntimeError, match="call 1 of 3 launched no kernel"):
        bench.call_busy_s(calls, [k for k in kernels if k[0] != 3_050])


LATENCY_KEYS = {"n", "e2e_ms", "e2e"}
CADENCE_KEYS = {"period_ms", "n", "misses", "p50_ms", "p95_ms", "max_ms", "verdict"}
VIDEO_KEYS = {"metric", "value", "unit", "wall_s", "host_decode_s", "decode_share", "frames", "cycles"}


def test_measure_line_has_every_field(nano, rec, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_STREAMS", "1")
    monkeypatch.setenv("BENCH_CYCLES", "1")
    monkeypatch.setenv("BENCH_REPEATS", "1")
    monkeypatch.setenv("BENCH_VIDEO", "1")
    monkeypatch.setenv("BENCH_VIDEO_DIR", rec)
    out = bench._measure(detector=nano, imgsz=64, device="cpu", latency_n=3, cadence_n=2)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    # JAX's line (bench.py:447-524) without vs_baseline, with the card
    assert set(out) == {"metric", "value", "unit", "mean", "chunks", "card", "gates", "int8", "latency_ms",
                        "video_path", "video_path_roi"}
    assert out["metric"] == json.loads(jax_bench._unavailable(""))["metric"] and out["unit"] == "steps/s"
    assert out["value"] >= out["mean"] > 0 and out["card"] is None
    assert out["chunks"] == {"bf16": 1, "int8": 1, "views_per_chunk_bf16": 15, "views_per_chunk_int8": 15}
    with open(os.path.join(ROOT, "GATES_TORCH.json")) as f:
        assert out["gates"] == json.load(f)
    assert set(out["int8"]) == {"value", "mean"}
    lat = out["latency_ms"]
    assert set(lat) == {"budget_ms", "bf16_s1", "bf16_s4", "bf16_cadence", "int8_s1", "int8_s4", "int8_cadence", "verdict"}
    for v in ("bf16", "int8"):
        assert set(lat[f"{v}_s1"]) == set(lat[f"{v}_s4"]) == LATENCY_KEYS and lat[f"{v}_s4"]["n"] == 3
        assert set(lat[f"{v}_cadence"]) == CADENCE_KEYS and lat[f"{v}_cadence"]["n"] == 2
    assert lat["budget_ms"] == 40.0 and "budget" in lat["verdict"] and "tunnel" not in lat["verdict"]
    assert set(out["video_path"]) == VIDEO_KEYS and set(out["video_path_roi"]) == VIDEO_KEYS | {"roi"}
    assert "vs_baseline" not in json.dumps(out)


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_video_bench_on_a_recording(nano, rec, variant):
    out = bench_video.run(rec, variant, chunk_cycles=1, detector=nano, imgsz=64, device="cpu")
    params = bench.build_flagship(1, n_cycles=1, detector=nano, imgsz=64, device="cpu").params
    assert set(out) == VIDEO_KEYS
    assert out["frames"] == 31 and out["cycles"] == params.n_logged_cycles(31) == 2
    assert 0.0 <= out["decode_share"] <= 1.0 and out["value"] > 0 and f"({variant}," in out["metric"]
    roi = bench_video.run(rec, variant, chunk_cycles=1, roi=512, roi_chunk_cycles=1, detector=nano, imgsz=64,
                          device="cpu")
    assert set(roi) == VIDEO_KEYS | {"roi"} and roi["cycles"] == 2
    assert set(roi["roi"]) == {"window_px", "chunks", "replays", "max_chunk_replays"} and roi["roi"]["window_px"] == 512


def test_video_bench_command_line(rec, tmp_path, capsys):
    """``--generate --cpu`` (JAX's flags) renders on the CPU the recording
    that ``recording.write_frames`` wrote along the same seeded track."""
    out = tmp_path / "frames"
    assert bench_video.main(["--generate", "--cpu", "--frames", "31", "--dir", str(out)]) is None
    assert "generated 31 frames" in capsys.readouterr().out
    names = sorted(os.listdir(rec))
    assert sorted(os.listdir(out)) == names and len(names) == 31
    for name in names:
        assert (out / name).read_bytes() == open(os.path.join(rec, name), "rb").read()


@pytest.mark.skipif(torch.cuda.is_available(), reason="the machine has a card")
def test_bench_without_a_card_exits_nonzero(rec):
    env = {**{k: v for k, v in os.environ.items() if k not in KNOBS}, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-m", "wtracker_tpu_torch.tools.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "unavailable" in line["note"] and "vs_baseline" not in line
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.build_flagship(1, n_cycles=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_video.run(ROOT, "bf16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # the measurement runs on the card only
        bench_video.main(["--dir", rec, "--json"])
