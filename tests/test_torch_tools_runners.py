"""The port's tool runners on the CPU, at small sizes: ``run_gates`` (its
record and exit code), ``trace_profile`` and ``trace_diff`` (against the
JAX tools' own checks in ``tests/test_trace_profile.py``: a clear error
without a trace, instance names grouped, distinct names kept apart), the
recording and ``workflow_chain`` (a record with every field of the JAX
package's ``WORKFLOW_CHAIN.json``)."""

import json
import os

import numpy as np
import pytest
import torch

from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.tools import gates, recording, run_gates, trace_diff, trace_profile, workflow_chain

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO_GATES = ["--device", "cpu", "--skip-trained", "--scale", "n", "--imgsz", "64", "--cam", "64", "--calib", "4",
              "--heldout", "4", "--parity-views", "2"]


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    path = tmp_path_factory.mktemp("nano") / "nano.npz"
    YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=3, device="cpu").save(str(path))
    return str(path)


def test_run_gates_writes_the_record_and_its_exit_code(tmp_path, monkeypatch):
    out = tmp_path / "gates.json"
    code = run_gates.main([*NANO_GATES, "--output", str(out)])
    record = json.loads(out.read_text())
    assert set(record) >= {"ran_at", "commit", "host", "device", "card", "trained_checkpoint", "gates", "all_pass"}
    assert record["device"] == "cpu" and record["card"] is None and record["trained_checkpoint"] is None
    assert set(record["gates"]) == {"s416_parity", "int8_drift_s416"}
    for gate in record["gates"].values():
        assert gate["status"] in ("pass", "fail") and gate["seconds"] >= 0
        assert gate["launches"] == {"crop_letterbox": 0, "conv_s8": 0}  # the CPU runs the plain versions
        assert set(gate["thresholds"]) <= set(gate)
    assert record["gates"]["s416_parity"]["status"] == "pass"  # the CPU against itself
    assert code == (0 if record["all_pass"] else 1)

    monkeypatch.setitem(gates.THRESHOLDS, "s416_parity", {"min_candidate_iou": (">=", 1.5)})
    assert run_gates.main([*NANO_GATES, "--output", str(out)]) == 1
    record = json.loads(out.read_text())
    assert record["gates"]["s416_parity"]["status"] == "fail" and not record["all_pass"]
    assert record["gates"]["s416_parity"]["failed"] == ["min_candidate_iou"]


def test_trace_profile_lists_operators_on_the_cpu(tmp_path, nano, capsys):
    out = trace_profile.main(["bf16", "--streams", "2", "--cycles", "1", "--detector", nano, "--imgsz", "64",
                              "--device", "cpu", "--trace-dir", str(tmp_path)])
    assert out["device_events"] == 0 and out["device_busy_s"] == 0.0 and out["top_kernels"] == []
    names = [r["name"] for r in out["top_ops"]]
    assert names and any(n.startswith("aten::") for n in names) and all(r["cpu_ms"] > 0 for r in out["top_ops"])
    # the program's spans: one run of one cycle (two step calls: the fused loop logs a cycle late)
    calls = {r["name"]: r["calls"] for r in out["layers"]}
    assert calls["wt.run"] == 1 and calls["wt.cycle"] == 2 and calls["wt.detect"] == calls["wt.detector"] >= 2
    assert {"wt.render", "wt.preprocess", "wt.decode", "wt.predict", "wt.motor"} <= set(calls)
    assert all(r["device_ms"] == r["self_device_ms"] == 0.0 < r["host_ms"] for r in out["layers"])
    assert os.path.isfile(out["trace"])
    trace = trace_profile.load_trace(str(tmp_path))  # the newest trace of the directory
    assert trace["kernels"] == {} and trace["device_ms"] == 0.0 and trace["ops"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["streams"] == 2


def test_busy_union_leaves_out_annotation_ranges():
    """A span's device-side range covers the gaps between its kernels: the
    busy time is the kernels', copies' and fills' union alone."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, s, e, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=s, end=e),
                               is_user_annotation=annotation)

    kernels = [ev("k1", 0.0, 10.0), ev("k2", 5.0, 15.0), ev("Memcpy DtoH", 40.0, 50.0)]
    others = [ev("wt.detector", 0.0, 50.0, annotation=True), ev("Command Buffer Full", 20.0, 30.0),
              ev("wt.detector", 0.0, 60.0, device=DeviceType.CPU)]
    assert trace_profile.device_intervals(kernels + others) == sorted((e.time_range.start, e.time_range.end)
                                                                      for e in kernels)
    assert trace_profile.union_us(trace_profile.device_intervals(kernels + others)) == 25.0


def test_load_trace_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no torch.profiler trace"):
        trace_profile.load_trace(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no torch.profiler trace"):
        trace_profile.load_trace(str(tmp_path / "missing.json"))


def test_trace_diff_normalize_groups_instances():
    n = trace_diff._normalize
    assert n("void at::native::elementwise_kernel<128, 4, at::native::Fill<float> >(int, Fill<float>)") == (
        n("void at::native::elementwise_kernel<64, 2, at::native::Fill<c10::BFloat16> >(int, Fill<c10::BFloat16>)")
    ) == "at::native::elementwise_kernel"
    assert n("fusion.123") == "fusion"
    assert n("void (anonymous namespace)::conv_kernel<32, true>(Args)") == "(anonymous namespace)::conv_kernel"
    assert n("sm90_xmma_fprop_implicit_gemm_bf16bf16_f32_nhwc_tile128x128") != n("sm90_xmma_wgrad_implicit_gemm_tile64")
    assert n("aten::conv2d") == "aten::conv2d" and n("copy.1") != n("fusion.1")


def test_trace_diff_names_the_operator_one_trace_adds(tmp_path, capsys):
    x = torch.randn(64, 64)

    def traced(directory, extra: bool):
        def run():
            y = x @ x
            if extra:
                y = torch.tanh(y)
            return float(y.sum())

        return trace_profile.profile_run(run, trace_dir=str(tmp_path / directory))["trace"]

    a, b = traced("a", False), traced("b", True)
    rows = trace_diff.diff(a, b)
    tanh = [r for r in rows if r[0] == "aten::tanh"]
    assert tanh and tanh[0][1] == 0.0 and tanh[0][2] > 0.0
    trace_diff.main([str(tmp_path / "a"), str(tmp_path / "b")])
    assert "aten::tanh" in capsys.readouterr().out


def test_workflow_chain_writes_every_field(tmp_path, nano, monkeypatch):
    # the card's host has no plotting packages: hide them from the commands too
    shim = tmp_path / "no_plots"
    shim.mkdir()
    for name in ("matplotlib", "seaborn"):
        (shim / f"{name}.py").write_text(f"raise ImportError('{name} is hidden', name='{name}')\n")
    monkeypatch.setenv("PYTHONPATH", str(shim))
    frames = tmp_path / "rec"
    # 4 logged cycles of 15 frames: analysis trims the first and the last
    made = recording.generate(str(frames), 61, seed=1, arena=(200, 240), device="cpu")
    assert made["frames"] == 61 and len(os.listdir(frames)) == 61 and os.path.isfile(f"{frames}.trajectory.npy")
    first = recording.render_frames(np.load(f"{frames}.trajectory.npy"), 0, 1, (200, 240), "cpu")[0]
    assert first.shape == (200, 240) and first.dtype == np.uint8

    out = tmp_path / "chain.json"
    workflow_chain.main(["--dir", str(frames), "--work", str(tmp_path / "work"), "--detector", nano, "--imgsz", "64",
                         "--roi", "0", "--viz-frames", "4", "--px-per-mm", "20", "--bg-probes", "30",
                         "--device", "cpu", "--output", str(out)])
    record = json.loads(out.read_text())
    with open(os.path.join(ROOT, "WORKFLOW_CHAIN.json")) as f:
        jax_record = json.load(f)
    assert set(jax_record) <= set(record)
    assert set(jax_record["recording"]) <= set(record["recording"]) and record["recording"]["frames"] == 61
    assert set(record["stages"]) == set(jax_record["stages"])
    for name, stage in record["stages"].items():
        assert set(jax_record["stages"][name]) <= set(stage) and stage["ok"] and stage["seconds"] > 0
    assert record["total_seconds"] == pytest.approx(sum(s["seconds"] for s in record["stages"].values()), abs=0.2)
    assert "EXTRAPOLATED" in record["extrapolation"] and record["predictor"].startswith("seeded ResMLP")
    assert len(os.listdir(tmp_path / "work" / "visualize")) == 4
