"""The port's ``initialize_experiment``, ``create_yolo_images``, ``analysis``
and ``visualize`` commands against the JAX package's.

The port's commands run as subprocesses (``python -m ...``, ``PYTHONPATH``
the repository root, ``--device cpu``); the JAX side is the same command's
``main()`` run in-process with a patched ``sys.argv`` (the JAX scripts
cannot import their package when run as files).  Inputs: 8 seeded gray BMP
frames of 120x160 with a bright worm, a nano YOLOv8 from the JAX package's
``init_random`` (its class bias raised so that every frame has a box), and
a log of the JAX host simulator.  Outputs must be equal: CSV and JSON text,
``background.npy``, decoded PNG pixels.  The YOLO route's boxes agree
within 1e-3 px (float32 convolutions sum in another order); where they do
not, the frame's top class logits must be tied in JAX (within 1e-5) and
the port's box must be one of the tied anchors' boxes, as in
``tests/test_torch_yolo_controller_host.py``.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.models.yolov8 import letterbox_params
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu_torch.utils.image_codec import imread, imwrite

ROOT = Path(__file__).resolve().parent.parent
N, H, W = 8, 120, 160
IMGSZ = 64
BOX_ATOL = 1e-3
TIE_GAP = 1e-5


def _jax_main(name: str, argv: list[str], monkeypatch) -> None:
    spec = importlib.util.spec_from_file_location(f"jax_workflow_{name}", ROOT / "workflows" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    monkeypatch.undo()


def _port(cmds: dict) -> dict:
    """Start every port command at once, then wait for each."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {
        k: subprocess.Popen([sys.executable, "-m", f"wtracker_tpu_torch.workflows.{c[0]}", *c[1:], "--device", "cpu"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, c in cmds.items()
    }
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{k} exited {p.returncode}:\n{stderr[-3000:]}"
        out[k] = stdout
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset_cli")
    rng = np.random.default_rng(0)
    bg = rng.integers(20, 40, (H, W), dtype=np.uint8)
    (root / "frames").mkdir()
    for i in range(N):
        f = bg.copy()
        y, x = 20 + 9 * i, 15 + 14 * i
        f[y : y + 8, x : x + 13] = 200
        assert cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.bmp"), f)

    det = JaxDetector.init_random(nc=1, scale="n", imgsz=(IMGSZ, IMGSZ), seed=0)
    det.save(str(root / "det.npz"))
    weights = dict(np.load(root / "det.npz", allow_pickle=True))
    cls_bias = [k for k in weights if "cv3" in k and k.endswith("bias") and weights[k].shape == (1,)]
    assert len(cls_bias) == 3
    for k in cls_bias:
        weights[k] = weights[k] + 4.6  # scores near 0.5: every frame has a box above conf 0.1
    np.savez(root / "det.npz", **weights)

    # a simulator log over a 500x600 arena, ragged worm crops and a background
    make_worm_csv(str(root / "worm.csv"))
    from wtracker_tpu.sim.controllers import CsvController, LogConfig, LoggingController
    from wtracker_tpu.sim.simulator import Simulator
    from wtracker_tpu.utils import bbox as jbb

    exp = JaxExperimentConfig(**EXP_KWARGS)
    timing = JaxTimingConfig(experiment_config=exp, **TIMING_KWARGS)
    timing.save_json(str(root / "timing.json"))
    Simulator(timing, exp, LoggingController(CsvController(timing, str(root / "worm.csv")),
                                             LogConfig(root_folder=str(root / "run"), save_err_view=False))).run(progress=False)
    log = pd.read_csv(root / "run" / "bboxes.csv")
    arena_bg = rng.integers(0, 256, EXP_KWARGS["orig_resolution"], dtype=np.uint8)
    np.save(root / "arena_bg.npy", arena_bg)
    boxes, _ = jbb.discretize(log[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(), arena_bg.shape, jbb.BoxFormat.XYWH)
    (root / "crops").mkdir()
    for i, (x, y, w, h) in enumerate(boxes):
        crop = rng.integers(0, 256, (max(h, 1), max(w, 1)), dtype=np.uint8)
        assert imwrite(str(root / "crops" / f"crop_{i:06d}.bmp"), crop)
    (root / "vis_frames").mkdir()
    for i in range(6):
        assert cv2.imwrite(str(root / "vis_frames" / f"f_{i}.bmp"), rng.integers(0, 256, (400, 600), dtype=np.uint8))
    return root


def test_initialize_experiment_classical_and_yolo(files, monkeypatch):
    base = ["--frames", str(files / "frames"), "--bg-probes", "6", "--batch", "3", "--fps", "30", "--px-per-mm", "80"]
    yolo = ["--detector", "yolo", "--yolo-weights", str(files / "det.npz"), "--imgsz", str(IMGSZ)]
    runs = {"classical": base, "yolo": base + yolo}
    _port({k: ["initialize_experiment", *v, "--output", str(files / "torch" / k)] for k, v in runs.items()})
    for k, v in runs.items():
        _jax_main("initialize_experiment", [*v, "--output", str(files / "jax" / k)], monkeypatch)

    for k in runs:
        got, want = files / "torch" / k, files / "jax" / k
        np.testing.assert_array_equal(np.load(got / "background.npy"), np.load(want / "background.npy"))
        assert np.load(got / "background.npy").dtype == np.uint8
    got, want = files / "torch" / "classical", files / "jax" / "classical"
    assert (got / "init_bboxes.csv").read_text() == (want / "init_bboxes.csv").read_text()
    assert (got / "exp_config.json").read_text() == (want / "exp_config.json").read_text()
    boxes = pd.read_csv(got / "init_bboxes.csv").to_numpy()
    assert np.isfinite(boxes).all() and (boxes[:, 2] >= 13).all()

    # the YOLO route: equal boxes but at tied top anchors
    got = pd.read_csv(files / "torch" / "yolo" / "init_bboxes.csv").to_numpy()
    want = pd.read_csv(files / "jax" / "yolo" / "init_bboxes.csv").to_numpy()
    assert got.shape == want.shape == (N, 4) and np.isfinite(want).all()
    off = np.flatnonzero(~np.isclose(got, want, atol=BOX_ATOL, rtol=0).all(axis=1))
    if off.size:
        det = JaxDetector.load(str(files / "det.npz"), imgsz=IMGSZ)
        frames = np.stack([cv2.imread(str(files / "frames" / f"frame_{i:04d}.bmp"), 0) for i in off])
        boxes_lb, scores = (np.asarray(a) for a in det.raw(frames))
        scale, _, _, pad_top, pad_left = letterbox_params((H, W), (IMGSZ, IMGSZ))
        for j, i in enumerate(off):
            s = scores[j, :, 0]
            tied = np.flatnonzero(s >= s.max() - TIE_GAP)
            assert tied.size >= 2, f"frame {i}: boxes differ without a tie"
            x, y, w, h = got[i]
            lb = np.array([x, y, x + w, y + h]) * scale + np.array([pad_left, pad_top, pad_left, pad_top])
            assert np.isclose(boxes_lb[j, tied], lb, atol=BOX_ATOL * 10).all(axis=1).any(), f"frame {i}"
    exp_got = (files / "torch" / "yolo" / "exp_config.json").read_text()
    if not off.size or 0 not in off:  # the init position comes from the first frame's box
        assert exp_got == (files / "jax" / "yolo" / "exp_config.json").read_text()


def test_create_yolo_images(files, monkeypatch):
    args = ["--frames", str(files / "frames"), "--count", "5", "--size", "48", "40", "--bg-probes", "8", "--seed", "3"]
    _port({"samples": ["create_yolo_images", *args, "--output", str(files / "torch" / "samples")]})
    _jax_main("create_yolo_images", [*args, "--output", str(files / "jax" / "samples")], monkeypatch)
    names = sorted(os.listdir(files / "jax" / "samples"))
    assert names == sorted(os.listdir(files / "torch" / "samples")) and len(names) == 5
    for name in names:
        want = cv2.imread(str(files / "jax" / "samples" / name), cv2.IMREAD_UNCHANGED)
        assert want.shape == (40, 48)
        np.testing.assert_array_equal(imread(str(files / "torch" / "samples" / name), -1), want)


def test_analysis_and_visualize(files, monkeypatch):
    analysis = ["--timing-config", str(files / "timing.json"), "--log", str(files / "run" / "bboxes.csv")]
    precise = ["--worm-crops", str(files / "crops"), "--background", str(files / "arena_bg.npy")]
    vis = ["--timing-config", str(files / "timing.json"), "--log", str(files / "run" / "bboxes.csv"), "--start", "3",
           "--stop", "9"]
    runs = {
        "analysis": ["analysis", *analysis, "--remove-anomalies"],
        "analysis_precise": ["analysis", *analysis, *precise, "--unit", "frame"],
        "visualize_white": ["visualize", *vis],
        "visualize_frames": ["visualize", *vis[:-2], "--stop", "5", "--frames", str(files / "vis_frames"),
                             "--cam-type", "plt"],
    }
    out = _port({k: [*v, ("--save-frames" if v[0] == "visualize" else "--output"), str(files / "torch" / k)]
                 for k, v in runs.items()})
    for k, v in runs.items():
        _jax_main(v[0], [*v[1:], "--save-frames" if v[0] == "visualize" else "--output", str(files / "jax" / k)],
                  monkeypatch)

    for k in ("analysis", "analysis_precise"):
        got = (files / "torch" / k / "analyzed.csv").read_text()
        assert got == (files / "jax" / k / "analyzed.csv").read_text()
        assert "plots skipped" not in out[k]
        assert (files / "torch" / k / "speed_distribution.png").is_file()
    errs = pd.read_csv(files / "torch" / "analysis_precise" / "analyzed.csv")["precise_error"]
    assert errs.notna().any() and (errs > 0).any()
    for k in ("visualize_white", "visualize_frames"):
        names = sorted(os.listdir(files / "jax" / k))
        assert names == sorted(os.listdir(files / "torch" / k)) and len(names) in (6, 2)
        for name in names:
            np.testing.assert_array_equal(imread(str(files / "torch" / k / name), -1),
                                          cv2.imread(str(files / "jax" / k / name), cv2.IMREAD_UNCHANGED))


def test_analysis_without_plotting_packages(files):
    """Without matplotlib and seaborn the command says so on one line and
    still writes the same analyzed.csv."""
    out = files / "torch" / "analysis_noplots"
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = sys.modules['seaborn'] = None\n"
        "from wtracker_tpu_torch.workflows import analysis\n"
        f"analysis.main(['--timing-config', {str(files / 'timing.json')!r}, '--log', "
        f"{str(files / 'run' / 'bboxes.csv')!r}, '--output', {str(out)!r}, '--device', 'cpu'])\n"
    )
    ref = files / "torch" / "analysis_ref"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in (
            [sys.executable, "-c", code],
            [sys.executable, "-m", "wtracker_tpu_torch.workflows.analysis", "--timing-config", str(files / "timing.json"),
             "--log", str(files / "run" / "bboxes.csv"), "--output", str(ref), "--device", "cpu"],
        )
    ]
    (stdout, stderr), (_, ref_err) = (p.communicate(timeout=300) for p in procs)
    assert procs[0].returncode == 0, stderr[-3000:]
    assert procs[1].returncode == 0, ref_err[-3000:]
    skipped = [line for line in stdout.splitlines() if line.startswith("plots skipped")]
    assert len(skipped) == 1 and "not installed" in skipped[0]
    assert not list(out.glob("*.png")) and list(ref.glob("*.png"))
    assert (out / "analyzed.csv").read_text() == (ref / "analyzed.csv").read_text()


def test_commands_refuse_a_missing_card(files):
    """--device defaults to cuda; without a card every command raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "wtracker_tpu_torch.workflows.create_yolo_images", "--frames",
                           str(files / "frames"), "--output", str(files / "torch" / "nocard")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not (files / "torch" / "nocard").exists()
