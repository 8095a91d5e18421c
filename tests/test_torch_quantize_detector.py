"""The port's ``quantize_detector`` command against the JAX package's.

Reference: what ``workflows/quantize_detector.py`` computes, run in-process
(the JAX command cannot import its package as a script): the calibration
views (spread over the recording, at the initial camera window or along a
previous run's ``cam_x``/``cam_y``), ``YoloV8Detector.load(...).fuse()`` and
``quantize_detector``.  The recording is ``tests/test_torch_engine_video.py``'s
as 8-bit BMPs and the detector a YOLOv8 "n" at 64 px saved by the JAX
package.  Held: the letterboxed calibration input's abs-max exactly (the
same views); every other abs-max within 2 % relative (calibration is a bf16
forward); the command's float32 fused weights, quantized at JAX's abs-max,
give JAX's artifact exactly; the artifact loads in JAX.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import cv2
import jax.numpy as jnp

from tests.test_torch_engine_video import F, INIT, _timing, models, video  # noqa: F401 (fixtures)
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.models.yolov8_int8 import QuantizedYolo as JaxQuantizedYolo
from wtracker_tpu.models.yolov8_int8 import quantize_detector as jax_quantize_detector
from wtracker_tpu.ops.image import crop_views as jax_crop_views
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine import EngineParams as JaxEngineParams
from wtracker_tpu.utils.frame_reader import FrameReader as JaxFrameReader
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.models.yolov8_int8 import QuantizedYolo, _BuildOps, _forward, _ScaleVec
from wtracker_tpu_torch.workflows import quantize_detector

torch.set_num_threads(2)

IMGSZ, CALIB = 64, 12
ABSMAX_REL = 0.02


@pytest.fixture(scope="module")
def files(video, models, tmp_path_factory):
    (jmodel, jvars, _), _ = models
    root = tmp_path_factory.mktemp("quantize")
    (root / "frames").mkdir()
    for i, f in enumerate(video):
        assert cv2.imwrite(str(root / "frames" / f"frame_{i:05d}.bmp"), f)
    timing = _timing(JaxExperimentConfig, JaxTimingConfig)
    timing.save_json(str(root / "timing.json"))
    JaxExperimentConfig("vid", F, 60, video.shape[1:], 90, INIT).save_json(str(root / "exp.json"))
    JaxDetector(jmodel, jvars, (IMGSZ, IMGSZ)).save(str(root / "detector.npz"))
    # a previous run's log: every 5th frame, the camera drifting right and down
    frames = np.arange(0, F - 20, 5)
    pd.DataFrame({"frame": frames, "cam_x": 100 + frames, "cam_y": 80 + frames // 2}).to_csv(
        root / "bboxes.csv", index=False
    )
    return {k: str(root / v) for k, v in (
        ("frames", "frames"), ("timing", "timing.json"), ("exp", "exp.json"), ("detector", "detector.npz"),
        ("bboxes", "bboxes.csv"), ("root", ""),
    )}


def _jax_artifact(files, bboxes: bool):
    """What the JAX package's quantize_detector command writes."""
    timing = JaxTimingConfig.load_json(files["timing"])
    exp = JaxExperimentConfig.load_json(files["exp"])
    reader = JaxFrameReader.create_from_directory(files["frames"])
    params = JaxEngineParams.from_timing(timing, reader.frame_size)
    H, W = reader.frame_size
    n = min(CALIB, len(reader))
    idxs = np.unique(np.linspace(0, len(reader) - 1, n).astype(int))
    if bboxes:
        rows = pd.read_csv(files["bboxes"]).set_index("frame").reindex(idxs).ffill().bfill()
        tls = rows[["cam_x", "cam_y"]].to_numpy(np.float32)
    else:
        tl = np.array([exp.init_position[0] - params.cam_w // 2, exp.init_position[1] - params.cam_h // 2])
        tls = np.tile(tl.astype(np.float32), (len(idxs), 1))
    tls[:, 0] = np.clip(tls[:, 0], 0, W - params.cam_w)
    tls[:, 1] = np.clip(tls[:, 1], 0, H - params.cam_h)
    tls = np.round(tls).astype(np.int32)
    views = np.asarray(jax_crop_views(jnp.asarray(reader.read_batch(idxs)), jnp.asarray(tls), (params.cam_h, params.cam_w)))
    det = JaxDetector.load(files["detector"], imgsz=IMGSZ).fuse()
    return jax_quantize_detector(det.model, det.variables, views, (IMGSZ, IMGSZ))


@pytest.mark.parametrize("bboxes", [False, True], ids=["initial-window", "bboxes-csv"])
def test_quantize_detector_writes_the_jax_artifact(files, bboxes, capsys):
    out = os.path.join(files["root"], f"int8-{bboxes}.npz")
    argv = [
        "--detector", files["detector"], "--frames", files["frames"], "--timing-config", files["timing"],
        "--exp-config", files["exp"], "--calib-frames", str(CALIB), "--imgsz", str(IMGSZ), "--output", out,
        "--device", "cpu", *(["--bboxes-csv", files["bboxes"]] if bboxes else []),
    ]
    quantize_detector.main(argv)
    assert f"wrote {out}: int8 n-scale detector, 63 quantized convs, calibrated on {CALIB} views" in capsys.readouterr().out
    got = QuantizedYolo.load(out)
    want = _jax_artifact(files, bboxes)
    assert (got.nc, got.scale, got.reg_max) == (want.nc, want.scale, want.reg_max)
    assert set(got.absmax) == set(want.absmax)
    assert got.absmax["__input__"] == want.absmax["__input__"]
    for name, value in want.absmax.items():
        assert abs(got.absmax[name] - value) <= ABSMAX_REL * value, name

    # the command's fused float32 weights, quantized at JAX's abs-max
    model = YoloV8Detector.load(files["detector"], imgsz=IMGSZ, device="cpu").fuse().model
    build = _BuildOps(model, want.absmax)
    _forward(build, _ScaleVec(np.zeros(3)), model.nc, model.scale)
    for name, node in want.qweights.items():
        for k in ("w", "sw", "b"):
            np.testing.assert_array_equal(build.qweights[name][k], node[k], err_msg=f"{name}|{k}")

    back = JaxQuantizedYolo.load(out)  # the JAX package reads the port's artifact
    assert back.absmax == got.absmax and set(back.qweights) == set(want.qweights)
    np.testing.assert_array_equal(back.qweights["b0"]["w"], got.qweights["b0"]["w"])


def _quantize_argv(files, detector: str, out: str) -> list[str]:
    return [
        "--detector", detector, "--frames", files["frames"], "--timing-config", files["timing"],
        "--exp-config", files["exp"], "--output", out, "--calib-frames", str(CALIB), "--imgsz", str(IMGSZ),
        "--device", "cpu",
    ]


def test_quantize_detector_refuses_a_pt_checkpoint(files, tmp_path):
    """A ``.pt`` that is not a plain state dict refuses (here empty; a
    whole-module pickle alike), naming the file, and writes nothing."""
    pt = tmp_path / "det.pt"
    pt.write_bytes(b"")
    with pytest.raises(ValueError, match=r"det\.pt: not a plain state dict"):
        quantize_detector.main(_quantize_argv(files, str(pt), str(tmp_path / "q.npz")))
    assert not (tmp_path / "q.npz").exists()


def test_quantize_detector_reads_a_pt_detector(files, tmp_path):
    """The detector as the JAX package exports it (``save_torch_state_dict``)
    gives the artifact of its ``.npz``, exactly."""
    from wtracker_tpu.models.yolo_port import save_torch_state_dict as jax_save_torch_state_dict

    pt = str(tmp_path / "det.pt")
    jax_save_torch_state_dict(JaxDetector.load(files["detector"], imgsz=IMGSZ), pt)
    quantize_detector.main(_quantize_argv(files, pt, str(tmp_path / "from_pt.npz")))
    quantize_detector.main(_quantize_argv(files, files["detector"], str(tmp_path / "from_npz.npz")))
    a, b = QuantizedYolo.load(str(tmp_path / "from_pt.npz")), QuantizedYolo.load(str(tmp_path / "from_npz.npz"))
    assert a.absmax == b.absmax and set(a.qweights) == set(b.qweights)
    for name, node in b.qweights.items():
        for k, v in node.items():
            np.testing.assert_array_equal(a.qweights[name][k], v, err_msg=f"{name}|{k}")
