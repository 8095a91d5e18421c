"""The port's ``track_video`` command against the JAX package's loop.

Reference: what ``workflows/track_video.py`` computes, run in-process (the
JAX command cannot import its package as a script): ``FrameReader`` over a
directory of BMPs, ``YoloV8Detector.load(...).fuse()``, ``load_predictor``,
its ``LiveLoopConfig``, ``run_video_live`` (whole frames, and ROI streaming)
and ``logs_to_frame``.  The frames are the recording of
``tests/test_torch_engine_video.py`` as 8-bit BMPs; the detector is a
YOLOv8 "n" at 64 px saved by the JAX package's ``YoloV8Detector.save``,
whose box branch gives every anchor the same exact distances, so each box is
an exact function of the winning anchor and both packages print the same
digits; ``bboxes.csv`` must equal the JAX text byte for byte.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import cv2

from tests.test_torch_engine_video import F, INIT, _timing, models, video  # noqa: F401 (fixtures)
from wtracker_tpu.models.resmlp import load_predictor as jax_load_predictor
from wtracker_tpu.models.resmlp import save_predictor as jax_save_predictor
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine import EngineParams as JaxEngineParams
from wtracker_tpu.sim.engine import logs_to_frame as jax_logs_to_frame
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.engine_video import run_video_live as jax_run_video_live
from wtracker_tpu.utils.frame_reader import FrameReader as JaxFrameReader
from wtracker_tpu_torch.workflows import track_video

torch.set_num_threads(2)

IMGSZ, ROI, CHUNK = 64, 168, 16


def _exact_box_head(variables: dict) -> dict:
    """A box branch that ignores the image: zero kernels and a bias of 200 on
    one DFL bin per side (the other bins' exp(-200) is 0 in float32), so the
    distances are the exact integers 2, 3, 4, 5."""
    head = dict(variables["params"]["head"])
    for name in [k for k in head if k.startswith("cv2_") and k.endswith("_2")]:
        bias = np.zeros((4, 16), np.float32)
        bias[np.arange(4), [2, 3, 4, 5]] = 200.0
        head[name] = {"kernel": np.zeros_like(head[name]["kernel"]), "bias": bias.reshape(-1)}
    return {**variables, "params": {**variables["params"], "head": head}}


@pytest.fixture(scope="module")
def files(video, models, tmp_path_factory):
    """BMP frames, configs, detector and predictor files, as a user has them."""
    (jmodel, jvars, jpred), _ = models
    root = tmp_path_factory.mktemp("track")
    frames = root / "frames"
    frames.mkdir()
    for i, f in enumerate(video):
        assert cv2.imwrite(str(frames / f"frame_{i:05d}.bmp"), f)
    timing = _timing(JaxExperimentConfig, JaxTimingConfig)
    timing.save_json(str(root / "timing.json"))
    JaxExperimentConfig("vid", F, 60, video.shape[1:], 90, INIT).save_json(str(root / "exp.json"))
    JaxDetector(jmodel, _exact_box_head(jvars), (IMGSZ, IMGSZ)).save(str(root / "detector.npz"))
    jax_save_predictor(jpred, str(root / "predictor.npz"))
    return {k: str(root / v) for k, v in (
        ("frames", "frames"), ("timing", "timing.json"), ("exp", "exp.json"),
        ("detector", "detector.npz"), ("predictor", "predictor.npz"), ("root", ""),
    )}


def _jax_csv(files, roi: int | None) -> str:
    """What the JAX package's track_video command writes, computed in-process."""
    timing = JaxTimingConfig.load_json(files["timing"])
    exp = JaxExperimentConfig.load_json(files["exp"])
    reader = JaxFrameReader.create_from_directory(files["frames"])
    det = JaxDetector.load(files["detector"], imgsz=IMGSZ, conf=0.0).fuse()
    predictor = jax_load_predictor(files["predictor"])
    params = JaxEngineParams.from_timing(timing, reader.frame_size)
    cfg = JaxLiveLoopConfig(
        imgsz=(IMGSZ, IMGSZ), conf=0.0, ring_size=max(64, 2 * params.cycle_n), log_mode=True,
        max_dist_per_pred=0.9 * (timing.px_per_mm / timing.frames_per_sec) * max(predictor.io_config.pred_frames[0], 1),
    )
    logs = jax_run_video_live(
        params, cfg, lambda s, n, out=None: reader.read_batch(range(s, min(s + n, len(reader))), out=out),
        len(reader), det.model, det.variables, predictor, exp.init_position, cycles_per_chunk=CHUNK,
        roi_window=roi,
        window_source=(lambda s, n, tls, out=None: reader.read_window_batch(range(s, s + n), tls, (roi, roi), out=out))
        if roi else None,
    )
    return jax_logs_to_frame(params, logs).to_csv(index=False)


def _argv(files, out: str, *extra: str) -> list[str]:
    return [
        "--frames", files["frames"], "--timing-config", files["timing"], "--exp-config", files["exp"],
        "--detector", files["detector"], "--predictor", files["predictor"], "--output", out,
        "--imgsz", str(IMGSZ), "--conf", "0", "--chunk-cycles", str(CHUNK), "--device", "cpu", *extra,
    ]


@pytest.mark.parametrize("roi", [None, ROI], ids=["whole-frames", "roi"])
def test_track_video_writes_the_jax_csv(files, roi, capsys):
    out = os.path.join(files["root"], f"out-{roi}")
    track_video.main(_argv(files, out, *(["--roi", str(roi)] if roi else [])))
    printed = capsys.readouterr().out
    with open(os.path.join(out, "bboxes.csv")) as f:
        got = f.read()
    df = pd.read_csv(os.path.join(out, "bboxes.csv"))
    assert len(df.columns) == 17 and len(df) == (F - 1) // 8 * 8
    assert (df[["wrm_w", "wrm_h"]] > 0).all().all()  # conf 0: a box in every frame
    assert f"wrote {out}/bboxes.csv ({len(df)} rows)" in printed
    assert ("ROI streaming: 4 chunks" in printed) == bool(roi)
    assert got == _jax_csv(files, roi)


def test_track_video_refuses_unported_checkpoints(files, tmp_path):
    int8 = tmp_path / "int8.npz"
    np.savez(int8, **{"__meta__": np.frombuffer(b"{}", np.uint8), "b0|kernel": np.zeros(3, np.int8)})
    pt = tmp_path / "predictor.pt"
    pt.write_bytes(b"")
    argv = _argv(files, str(tmp_path / "out"))
    for flag, path in (("--detector", int8), ("--detector", pt), ("--predictor", pt)):
        bad = list(argv)
        bad[bad.index(flag) + 1] = str(path)
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            track_video.main(bad)
    assert not (tmp_path / "out").exists()
