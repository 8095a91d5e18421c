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
digits; ``bboxes.csv`` must equal the JAX text byte for byte.  The same
holds with an int8 artifact of that detector (the folded-stem int8 graph in
both packages; the JAX loop runs op by op, as its jit moves int8 logits by
an ulp), and without
``--predictor``, where both commands draw the default predictor from seed 0.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from tests.test_torch_engine_video import F, INIT, _timing, models, video  # noqa: F401 (fixtures)
from wtracker_tpu.models.resmlp import load_predictor as jax_load_predictor
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_rmlp_predictor
from wtracker_tpu.models.resmlp import save_predictor as jax_save_predictor
from wtracker_tpu.models.yolov8 import YoloV8 as JaxYoloV8
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.models.yolov8_int8 import QuantizedYolo as JaxQuantizedYolo
from wtracker_tpu.models.yolov8_int8 import make_detect_fns as jax_make_detect_fns
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine import EngineParams as JaxEngineParams
from wtracker_tpu.sim.engine import logs_to_frame as jax_logs_to_frame
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.engine_video import run_video_live as jax_run_video_live
from wtracker_tpu.utils.frame_reader import FrameReader as JaxFrameReader
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.models.yolov8_int8 import quantize_detector
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
    # an int8 artifact of the same detector (either package's format loads in
    # both), calibrated on camera windows around the initial position
    cam = timing.camera_size_px[0]
    x0, y0 = INIT[0] - cam // 2, INIT[1] - cam // 2
    calib = video[:: len(video) // 8][:8, y0 : y0 + cam, x0 : x0 + cam]
    fused = YoloV8Detector.load(str(root / "detector.npz"), imgsz=IMGSZ, device="cpu").fuse().model
    quantize_detector(fused, calib, (IMGSZ, IMGSZ)).save(str(root / "int8.npz"))
    return {k: str(root / v) for k, v in (
        ("frames", "frames"), ("timing", "timing.json"), ("exp", "exp.json"),
        ("detector", "detector.npz"), ("predictor", "predictor.npz"), ("int8", "int8.npz"), ("root", ""),
    )}


def _jax_csv(files, roi: int | None, int8: bool = False, predictor: bool = True) -> str:
    """What the JAX package's track_video command writes, computed in-process
    (``workflows/track_video.py``: an int8 artifact goes through
    ``make_detect_fns`` at the camera geometry; without ``--predictor`` the
    default ``make_rmlp_predictor``)."""
    timing = JaxTimingConfig.load_json(files["timing"])
    exp = JaxExperimentConfig.load_json(files["exp"])
    reader = JaxFrameReader.create_from_directory(files["frames"])
    hooks = {}
    if int8:
        q = JaxQuantizedYolo.load(files["int8"])
        det_model = JaxYoloV8(nc=q.nc, scale=q.scale, reg_max=q.reg_max, compute_dtype=jnp.bfloat16, fused=True)
        det_variables = q.device_weights()
        cam_hw = (timing.camera_size_px[1], timing.camera_size_px[0])
        detect_fn, detect_pre = jax_make_detect_fns(q, src_hw=cam_hw, imgsz=(IMGSZ, IMGSZ))
        assert getattr(detect_fn, "folds_preproc", False)
        hooks = {"detect_fn": detect_fn, "detect_preprocessed_fn": detect_pre}
    else:
        det = JaxDetector.load(files["detector"], imgsz=IMGSZ, conf=0.0).fuse()
        det_model, det_variables = det.model, det.variables
    if predictor:
        predictor = jax_load_predictor(files["predictor"])
    else:
        predictor = jax_make_rmlp_predictor(JaxIOConfig([0], [max(timing.pred_frame_num, 1)]))
    params = JaxEngineParams.from_timing(timing, reader.frame_size)
    cfg = JaxLiveLoopConfig(
        imgsz=(IMGSZ, IMGSZ), conf=0.0, ring_size=max(64, 2 * params.cycle_n), log_mode=True,
        max_dist_per_pred=0.9 * (timing.px_per_mm / timing.frames_per_sec) * max(predictor.io_config.pred_frames[0], 1),
    )
    # XLA's jit fuses the int8 epilogue (a fused multiply-add, one rounding
    # fewer), which moves the bf16 class logits by an ulp and flips near-tied
    # top-1 anchors: JAX's own jitted and eager int8 forwards differ.  The
    # int8 reference runs op by op, each op rounding as the port's does.
    with jax.disable_jit(int8):
        logs = _jax_run(params, cfg, reader, det_model, det_variables, predictor, exp, roi, hooks)
    return jax_logs_to_frame(params, logs).to_csv(index=False)


def _jax_run(params, cfg, reader, det_model, det_variables, predictor, exp, roi, hooks):
    # whole frames in one chunk: chunked, the JAX loop decodes into a
    # prefetch buffer that ``jnp.asarray`` aliases on the CPU while the
    # previous chunk may still run (see test_torch_engine_video_streams.py);
    # chunking does not change the logs, and the port's command is chunked
    return jax_run_video_live(
        params, cfg, lambda s, n, out=None: reader.read_batch(range(s, min(s + n, len(reader))), out=out),
        len(reader), det_model, det_variables, predictor, exp.init_position, cycles_per_chunk=CHUNK if roi else F,
        roi_window=roi, **hooks,
        window_source=(lambda s, n, tls, out=None: reader.read_window_batch(range(s, s + n), tls, (roi, roi), out=out))
        if roi else None,
    )


def _argv(files, out: str, *extra: str, detector: str = "detector", predictor: bool = True) -> list[str]:
    return [
        "--frames", files["frames"], "--timing-config", files["timing"], "--exp-config", files["exp"],
        "--detector", files[detector], *(["--predictor", files["predictor"]] if predictor else []),
        "--output", out, "--imgsz", str(IMGSZ), "--conf", "0", "--chunk-cycles", str(CHUNK), "--device", "cpu",
        *extra,
    ]


@pytest.mark.parametrize(
    "roi, int8, predictor",
    [(None, False, True), (ROI, False, True), (None, True, True), (None, False, False)],
    ids=["whole-frames", "roi", "int8", "default-predictor"],
)
def test_track_video_writes_the_jax_csv(files, roi, int8, predictor, capsys):
    out = os.path.join(files["root"], f"out-{roi}-{int8}-{predictor}")
    track_video.main(
        _argv(files, out, *(["--roi", str(roi)] if roi else []), detector="int8" if int8 else "detector",
              predictor=predictor)
    )
    printed = capsys.readouterr().out
    with open(os.path.join(out, "bboxes.csv")) as f:
        got = f.read()
    df = pd.read_csv(os.path.join(out, "bboxes.csv"))
    assert len(df.columns) == 17 and len(df) == (F - 1) // 8 * 8
    assert (df[["wrm_w", "wrm_h"]] > 0).all().all()  # conf 0: a box in every frame
    assert f"wrote {out}/bboxes.csv ({len(df)} rows)" in printed
    assert ("ROI streaming: 4 chunks" in printed) == bool(roi)
    assert got == _jax_csv(files, roi, int8, predictor)


def test_track_video_refuses_unported_checkpoints(files, tmp_path):
    """What still refuses: a predictor ``.pt`` (the JAX package unpickles
    whole upstream modules, ROADMAP Queue 3), and a detector ``.pt`` that is
    not a plain state dict (here empty; a whole-module pickle alike)."""
    pt = tmp_path / "predictor.pt"
    pt.write_bytes(b"")
    argv = _argv(files, str(tmp_path / "out"))
    for flag, error, where in (("--predictor", NotImplementedError, "Queue 3"), ("--detector", ValueError, "not a plain state dict")):
        bad = list(argv)
        bad[bad.index(flag) + 1] = str(pt)
        with pytest.raises(error, match=where):
            track_video.main(bad)
    assert not (tmp_path / "out").exists()


def test_track_video_reads_a_pt_detector(files, tmp_path):
    """The detector as the JAX package exports it (``save_torch_state_dict``,
    the ultralytics layout) writes the JAX command's text."""
    from wtracker_tpu.models.yolo_port import save_torch_state_dict as jax_save_torch_state_dict

    pt = str(tmp_path / "detector.pt")
    jax_save_torch_state_dict(JaxDetector.load(files["detector"], imgsz=IMGSZ), pt)
    argv = _argv(files, str(tmp_path / "out"))
    argv[argv.index("--detector") + 1] = pt
    track_video.main(argv)
    assert (tmp_path / "out" / "bboxes.csv").read_text() == _jax_csv(files, None)
