"""The host YoloController against the JAX package's: live detection in the
hook-based simulator.

Reference: ``tests/test_yolo_controller_host.py`` and
``wtracker_tpu/sim/controllers/yolo.py``.  The same synthetic blob
recording (an ``ArrayReader``) and the same detector, a JAX-saved
``init_random(scale="n", imgsz=64)`` ``.npz``, run through
``Simulator(LoggingController(YoloController))`` in both packages: the
platform moves are identical and the logged boxes agree within 1e-3 px
(float32 convolutions sum in another order, so boxes differ in their last
bits).  The random detector at ``conf=0`` has near-tied top class logits
on some views: there the two packages keep different anchors (7 of 112
frames here, JAX's top-2 logits 0 to 6 ulps apart), so a box off the bar
must come from a frame whose top-2 logits in JAX are within 1e-5, and must
be, within 1e-3 px, the box of one of the anchors tied at the top there.  The
logs are also checked for what the JAX test checks: a detection on every
frame, the platform in bounds.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synthetic import TIMING_KWARGS
from wtracker_tpu.models.yolo_port import save_torch_state_dict as jax_save_pt
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.controllers import LogConfig as JaxLogConfig
from wtracker_tpu.sim.controllers import LoggingController as JaxLoggingController
from wtracker_tpu.sim.controllers import YoloConfig as JaxYoloConfig
from wtracker_tpu.sim.controllers import YoloController as JaxYoloController
from wtracker_tpu.sim.simulator import Simulator as JaxSimulator
from wtracker_tpu.utils.frame_reader import ArrayReader as JaxArrayReader
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.controllers import LogConfig, LoggingController, YoloConfig, YoloController
from wtracker_tpu_torch.sim.simulator import Simulator
from wtracker_tpu_torch.utils.frame_reader import ArrayReader

torch.set_num_threads(2)

H, W, F = 200, 240, 120
BOX_ATOL = 1e-3
TIE_GAP = 1e-5  # class logits closer than this at the top are a tie
POS = ["plt_x", "plt_y", "cam_x", "cam_y", "cam_w", "cam_h", "mic_x", "mic_y", "mic_w", "mic_h"]
WRM = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]


@pytest.fixture(scope="module")
def recording():
    """The JAX test's recording: a noisy background and a bright blob."""
    rng = np.random.default_rng(0)
    bg = rng.integers(20, 40, (H, W), dtype=np.uint8)
    frames = np.repeat(bg[None], F, axis=0)
    for i in range(F):
        x, y = 60 + i, 80 + i // 2
        frames[i, y - 4 : y + 4, x - 6 : x + 6] = 220
    return frames


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo_host")
    det = JaxDetector.init_random(nc=1, scale="n", imgsz=(64, 64), conf=0.0, seed=0)
    det.save(str(root / "det.npz"))
    jax_save_pt(det, str(root / "det.pt"))
    return root


def _run(pkg: str, frames: np.ndarray, model_path: str, out: str) -> pd.DataFrame:
    if pkg == "jax":
        E, T, Y, C, L, G, S, R = (JaxExperimentConfig, JaxTimingConfig, JaxYoloConfig, JaxYoloController,
                                  JaxLoggingController, JaxLogConfig, JaxSimulator, JaxArrayReader)
        cfg = Y(model_path=model_path, pred_kwargs={"imgsz": 64, "conf": 0.0})
    else:
        E, T, Y, C, L, G, S, R = (ExperimentConfig, TimingConfig, YoloConfig, YoloController,
                                  LoggingController, LogConfig, Simulator, ArrayReader)
        cfg = Y(model_path=model_path, device="cpu", pred_kwargs={"imgsz": 64, "conf": 0.0})
    exp = E("yolo-host", F, 60, (H, W), 90, (66, 84))
    timing = T(experiment_config=exp, **TIMING_KWARGS)
    wrapped = L(C(timing, cfg), G(root_folder=out, save_err_view=False))
    S(timing, exp, wrapped, reader=R(frames)).run(progress=False)
    return pd.read_csv(f"{out}/bboxes.csv"), timing


def _tied_anchors(frames: np.ndarray, rows: pd.DataFrame, weights) -> list[tuple[float, np.ndarray]]:
    """For each logged row, JAX's detector on that frame's camera view: the
    gap between the two largest class logits over every anchor, and the
    boxes of the anchors tied at the top (within ``TIE_GAP`` of the largest
    logit) as absolute xywh, mapped as the detector and the logger map the
    top-1 box."""
    import jax.numpy as jnp

    from wtracker_tpu.models.yolov8 import decode_predictions, preprocess_batch

    det = JaxDetector.load(str(weights), imgsz=64, conf=0.0)
    out = []
    for _, r in rows.iterrows():
        w, h = int(r.cam_w), int(r.cam_h)
        world = np.pad(frames[int(r.frame)], ((h // 2, h // 2), (w // 2, w // 2)), mode="edge")
        x, y = int(r.cam_x) + w // 2, int(r.cam_y) + h // 2
        view = world[y : y + h, x : x + w]
        img, (scale, pad_top, pad_left) = preprocess_batch(jnp.asarray(view[None]), (64, 64))
        box_l, cls_l = det.model.apply(det.variables, img, train=False)
        boxes, _ = decode_predictions(box_l, cls_l, (64, 64), det.model.reg_max)
        logits = np.concatenate([np.asarray(c, np.float32).reshape(-1) for c in cls_l])  # nc = 1: one per anchor
        top = np.sort(logits)
        tied = np.asarray(boxes[0], np.float64)[logits >= top[-1] - TIE_GAP]
        xy = (tied[:, :2] - [float(pad_left), float(pad_top)]) / float(scale) + [r.cam_x, r.cam_y]
        wh = (tied[:, 2:] - tied[:, :2]) / float(scale)
        out.append((float(top[-1] - top[-2]), np.concatenate([xy, wh], axis=1)))
    return out


@pytest.mark.parametrize("suffix", ["npz", "pt"])
def test_closed_loop_gives_the_jax_log(recording, weights, tmp_path, suffix):
    want, timing = _run("jax", recording, str(weights / "det.npz"), str(tmp_path / "jax"))
    got, _ = _run("torch", recording, str(weights / f"det.{suffix}"), str(tmp_path / "torch"))

    n_cycles = (F - 1) // timing.cycle_frame_num
    assert len(got) == len(want) == n_cycles * timing.cycle_frame_num
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got[["frame", "cycle", *POS]].to_numpy(), want[["frame", "cycle", *POS]].to_numpy())
    assert (got.phase == want.phase).all()
    wrm, ref = got[WRM].to_numpy(), want[WRM].to_numpy()
    assert np.isfinite(wrm).all()  # conf=0: a detection on every frame
    off = np.abs(wrm - ref).max(axis=1) > BOX_ATOL
    # a box off the bar is a flipped top-1 anchor: the two packages' float32
    # convolutions sum in other orders, and where two anchors' class logits
    # tie to the last bits (views whose letterbox padding or background is
    # the same under both anchors) each package keeps another one.  Such a
    # frame must be a tie in JAX's own logits; every other box meets the bar.
    # Each such box must be one of the tied anchors' boxes, as JAX's is.
    for (gap, tied), g, r in zip(_tied_anchors(recording, want[off], weights / "det.npz"), wrm[off], ref[off]):
        assert gap <= TIE_GAP, f"boxes differ beyond {BOX_ATOL} px at a non-tied frame: top-2 gap {gap}"
        assert (np.abs(tied - r).max(axis=1) <= BOX_ATOL).any(), "JAX's box is not among its tied anchors"
        assert (np.abs(tied - g).max(axis=1) <= BOX_ATOL).any(), f"the port's box {g} is none of the tied anchors {tied}"
    assert got.plt_x.between(0, W - 1).all() and got.plt_y.between(0, H - 1).all()
    # the platform followed the blob: it moved
    assert got.plt_x.nunique() > 1


def test_predict_returns_a_writable_float32_copy(weights):
    timing = TimingConfig(experiment_config=ExperimentConfig("p", F, 60, (H, W), 90, (66, 84)), **TIMING_KWARGS)
    ctl = YoloController(timing, YoloConfig(model_path=str(weights / "det.npz"), device="cpu",
                                            pred_kwargs={"imgsz": 64, "conf": 0.0}))
    views = np.random.default_rng(1).integers(0, 256, (3, 99, 108), dtype=np.uint8)
    boxes = ctl.predict(list(views))
    assert boxes.shape == (3, 4) and boxes.dtype == np.float32 and boxes.flags.writeable
    jax_ctl = JaxYoloController(
        JaxTimingConfig(experiment_config=JaxExperimentConfig("p", F, 60, (H, W), 90, (66, 84)), **TIMING_KWARGS),
        JaxYoloConfig(model_path=str(weights / "det.npz"), pred_kwargs={"imgsz": 64, "conf": 0.0}),
    )
    want = jax_ctl.predict(list(views))
    assert want.dtype == boxes.dtype
    np.testing.assert_allclose(boxes, want, rtol=0, atol=BOX_ATOL)
    with pytest.raises(ValueError, match="at least one frame"):
        ctl.predict([])


def test_yolo_config_pickles_without_its_model(weights, tmp_path):
    cfg = YoloConfig(model_path=str(weights / "det.npz"), device="cpu")
    assert YoloConfig(model_path="x").device == "cuda"  # entry points default to the card
    cfg.load_model()
    assert cfg.model is not None
    state = pickle.loads(pickle.dumps(cfg))
    assert state.model is None and state.model_path == cfg.model_path
    cfg.save_pickle(str(tmp_path / "cfg.pkl"))
    back = YoloConfig.load_pickle(str(tmp_path / "cfg.pkl"))
    assert back.model is None and back.pred_kwargs == cfg.pred_kwargs
