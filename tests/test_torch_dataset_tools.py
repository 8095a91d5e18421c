"""The port's dataset tools against the JAX package's, exactly: the median
and mean backgrounds (even probe counts, where ``torch.median`` would pick
the lower middle value; odd counts; uniform and random sampling; gray and
BGR frames), ``BoxCalculator`` with its memo and the no-worm case,
``SampleExtractor``'s windows and saved crops, and
``ExperimentConfig.from_frame_reader``'s JSON.  Frames come from numpy
seeds; everything runs on the CPU."""

import json

import cv2
import numpy as np
import pytest
import torch

from wtracker_tpu.dataset import BGExtractor as JaxBG
from wtracker_tpu.dataset import BoxCalculator as JaxBoxes
from wtracker_tpu.dataset import SampleExtractor as JaxSamples
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.utils.frame_reader import ArrayReader as JaxArrayReader
from wtracker_tpu.utils.frame_reader import FrameReader as JaxFrameReader
from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator, SampleExtractor
from wtracker_tpu_torch.dataset import bg_extractor
from wtracker_tpu_torch.sim.config import ExperimentConfig
from wtracker_tpu_torch.utils.frame_reader import ArrayReader, FrameReader
from wtracker_tpu_torch.utils.image_codec import imread


def _worm_frames(seed: int, n=8, hw=(96, 128), color=False):
    """A static noisy background and a bright moving blob (none in the last
    frame); BGR frames tint the three channels differently."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(20, 36, hw, dtype=np.uint8)
    frames = np.repeat(bg[None], n, axis=0).copy()
    for i in range(n - 1):
        y, x = 8 + (i * 11) % (hw[0] - 30), 10 + (i * 17) % (hw[1] - 30)
        frames[i, y : y + 9, x : x + 14] = rng.integers(150, 220)
    if color:
        frames = np.stack([frames, (frames * 0.9).astype(np.uint8), np.clip(frames.astype(int) + 7, 0, 255).astype(np.uint8)], -1)
        bg = np.stack([bg, (bg * 0.9).astype(np.uint8), np.clip(bg.astype(int) + 7, 0, 255).astype(np.uint8)], -1)
    return frames, bg


def _backgrounds(frames, num_probes, sampling, method, seed=5):
    np.random.seed(seed)
    want = JaxBG(JaxArrayReader(frames)).calc_background(num_probes, sampling, method)
    np.random.seed(seed)
    got = BGExtractor(ArrayReader(frames)).calc_background(num_probes, sampling, method, device="cpu")
    return got, want


def test_median_of_an_even_count_is_the_mean_of_the_middle_pair():
    # at pixel (0, 0) the probes are [10, 14, 3, 200]: JAX's median is 12,
    # torch.median's 10; the other pixels have middle pairs 2 to 9 apart
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 9, 11), dtype=np.uint8)
    frames[:, 0, 0] = [10, 14, 3, 200]
    got, want = _backgrounds(frames, 4, "uniform", "median")
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 12
    lower = torch.median(torch.from_numpy(frames), dim=0).values.numpy()
    assert lower[0, 0] == 10 and (lower != got).any()


@pytest.mark.parametrize("n", [6, 7, 24])
@pytest.mark.parametrize("method", ["median", "mean"])
@pytest.mark.parametrize("sampling", ["uniform", "random"])
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_background_equals_jax(n, method, sampling, color):
    frames, bg = _worm_frames(n, n=n, color=color)
    frames = frames.copy()
    frames[: n // 2] = np.clip(frames[: n // 2].astype(int) + np.random.default_rng(n).integers(0, 30, frames[0].shape),
                               0, 255).astype(np.uint8)  # spread the probes so middle pairs differ
    for num_probes in (n, n - 1, 3):
        got, want = _backgrounds(frames, num_probes, sampling, method)
        assert got.dtype == np.uint8 and got.shape == bg.shape
        np.testing.assert_array_equal(got, want)


def test_median_bands_give_one_answer(monkeypatch):
    frames, _ = _worm_frames(3, n=10)
    whole, want = _backgrounds(frames, 10, "uniform", "median")
    monkeypatch.setattr(bg_extractor, "BAND_ELEMENTS", 10 * 128 * 7)  # bands of 7 rows, the last one short
    banded, _ = _backgrounds(frames, 10, "uniform", "median")
    np.testing.assert_array_equal(banded, whole)
    np.testing.assert_array_equal(banded, want)


def test_background_argument_checks():
    with pytest.raises(ValueError, match="sampling"):
        BGExtractor(ArrayReader(np.zeros((3, 4, 5), np.uint8))).calc_background(3, "every", device="cpu")


@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_box_calculator_equals_jax_with_its_memo(color):
    frames, bg = _worm_frames(1, color=color)
    want = JaxBoxes(JaxArrayReader(frames), bg)
    got = BoxCalculator(ArrayReader(frames), bg, device="cpu")
    assert (got.all_bboxes() == -1).all()
    some = [5, 0, 3]
    np.testing.assert_array_equal(got.calc_specified_boxes(some, chunk_size=2), want.calc_specified_boxes(some, chunk_size=2))
    np.testing.assert_array_equal(got.all_bboxes(), want.all_bboxes())
    assert (got.all_bboxes()[[1, 2, 4, 6, 7], 0] == -1).all()  # the memo: the rest still uncomputed
    np.testing.assert_array_equal(got.get_bbox(6), want.get_bbox(6))
    np.testing.assert_array_equal(got.calc_all_boxes(chunk_size=3), want.calc_all_boxes(chunk_size=3))
    assert got.all_bboxes().dtype == want.all_bboxes().dtype
    assert tuple(got.all_bboxes()[-1]) == (0, 0, 0, 0)  # the last frame has no worm
    assert (got.all_bboxes()[:-1, 2] > 0).all()


def test_box_calculator_without_a_worm():
    frames = np.full((3, 40, 50), 30, np.uint8)
    got = BoxCalculator(ArrayReader(frames), frames[0], device="cpu").calc_all_boxes()
    want = JaxBoxes(JaxArrayReader(frames), frames[0]).calc_all_boxes()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    with pytest.raises(ValueError, match="shape"):
        BoxCalculator(ArrayReader(frames), frames[0, :10], device="cpu")


@pytest.mark.parametrize("count", [5, 8])
def test_sample_extractor_windows_and_crops_equal_jax(tmp_path, count):
    frames, bg = _worm_frames(2, n=8, hw=(96, 128))
    target = (40, 32)
    want_ex = JaxSamples(JaxBoxes(JaxArrayReader(frames), bg))
    got_ex = SampleExtractor(BoxCalculator(ArrayReader(frames), bg, device="cpu"))

    det = want_ex._bbox_calculator.calc_all_boxes()
    np.testing.assert_array_equal(
        got_ex._jittered_windows(det, target, np.random.default_rng(3)),
        want_ex._jittered_windows(det, target, np.random.default_rng(3)),
    )
    want_ex.create_samples(count, target, str(tmp_path / "jax"), seed=11)
    got_ex.create_samples(count, target, str(tmp_path / "torch"), seed=11)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir()) and len(names) == count
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(imread(str(tmp_path / "torch" / name), -1), want)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "torch" / name), cv2.IMREAD_UNCHANGED), want)
        assert want.shape == (target[1], target[0])

    # every crop is the frame at its window: recompute the seed's picks and windows
    picks = np.random.default_rng(11).choice(len(frames), size=count, replace=False)
    windows = got_ex._jittered_windows(got_ex._bbox_calculator.calc_specified_boxes(picks), target,
                                       np.random.default_rng(11))
    for i, (f, (x, y, w, h)) in enumerate(zip(picks, windows)):
        crop = imread(str(tmp_path / "torch" / f"img_{i:09d}.png"), -1)
        np.testing.assert_array_equal(crop, frames[f, y : y + h, x : x + w])


def test_experiment_config_from_frame_reader(tmp_path):
    frames, _ = _worm_frames(0, n=5)
    (tmp_path / "frames").mkdir()
    for i, f in enumerate(frames):
        assert cv2.imwrite(str(tmp_path / "frames" / f"frame_{i:03d}.bmp"), f)
    kw = dict(name="exp", frames_per_sec=60.0, px_per_mm=90.0, init_position=(40, 30))
    JaxExperimentConfig.from_frame_reader(JaxFrameReader.create_from_directory(str(tmp_path / "frames")), **kw).save_json(
        str(tmp_path / "jax.json"))
    ExperimentConfig.from_frame_reader(FrameReader.create_from_directory(str(tmp_path / "frames")), **kw).save_json(
        str(tmp_path / "torch.json"))
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "torch.json").read_text())["num_frames"] == 5
