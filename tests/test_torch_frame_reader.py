"""The port's frame IO against the JAX package's.

Reference: ``wtracker_tpu.utils.frame_reader`` (``FrameReader``,
``FrameStream``, ``DummyReader``, ``ArrayReader``) and
``wtracker_tpu.runtime.native``.  Frames are 8-bit gray-palette and 24-bit
BMPs written by OpenCV, and PNGs; the width, 61, pads every BMP row.  The
port's BMP path is its native loader alone, so decoded bytes must equal the
JAX package's (and OpenCV's) exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cv2

from chip_smoke import write_gray_bmp
from wtracker_tpu.runtime import native as jax_native
from wtracker_tpu.utils import frame_reader as jfr
from wtracker_tpu_torch.runtime import native
from wtracker_tpu_torch.utils import frame_reader as tfr

ROOT = Path(__file__).resolve().parent.parent
H, W, N = 45, 61, 10


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Directories of 8-bit gray BMPs, 24-bit BMPs and PNGs, from seeded frames."""
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (N, H, W), dtype=np.uint8)
    color = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    out = {}
    for name, frames, ext in (("gray8", gray, "bmp"), ("bgr24", color, "bmp"), ("png", color, "png")):
        d = tmp_path_factory.mktemp(name)
        for i, f in enumerate(frames):
            assert cv2.imwrite(str(d / f"frame_{i:04d}.{ext}"), f)
        out[name] = str(d)
    return out


@pytest.mark.parametrize("fmt", [tfr.IMREAD_GRAYSCALE, tfr.IMREAD_COLOR], ids=["gray", "color"])
@pytest.mark.parametrize("src", ["gray8", "bgr24", "png"])
def test_reader_decodes_as_jax(dirs, src, fmt):
    assert (tfr.IMREAD_GRAYSCALE, tfr.IMREAD_COLOR) == (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR)
    got = tfr.FrameReader.create_from_directory(dirs[src], read_format=fmt)
    want = jfr.FrameReader.create_from_directory(dirs[src], read_format=fmt)
    assert got.files == want.files and len(got) == N
    assert got.frame_shape == want.frame_shape and got.frame_size == (H, W)

    picks = [7, 0, 3, 3, 9]
    np.testing.assert_array_equal(got.read_batch(), want.read_batch())
    np.testing.assert_array_equal(got.read_batch(picks), want.read_batch(picks))
    out = np.zeros((len(picks), *got.frame_shape), np.uint8)
    assert got.read_batch(picks, out=out) is out
    np.testing.assert_array_equal(out, want.read_batch(picks))
    np.testing.assert_array_equal(got[4], want[4])

    rng = np.random.default_rng(1)
    win = (17, 23)
    tls = np.stack([rng.integers(0, W - win[1] + 1, len(picks)), rng.integers(0, H - win[0] + 1, len(picks))], axis=1)
    tls[0] = (W - win[1], H - win[0])  # the far corner
    want_win = want.read_window_batch(picks, tls, win)
    np.testing.assert_array_equal(got.read_window_batch(picks, tls, win), want_win)
    out = np.zeros_like(want_win)
    assert got.read_window_batch(picks, tls, win, out=out) is out
    np.testing.assert_array_equal(out, want_win)

    with pytest.raises(ValueError, match="bounds"):
        got.read_window_batch([0], [[W - win[1] + 1, 0]], win)
    with pytest.raises(ValueError, match="bounds"):
        got.read_window_batch([0], [[0, -1]], win)
    with pytest.raises(ValueError, match="out shape"):
        got.read_batch(picks, out=np.zeros((1, *got.frame_shape), np.uint8))


def test_template_and_probe_match_jax(dirs):
    got = tfr.FrameReader.create_from_template(dirs["bgr24"], "frame_{}.bmp")
    want = jfr.FrameReader.create_from_template(dirs["bgr24"], "frame_{}.bmp")
    assert got.files == want.files and len(got) == N
    for src in ("gray8", "bgr24"):
        path = os.path.join(dirs[src], "frame_0002.bmp")
        assert native.probe_bmp(path) == jax_native.probe_bmp(path)
    assert native.probe_bmp(os.path.join(dirs["gray8"], "frame_0000.bmp")) == (H, W, 1)
    with pytest.raises(ValueError, match="probe"):
        native.probe_bmp(os.path.join(dirs["png"], "frame_0000.png"))


def test_stream_dummy_and_array_readers_match_jax():
    frames = np.random.default_rng(2).integers(0, 256, (6, 9, 11), dtype=np.uint8)
    for make in (lambda m: m.ArrayReader(frames), lambda m: m.DummyReader(5, (9, 11), colored=True)):
        got, want = make(tfr), make(jfr)
        assert got.frame_shape == want.frame_shape and len(got) == len(want)
        np.testing.assert_array_equal(got.read_batch(), want.read_batch())
        np.testing.assert_array_equal(got.read_batch([4, 1]), want.read_batch([4, 1]))
        tls = np.array([[2, 1], [0, 3]])
        np.testing.assert_array_equal(got.read_window_batch([4, 1], tls, (5, 7)), want.read_window_batch([4, 1], tls, (5, 7)))
        with pytest.raises(IndexError):
            got[len(got)]

        s_got, s_want = got.make_stream(), want.make_stream()
        assert s_got.index == s_want.index == -1 and not s_got.can_read()
        assert [f.tolist() for f in s_got] == [f.tolist() for f in s_want]
        assert s_got.seek(2) == s_want.seek(2) and s_got.index == 2
        np.testing.assert_array_equal(s_got.read(), s_want.read())
        assert s_got.progress(10) == s_want.progress(10) is False
        with pytest.raises(IndexError):
            s_got.read()
        s_got.reset()
        assert s_got.index == -1 and len(s_got) == len(got)


def test_import_leaves_opencv_out():
    code = (
        "import sys, wtracker_tpu_torch.utils.frame_reader, wtracker_tpu_torch.runtime.native\n"
        "print('CV2', 'cv2' in sys.modules)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CV2 False" in out.stdout


def test_without_opencv_only_other_types_fail(dirs, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    reader = tfr.FrameReader.create_from_directory(dirs["gray8"])
    np.testing.assert_array_equal(reader.read_batch([0]), cv2.imread(os.path.join(dirs["gray8"], "frame_0000.bmp"), 0)[None])
    with pytest.raises(ImportError, match=r"'\.png' frames .* needs OpenCV"):
        tfr.FrameReader.create_from_directory(dirs["png"])


def test_failed_native_build_raises(dirs, tmp_path, monkeypatch):
    broken = tmp_path / "frame_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the native frame loader"):
            tfr.FrameReader.create_from_directory(dirs["gray8"])
        assert not native.library_path().exists()
    finally:
        monkeypatch.undo()
        native.get_lib.cache_clear()


def test_chip_smoke_bmp_writer_round_trips(tmp_path):
    frame = np.random.default_rng(3).integers(0, 256, (H, W), dtype=np.uint8)
    path = str(tmp_path / "f.bmp")
    write_gray_bmp(path, frame)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), frame)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), np.repeat(frame[..., None], 3, axis=2))
    assert native.probe_bmp(path) == (H, W, 1)
    np.testing.assert_array_equal(native.load_batch_bmp([path], H, W)[0], frame)
    got = native.load_batch_bmp_window([path], H, W, np.array([[5, 7]]), 20, 30)[0]
    np.testing.assert_array_equal(got, frame[7:27, 5:35])
    assert os.path.getsize(path) == 14 + 40 + 1024 + H * 64  # rows padded from 61 to 64 bytes
