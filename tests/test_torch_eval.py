"""The port's evaluation tools against the JAX package's, exactly: the bbox,
MSE and precise errors (the per-frame loop, the batched tiles and the
device-gathered tiles; float32 bits equal), ``DataAnalyzer`` (initialize,
clean, change_unit, anomalies, describe, stats, both precise-error paths),
the data each plot hands seaborn, ``VLC.render_frame`` and ``save_frames``
against JAX's OpenCV drawing, and the file prompts of ``gui_utils`` with
``ConfigBase``.  Logs come from the JAX host simulator on a seeded worm
track; crops and frames from numpy seeds.  Everything runs on the CPU."""

import json
import types

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

import wtracker_tpu.eval.error_calculator as jec
import wtracker_tpu.utils.gui_utils as jgui
import wtracker_tpu_torch.eval.error_calculator as tec
import wtracker_tpu_torch.utils.gui_utils as tgui
from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from wtracker_tpu.eval.data_analyzer import DataAnalyzer as JaxAnalyzer
from wtracker_tpu.eval.plotter import Plotter as JaxPlotter
from wtracker_tpu.eval.vlc import VLC as JaxVLC
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.utils.frame_reader import ArrayReader as JaxArrayReader
from wtracker_tpu_torch.eval import VLC, DataAnalyzer, ErrorCalculator, Plotter
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.utils.frame_reader import ArrayReader, FrameReader
from wtracker_tpu_torch.utils.image_codec import imread, imwrite


@pytest.fixture(scope="module")
def sim_log(tmp_path_factory):
    """A bboxes.csv of the JAX host simulator (csv controller) on a seeded
    worm track, with both packages' timing configs."""
    from wtracker_tpu.sim.controllers import CsvController, LogConfig, LoggingController
    from wtracker_tpu.sim.simulator import Simulator

    tmp = tmp_path_factory.mktemp("eval")
    make_worm_csv(str(tmp / "worm.csv"))
    exp = JaxExperimentConfig(**EXP_KWARGS)
    jt = JaxTimingConfig(experiment_config=exp, **TIMING_KWARGS)
    ctl = LoggingController(CsvController(jt, str(tmp / "worm.csv")),
                            LogConfig(root_folder=str(tmp / "run"), save_err_view=False))
    Simulator(jt, exp, ctl).run(progress=False)
    tt = TimingConfig(experiment_config=ExperimentConfig(**EXP_KWARGS), **TIMING_KWARGS)
    return str(tmp / "run" / "bboxes.csv"), jt, tt


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def test_bbox_and_mse_errors_equal_jax():
    rng = np.random.default_rng(0)
    wrm, mic = rng.uniform(0, 200, (256, 4)), rng.uniform(0, 200, (256, 4))
    wrm[:, 2:], mic[:, 2:] = rng.uniform(1, 30, (256, 2)), rng.uniform(1, 30, (256, 2))
    wrm[7] = 0  # a zero-area worm box
    wrm[9] = np.nan
    for fn in ("calculate_bbox_error", "calculate_mse_error"):
        got = getattr(ErrorCalculator, fn)(wrm.copy(), mic.copy())
        want = getattr(jec.ErrorCalculator, fn)(wrm.copy(), mic.copy())
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def _precise_fixture(seed: int, n=48, arena=(120, 140)):
    """Background, worm boxes (one NaN, one at the arena's edge, one
    fractional), micro boxes, frame numbers, padded worm crops and a reader
    returning each frame's crop at its discretized box."""
    rng = np.random.default_rng(seed)
    background = rng.integers(0, 40, arena, dtype=np.uint8)
    wrm, mic = np.zeros((n, 4)), np.zeros((n, 4))
    views = np.zeros((n, 24, 24), np.uint8)
    for i in range(n):
        w, h = rng.integers(6, 20, 2)
        x, y = rng.integers(0, arena[1] - w), rng.integers(0, arena[0] - h)
        wrm[i] = (x, y, w, h)
        mic[i] = (x + rng.integers(-6, 6), y + rng.integers(-6, 6), 15, 15)
        crop = background[y : y + h, x : x + w].copy()
        crop[h // 3 : 2 * h // 3, w // 3 : 2 * w // 3] += np.uint8(rng.integers(5, 100))  # a worm, faint in some frames
        views[i, :h, :w] = crop
    wrm[3] = np.nan
    wrm[5] = (arena[1] - 9, arena[0] - 7, 9, 7)
    views[5, :7, :9] = background[-7:, -9:] + 60
    mic[11] = (200, 200, 15, 15)  # outside the arena: no intersection

    class CropReader:
        def __getitem__(self, idx):
            x, y, w, h = (int(v) for v in np.nan_to_num(wrm[idx]))
            return views[idx, :h, :w]

    return background, wrm, mic, np.arange(n), CropReader(), views


@pytest.mark.parametrize("diff_thresh", [10, 50])
def test_precise_error_loop_batched_and_tiles_equal_jax(diff_thresh):
    background, wrm, mic, frames, reader, views = _precise_fixture(diff_thresh)
    seen = {"jax": [], "torch": []}
    jec.ErrorCalculator.probe_hook = lambda v, m: seen["jax"].append((v.copy(), m.copy()))
    ErrorCalculator.probe_hook = lambda v, m: seen["torch"].append((v.copy(), m.copy()))
    try:
        want = jec.ErrorCalculator.calculate_precise(background, wrm.copy(), mic.copy(), frames, reader, diff_thresh)
        got = ErrorCalculator.calculate_precise(background, wrm.copy(), mic.copy(), frames, reader, diff_thresh)
    finally:
        jec.ErrorCalculator.probe_hook = ErrorCalculator.probe_hook = None
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(got[3]) and len(seen["torch"]) == len(seen["jax"]) == len(frames) - 1
    for (gv, gm), (wv, wm) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gm, wm)

    # the device paths on the legal rows: worm boxes, tiles, rectangles
    from wtracker_tpu.utils import bbox as jbb

    legal = np.isfinite(wrm).all(axis=1)
    boxes, _ = jbb.discretize(wrm[legal], background.shape, jbb.BoxFormat.XYWH)
    micd, _ = jbb.discretize(mic[legal], background.shape, jbb.BoxFormat.XYWH)
    wx, mx = jbb.to_xyxy(boxes, jbb.BoxFormat.XYWH), jbb.to_xyxy(micd, jbb.BoxFormat.XYWH)
    tl, br = np.maximum(wx[:, :2], mx[:, :2]), np.minimum(wx[:, 2:], mx[:, 2:])
    rects = np.concatenate([tl - wx[:, :2], np.maximum(br - tl, 0)], axis=1)
    tiles = views[legal]
    bg_views = np.zeros_like(tiles)
    for i, (x, y, w, h) in enumerate(boxes):
        bg_views[i, :h, :w] = background[y : y + h, x : x + w]
    hw = boxes[:, [3, 2]]

    want_b = np.asarray(jec.precise_error_batched(tiles, bg_views, hw, rects, diff_thresh))
    got_b = tec.precise_error_batched(tiles, bg_views, hw, rects, diff_thresh, device="cpu")
    assert got_b.dtype == torch.float32 and want_b.dtype == np.float32
    np.testing.assert_array_equal(_bits(got_b.numpy()), _bits(want_b))
    want_t = np.asarray(jec.precise_error_tiles(background, tiles, boxes, rects, diff_thresh))
    got_t = tec.precise_error_tiles(background, tiles, boxes, rects, diff_thresh, device="cpu")
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t))
    np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(got_b.numpy()))
    assert (got_t.numpy() > 0).any() and (got_t.numpy() == 0).any()


def test_device_paths_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    z = np.zeros((1, 8, 8), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tec.precise_error_tiles(z[0], z, np.zeros((1, 4), int), np.zeros((1, 4), int))


def _analyzers(sim_log):
    log_path, jt, tt = sim_log
    want, got = JaxAnalyzer.load(jt, log_path), DataAnalyzer.load(tt, log_path)
    want.initialize(period=7)
    got.initialize(period=7)
    return got, want


def test_analyzer_frames_equal_jax(sim_log, capsys):
    got, want = _analyzers(sim_log)
    assert_frame_equal(got.data, want.data, check_exact=True)
    assert_frame_equal(got._orig_data, want._orig_data, check_exact=True)

    bounds = (30.0, 20.0, 560.0, 470.0)
    for an in (got, want):
        an.clean(trim_cycles=True, imaging_only=True, bounds=bounds)
    assert_frame_equal(got.data, want.data, check_exact=True)
    for unit in ("sec", "frame", "sec", "frame"):
        got.change_unit(unit)
        want.change_unit(unit)
        assert_frame_equal(got.data, want.data, check_exact=True)
        assert got.unit == want.unit == unit

    kw = dict(min_speed=2.0, min_bbox_error=0.5, min_dist_error=12.0, min_size=13.5)  # px and frames
    assert_frame_equal(got.calc_anomalies(**kw), want.calc_anomalies(**kw), check_exact=True)
    assert_frame_equal(got.calc_anomalies(remove_anomalies=True, **kw),
                       want.calc_anomalies(remove_anomalies=True, **kw), check_exact=True)
    assert_frame_equal(got.data, want.data, check_exact=True)
    assert_frame_equal(got.describe(["wrm_speed", "bbox_error"], num=4), want.describe(["wrm_speed", "bbox_error"], num=4),
                       check_exact=True)
    capsys.readouterr()
    got.print_stats()
    got_out = capsys.readouterr().out
    want.print_stats()
    assert got_out == capsys.readouterr().out and "Count of Removed Frames" in got_out
    assert 0 < len(got.data) < len(got._orig_data)

    got.reset_changes()
    want.reset_changes()
    got.remove_cycle([0, 3])
    want.remove_cycle([0, 3])
    assert_frame_equal(got.data, want.data, check_exact=True)
    assert got.column_names() == want.column_names()


def _crop_reader(log_path, background, seed, ragged_dir=None):
    """Seeded crops for every frame of the log: an (N, H, W) array padded to
    the largest discretized worm box, or ragged BMP files in ``ragged_dir``
    (each cut to its frame's box)."""
    from wtracker_tpu.utils import bbox as jbb

    df = pd.read_csv(log_path)
    boxes, legal = jbb.discretize(df[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(), background.shape,
                                  jbb.BoxFormat.XYWH)
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (len(df), int(boxes[:, 3].max()), int(boxes[:, 2].max())), dtype=np.uint8)
    if ragged_dir is None:
        return crops
    ragged_dir.mkdir()
    for i, (x, y, w, h) in enumerate(boxes):
        imwrite(str(ragged_dir / f"crop_{i:06d}.bmp"), crops[i, : max(h, 1), : max(w, 1)])
    return crops


@pytest.mark.parametrize("batched", [False, True], ids=["loop", "batched"])
def test_analyzer_precise_error_equals_jax(sim_log, tmp_path, batched):
    """Ragged crop files (each frame's crop at its box) through both paths;
    the batched path also from one padded array."""
    from wtracker_tpu.utils.frame_reader import FrameReader as JaxFrameReader

    log_path = sim_log[0]
    background = np.random.default_rng(1).integers(0, 256, EXP_KWARGS["orig_resolution"], dtype=np.uint8)
    crops = _crop_reader(log_path, background, 2, tmp_path / "crops")
    readers = [(FrameReader.create_from_directory(str(tmp_path / "crops")),
                JaxFrameReader.create_from_directory(str(tmp_path / "crops")))]
    if batched:
        readers.append((ArrayReader(crops), JaxArrayReader(crops)))
    for reader, jax_reader in readers:
        got, want = _analyzers(sim_log)
        want.clean(trim_cycles=True)
        got.clean(trim_cycles=True)
        want.calc_precise_error(jax_reader, background, diff_thresh=90, batched=batched)
        got.calc_precise_error(reader, background, diff_thresh=90, batched=batched, device="cpu")
        assert_frame_equal(got.data, want.data, check_exact=True)
        assert_frame_equal(got._orig_data, want._orig_data, check_exact=True)
    errs = got._orig_data["precise_error"].to_numpy()
    assert np.isnan(errs).any() and ((errs > 0) & (errs < 1)).any()
    if batched:
        got.calc_precise_error_experimental(ArrayReader(crops), background, diff_thresh=90, device="cpu")
        assert_frame_equal(got._orig_data, want._orig_data, check_exact=True)


def _captured_plots(monkeypatch, plotter):
    """The kwargs each plot hands seaborn (the figure itself is not drawn)."""
    import seaborn

    calls = []

    class Grid:
        def __init__(self):
            self.ax_joint = types.SimpleNamespace(invert_yaxis=lambda: calls.append(("invert_yaxis",)))

        def set_xlabels(self, label):
            calls.append(("xlabel", label))

        def set_axis_labels(self, x, y):
            calls.append(("axis_labels", x, y))

    for fn in ("displot", "catplot", "jointplot"):
        monkeypatch.setattr(seaborn, fn, lambda fn=fn, **kw: calls.append((fn, kw)) or Grid())
    plotter.plot_speed_distribution()
    plotter.plot_error_distribution(error_kind="bbox", log_wise=True)
    plotter.plot_cycle_error()
    plotter.plot_speed_vs_error(cycle_wise=True)
    plotter.plot_speed_vs_error(condition=lambda d: d["wrm_speed"] > 0.2)
    plotter.plot_trajectory()
    plotter.plot_head_size()
    plotter.plot_deviation(log_wise=True)
    plotter.create_catplot("cycle_step", "wrm_speed", hue_col="log_num", transform=lambda d: d.iloc[::2])
    monkeypatch.undo()
    return calls


def test_plots_hand_seaborn_the_jax_data(sim_log, monkeypatch):
    got, want = _analyzers(sim_log)
    got.change_unit("sec")
    want.change_unit("sec")
    got_calls = _captured_plots(monkeypatch, Plotter.from_analyzers([got, got]))
    want_calls = _captured_plots(monkeypatch, JaxPlotter.from_analyzers([want, want]))
    assert len(got_calls) == len(want_calls) > 9
    for g, w in zip(got_calls, want_calls):
        assert g[0] == w[0]
        if len(g) == 2 and isinstance(g[1], dict):
            assert g[1].keys() == w[1].keys()
            for k in g[1]:
                if isinstance(g[1][k], pd.DataFrame):
                    assert_frame_equal(g[1][k], w[1][k], check_exact=True)
                else:
                    assert g[1][k] == w[1][k], k
        else:
            assert g == w
    assert Plotter([got.data])._unit_labels() == JaxPlotter([want.data])._unit_labels()


def test_a_plot_is_drawn(sim_log, tmp_path):
    import matplotlib.pyplot as plt

    got, _ = _analyzers(sim_log)
    Plotter([got.data]).plot_head_size().savefig(str(tmp_path / "head.png"))
    plt.close("all")
    assert imread(str(tmp_path / "head.png"), 1).shape[2] == 3


def _vlc_log(path, hw, seed):
    """A log whose boxes cross the frame's edges, lie outside it, hold NaN
    rows and fractional and negative coordinates."""
    rng = np.random.default_rng(seed)
    n = 12
    h, w = hw
    cam = np.stack([rng.uniform(-30, w - 20, n), rng.uniform(-30, h - 20, n), np.full(n, 40.0), np.full(n, 36.0)], 1)
    mic = np.stack([cam[:, 0] + rng.uniform(-5, 30, n), cam[:, 1] + rng.uniform(-5, 30, n), np.full(n, 9.0), np.full(n, 9.0)], 1)
    wrm = np.stack([rng.uniform(-10, w + 5, n), rng.uniform(-10, h + 5, n), rng.uniform(0, 30, n), rng.uniform(0, 20, n)], 1)
    wrm[3] = np.nan
    mic[5, 0] = np.nan
    wrm[7] = (w - 3.5, h - 2.2, 10.0, 10.0)  # over the bottom-right corner
    plt_xy = cam[:, :2] + cam[:, 2:] / 2
    plt_xy[4] = (1.0, h - 1.0)  # the marker clipped at the edges
    plt_xy[6] = np.nan
    df = pd.DataFrame({"frame": np.arange(n), "cycle": np.arange(n) // 4, "phase": "imaging",
                       "plt_x": plt_xy[:, 0], "plt_y": plt_xy[:, 1],
                       **{f"cam_{c}": cam[:, i] for i, c in enumerate("xywh")},
                       **{f"mic_{c}": mic[:, i] for i, c in enumerate("xywh")},
                       **{f"wrm_{c}": wrm[:, i] for i, c in enumerate("xywh")}})
    df.to_csv(path, index=False)
    return n


@pytest.mark.parametrize("cam_type", ["plt", "cam", "mic"])
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_render_frame_equals_jax_opencv(sim_log, tmp_path, cam_type, color):
    _, jt, tt = sim_log
    hw = (70, 90)
    n = _vlc_log(tmp_path / "log.csv", hw, seed=3 + color)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (n, *hw, 3) if color else (n, *hw), dtype=np.uint8)
    kw = dict(config=None, log_path=str(tmp_path / "log.csv"), cam_type=cam_type, show_cam=True)
    want = JaxVLC(files=JaxArrayReader(frames), **{**kw, "config": jt})
    got = VLC(files=ArrayReader(frames), **{**kw, "config": tt})
    assert len(got) == len(want) == n
    for i in range(n):
        np.testing.assert_array_equal(got.render_frame(i), want.render_frame(i), err_msg=f"frame {i}")
    got.show_pred = want.show_pred = False
    np.testing.assert_array_equal(got.render_frame(7), want.render_frame(7))
    # white frames sized from the log, and the saved frames
    want = JaxVLC(files=None, **{**kw, "config": jt})
    got = VLC(files=None, **{**kw, "config": tt})
    for i in (0, 4, 7):
        np.testing.assert_array_equal(got.render_frame(i), want.render_frame(i))
    got.save_frames(str(tmp_path / "got"), start=2, stop=6)
    want.save_frames(str(tmp_path / "want"), start=2, stop=6)
    for i in range(2, 6):
        name = f"frame_{i:09d}.png"
        np.testing.assert_array_equal(imread(str(tmp_path / "got" / name), -1),
                                      cv2.imread(str(tmp_path / "want" / name), cv2.IMREAD_UNCHANGED))


def test_vlc_reads_frame_files(sim_log, tmp_path):
    """A list of file paths, read unchanged (gray BMPs and BGR PNGs)."""
    _, jt, tt = sim_log
    hw = (40, 50)
    n = _vlc_log(tmp_path / "log.csv", hw, seed=9)
    rng = np.random.default_rng(5)
    files = []
    for i in range(n):
        img = rng.integers(0, 256, hw if i % 2 else (*hw, 3), dtype=np.uint8)
        files.append(str(tmp_path / f"f_{i:03d}.{'bmp' if i % 2 else 'png'}"))
        assert cv2.imwrite(files[-1], img)
    want = JaxVLC(files=files, config=jt, log_path=str(tmp_path / "log.csv"))
    got = VLC(files=files, config=tt, log_path=str(tmp_path / "log.csv"))
    for i in range(n):
        np.testing.assert_array_equal(got.render_frame(i), want.render_frame(i))


def test_user_prompt_and_config_prompting(tmp_path, monkeypatch):
    """The dialogs with a stand-in tkinter: the same calls as JAX's; a
    config with no path asks the dialog for one."""
    calls = []

    class Tk:
        def __getattr__(self, name):
            return lambda *a, **k: calls.append(name) or 0

    answers = {"askopenfilename": str(tmp_path / "in.json"), "asksaveasfilename": str(tmp_path / "out" / "t.json"),
               "askopenfilenames": ("a", "b"), "askdirectory": str(tmp_path)}
    dialog = types.SimpleNamespace(**{k: (lambda k=k, **kw: calls.append((k, sorted(kw))) or answers[k]) for k in answers})
    fake = types.ModuleType("tkinter")
    fake.Tk, fake.filedialog = Tk, dialog
    monkeypatch.setitem(__import__("sys").modules, "tkinter", fake)
    monkeypatch.setitem(__import__("sys").modules, "tkinter.filedialog", dialog)
    monkeypatch.setenv("DISPLAY", ":0")

    results = {}
    for name, mod in (("jax", jgui), ("torch", tgui)):
        calls.clear()
        results[name] = (
            mod.UserPrompt.open_file(title="t", file_types=[("csv", ".csv")]),
            mod.UserPrompt.open_file(multiple=True),
            mod.UserPrompt.save_file(title="s"),
            mod.UserPrompt.open_directory(),
            list(calls),
        )
    assert results["torch"] == results["jax"]
    assert results["torch"][1] == ["a", "b"]

    cfg = TimingConfig(experiment_config=ExperimentConfig(**EXP_KWARGS), **TIMING_KWARGS)
    cfg.save_json(str(tmp_path / "in.json"))
    assert TimingConfig.load_json(None).__dict__ == json.loads((tmp_path / "in.json").read_text())  # the open dialog's
    cfg.save_json(None)  # the save dialog's answer
    assert json.loads((tmp_path / "out" / "t.json").read_text()) == json.loads((tmp_path / "in.json").read_text())

    monkeypatch.delenv("DISPLAY")
    with pytest.raises(RuntimeError, match="need a display"):
        tgui.UserPrompt.open_file()
