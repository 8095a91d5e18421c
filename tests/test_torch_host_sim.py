"""The host simulator backend against the JAX package's.

Reference: ``wtracker_tpu/sim/simulator.py``, ``sim/view.py``,
``sim/motor.py``, ``sim/controllers/*`` and the utils they use
(``log_utils``, ``path_utils``, ``threading_utils``, ``io_utils``,
``config_base``).  Held here on the same inputs, made from seeds:

* unit parity: ``CSVLogger`` writes the same bytes, ``Files`` and
  ``bulk_rename`` see and rename the same files, config pickles round-trip,
  ``TaskScheduler`` runs every task and raises a task's error,
  ``integer_motor_steps`` and the host motors give the same step sequences,
  the view geometry gives the same crops;
* the host backend's ``bboxes.csv`` for the csv (sine and step motor),
  optimal, polyfit and mlp controllers is the JAX host backend's text byte
  for byte over 299 cycles, and the port engine's text (the host writes
  ``\\r\\n`` line ends, the engine ``\\n``); polyfit only up to the log's
  first exact .5 tie, where each least-squares solver rounds its own way
  (JAX's own host and engine part there too; see the test);
* ``WeightEvaluator.eval`` equals JAX's to 1e-12 relative at degrees 1
  and 2 (the mean's sum runs in another order, and XLA contracts the
  Jacobi's multiply-adds; at degree 3 the fits extrapolate so far that
  JAX's own jitted and numpy evaluations part by 3e-12).
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.models.resmlp import save_predictor as jax_save_predictor
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim import controllers as jc
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import motor as jm
from wtracker_tpu.sim import view as jv
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.simulator import Simulator as JaxSimulator
from wtracker_tpu.utils import config_base as jcb
from wtracker_tpu.utils import io_utils as jio
from wtracker_tpu.utils import log_utils as jlog
from wtracker_tpu.utils import path_utils as jpath
from wtracker_tpu.utils import threading_utils as jthr
from wtracker_tpu.utils.frame_reader import ArrayReader as JaxArrayReader
from wtracker_tpu_torch.models.resmlp import load_predictor
from wtracker_tpu_torch.sim import controllers as tc
from wtracker_tpu_torch.sim import engine
from wtracker_tpu_torch.sim import motor as tm
from wtracker_tpu_torch.sim import view as tv
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.simulator import Simulator
from wtracker_tpu_torch.utils import config_base as tcb
from wtracker_tpu_torch.utils import io_utils as tio
from wtracker_tpu_torch.utils import log_utils as tlog
from wtracker_tpu_torch.utils import path_utils as tpath
from wtracker_tpu_torch.utils import threading_utils as tthr
from wtracker_tpu_torch.utils.frame_reader import ArrayReader

torch.set_num_threads(2)

HOST_FRAMES = 2400  # 299 logged cycles of 8 frames
COLS = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]
POLYFIT = dict(degree=2, sample_times=[3, -8, 0, -4], weights=[1.5, 0.5, 2.0, 1.0])
# polyfit on this log: the first line where the port's engine and the host
# part (an exact .5 tie, see the test), and where the port's engine and JAX's do
FIRST_POLYFIT_TIE_LINE, JAX_ENGINE_PARTS_LINE = 583, 752


# -- utils ---------------------------------------------------------------------


ROWS = [
    {"frame": 0, "x": 1.5, "name": "imaging"},
    {"frame": np.int64(1), "x": np.float64(0.1) + np.float64(0.2), "name": "a,b"},
    {"frame": 2, "x": np.float32(2.25)},  # missing key: an empty cell
    [3, float("nan"), 'quote "me"'],
    (np.int32(4), -0.0, ""),
]


def test_csv_logger_writes_the_jax_bytes(tmp_path):
    for mod, name in ((jlog, "jax.csv"), (tlog, "torch.csv")):
        with mod.CSVLogger(str(tmp_path / name), ["frame", "x", "name"]) as log:
            log.write(ROWS[0])
            log.writerows(ROWS[1:])
        log.close()  # idempotent
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert b"\r\n" in (tmp_path / "torch.csv").read_bytes()


@pytest.mark.parametrize("row", [{"frame": 0, "bogus": 1}, [0, 1], [0, 1, 2, 3]], ids=["unknown-key", "short", "long"])
def test_csv_logger_refuses_malformed_rows(tmp_path, row):
    for mod in (jlog, tlog):
        log = mod.CSVLogger(str(tmp_path / f"{mod.__name__}.csv"), ["frame", "x", "name"])
        with pytest.raises(ValueError):
            log.write(row)
        log.close()


def _tree(root):
    os.makedirs(root / "sub")
    for i in (10, 2, 33, 1):
        (root / f"frame_{i}.BMP").write_bytes(bytes([i]))
    (root / "notes.txt").write_text("x")


def test_files_and_bulk_rename_equal_jax(tmp_path):
    for name in ("jax", "torch"):
        _tree(tmp_path / name)
    key = lambda n: int(n.split("_")[1].split(".")[0]) if n.startswith("frame") else -1  # noqa: E731
    for kw in (dict(extension=".bmp", sorting_key=key), dict(scan_dirs=True, return_full_path=False)):
        a = jpath.Files(str(tmp_path / "jax"), **kw)
        b = tpath.Files(str(tmp_path / "torch"), **kw)
        assert len(a) == len(b)
        assert [os.path.relpath(p, tmp_path / "jax") if os.path.isabs(p) else p for p in a] == [
            os.path.relpath(p, tmp_path / "torch") if os.path.isabs(p) else p for p in b
        ]
        assert ("notes.txt" in a) == ("notes.txt" in b)
    b = tpath.Files(str(tmp_path / "torch"), extension=".bmp", sorting_key=key)
    assert os.path.basename(b.seek(2)) == "frame_10.BMP" and b.get_filename() == "frame_10.BMP"
    with pytest.raises(IndexError):
        b.seek(len(b))
    os.makedirs(tmp_path / "copy")
    b.copy(str(tmp_path / "copy"))
    assert (tmp_path / "copy" / "frame_10.BMP").read_bytes() == bytes([10])

    rename = lambda n: n.lower().replace("frame_", "f")  # noqa: E731
    jpath.bulk_rename(str(tmp_path / "jax"), rename)
    tpath.bulk_rename(str(tmp_path / "torch"), rename)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch"))
    assert tpath.absolute_path("a/../b.csv") == jpath.absolute_path("a/../b.csv")
    tpath.create_parent_directory(str(tmp_path / "deep" / "er" / "x.csv"))
    assert (tmp_path / "deep" / "er").is_dir()


def test_config_pickles_and_initialization_text(tmp_path, capsys):
    cfg = tc.PolyfitConfig(**POLYFIT)
    cfg.save_pickle(str(tmp_path / "p" / "cfg.pkl"))
    back = tc.PolyfitConfig.load_pickle(str(tmp_path / "p" / "cfg.pkl"))
    assert back == cfg and back.sample_times == sorted(POLYFIT["sample_times"])
    with pytest.raises(ValueError, match="item 11"):
        tc.PolyfitConfig.load_json(None)
    with pytest.raises(FileNotFoundError):
        tio.pickle_load_object(str(tmp_path / "missing.pkl"))
    for jcls, tcls in ((JaxExperimentConfig, ExperimentConfig), (JaxTimingConfig, TimingConfig),
                       (jc.LogConfig, tc.LogConfig)):
        for kw in (dict(), dict(include_default=False, init_fields_only=False)):
            assert tcb.print_initialization(tcls, **kw) == jcb.print_initialization(jcls, **kw)
    capsys.readouterr()


@pytest.mark.parametrize("use_tqdm", [False, True])
def test_task_scheduler_runs_every_task_and_raises_errors(use_tqdm):
    done = []
    with tthr.TaskScheduler(lambda p: done.append(p[0] * 2), maxsize=3, tqdm=use_tqdm, disable=True) as s:
        for i in range(20):
            s.schedule_save(i)
    assert done == [2 * i for i in range(20)]

    def fail(p):
        if p[0] == 3:
            raise KeyError("three")
        done.append(p[0])

    s = tthr.TaskScheduler(fail, tqdm=False)
    s.start()
    for i in range(6):
        s.schedule_save(i)
    with pytest.raises(RuntimeError, match="1 task"):
        s.close()
    assert done[-5:] == [0, 1, 2, 4, 5]
    for tasks in (0, 5, 64, 1000):
        for chunk in (1, 8):
            for workers in (None, -1, 0, 1, 3, 100):
                assert tthr.adjust_num_workers(tasks, chunk, workers) == jthr.adjust_num_workers(tasks, chunk, workers)


def test_image_saver_writes_the_jax_files(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (17, 23), dtype=np.uint8)
    frames = np.random.default_rng(1).integers(0, 256, (3, 30, 40), dtype=np.uint8)
    for mod, reader, name in ((jio, JaxArrayReader(frames), "jax"), (tio, ArrayReader(frames), "torch")):
        with mod.ImageSaver(str(tmp_path / name), tqdm=False) as s:
            s.schedule_save(img, "sub/img.png")
        with mod.FrameSaver(reader, str(tmp_path / name), tqdm=False) as s:
            s.schedule_save(2, (5, 4, 12, 9), "crops/c.png")
    for rel in ("sub/img.png", "crops/c.png"):
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


# -- motors and view geometry ------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4, 7])
def test_integer_motor_steps_equal_jax(n):
    d = np.random.default_rng(n).normal(0, 40, (5, 2)).round() + np.array([[0.5, -0.5]] * 5)
    for weights in (jm.sine_step_weights(n), jm.step_weights(n)):
        want = np.asarray(jm.integer_motor_steps(weights, d))
        got = tm.integer_motor_steps(weights, torch.from_numpy(d))
        assert got.dtype == torch.int32 and got.shape == (n, 5, 2)
        np.testing.assert_array_equal(got.numpy(), want)


def _timing(mod_e, mod_t, **kw):
    return mod_t(experiment_config=mod_e(**{**EXP_KWARGS, **kw}), **TIMING_KWARGS)


@pytest.mark.parametrize("kind", ["sine", "step"])
def test_host_motors_give_the_jax_steps(kind):
    jt, tt = _timing(JaxExperimentConfig, JaxTimingConfig), _timing(ExperimentConfig, TimingConfig)
    jmot = jm.SineMotorController(jt) if kind == "sine" else jm.StepMotorController(jt, 0.3)
    tmot = tm.SineMotorController(tt) if kind == "sine" else tm.StepMotorController(tt, 0.3)
    for dx, dy in np.random.default_rng(3).integers(-60, 61, (25, 2)):
        jmot.register_move(int(dx), int(dy))
        tmot.register_move(int(dx), int(dy))
        for _ in range(tt.moving_frame_num):
            assert tmot.step() == jmot.step()
    with pytest.raises(ValueError):
        tm.StepMotorController(tt, 1.5)


def test_view_geometry_equals_jax():
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 50, 70), dtype=np.uint8)
    assert tv.clamp_position(-3, 80, (50, 70)) == jv.clamp_position(-3, 80, (50, 70))
    np.testing.assert_array_equal(tv.pad_world(frames[0], (7, 4)), jv.pad_world(frames[0], (7, 4)))
    assert tv.view_bbox((10, 12), (7, 4), 15, 9) == jv.view_bbox((10, 12), (7, 4), 15, 9)
    a = jv.ViewController(JaxArrayReader(frames), camera_size=(15, 9), micro_size=(5, 3), init_position=(1, 2))
    b = tv.ViewController(ArrayReader(frames), camera_size=(15, 9), micro_size=(5, 3), init_position=(1, 2))
    for dx, dy in rng.integers(-30, 31, (6, 2)):
        assert a.progress() and b.progress()
        a.move_position(int(dx), int(dy))
        b.move_position(int(dx), int(dy))
        assert b.position == a.position and b.camera_position == a.camera_position
        assert b.micro_position == a.micro_position
        np.testing.assert_array_equal(b.camera_view(), a.camera_view())
        np.testing.assert_array_equal(b.micro_view(), a.micro_view())
    with pytest.raises(ValueError):
        tv.ViewController(ArrayReader(frames), camera_size=(4, 4), micro_size=(5, 5))


# -- the host backend --------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_sim")
    make_worm_csv(str(root / "worm.csv"), num_frames=HOST_FRAMES, seed=21)
    jax_save_predictor(
        jax_make_predictor(JaxIOConfig([0, -3, -6], [3]), block_in_dim=16, block_dims=(8, 16), n_blocks=2, seed=1),
        str(root / "predictor.npz"),
    )
    return root


def _host_run(pkg: str, name: str, root) -> bytes:
    """One host-backend run: Simulator + LoggingController around the named
    controller, as both packages' ``simulate --backend host`` build it."""
    C, E, T, S, M = (jc, JaxExperimentConfig, JaxTimingConfig, JaxSimulator, jm) if pkg == "jax" else (
        tc, ExperimentConfig, TimingConfig, Simulator, tm)
    timing = _timing(E, T, num_frames=HOST_FRAMES)
    exp = E(**{**EXP_KWARGS, "num_frames": HOST_FRAMES})
    worm = str(root / "worm.csv")
    if name in ("csv", "csv_step"):
        inner = C.CsvController(timing, worm)
    elif name == "optimal":
        inner = C.OptimalController(timing, worm)
    elif name == "polyfit":
        inner = C.PolyfitController(timing, C.PolyfitConfig(**POLYFIT), worm)
    else:
        if pkg == "jax":
            from wtracker_tpu.models.resmlp import load_predictor as jax_load_predictor

            pred = jax_load_predictor(str(root / "predictor.npz"))
        else:
            pred = load_predictor(str(root / "predictor.npz"), device="cpu")
        inner = C.MLPController(timing, worm, pred)
    out = root / f"{pkg}_{name}"
    motor = M.StepMotorController(timing) if name == "csv_step" else None
    ctl = C.LoggingController(inner, C.LogConfig(root_folder=str(out), save_err_view=False))
    S(timing, exp, ctl, motor_controller=motor).run(progress=False)
    return (out / "bboxes.csv").read_bytes()


def _engine_text(name: str, root) -> str:
    timing = _timing(ExperimentConfig, TimingConfig, num_frames=HOST_FRAMES)
    exp = ExperimentConfig(**{**EXP_KWARGS, "num_frames": HOST_FRAMES})
    params = engine.EngineParams.from_timing(
        timing, engine.headless_frame_shape(timing, exp.orig_resolution), motor="step" if name == "csv_step" else "sine"
    )
    table = pd.read_csv(root / "worm.csv")[COLS].to_numpy(dtype=float)
    if name in ("csv", "csv_step"):
        ctl = engine.csv_controller(table, params, device="cpu")
    elif name == "optimal":
        ctl = engine.optimal_controller(table, params, device="cpu")
    elif name == "polyfit":
        cfg = tc.PolyfitConfig(**POLYFIT)
        ctl = engine.polyfit_controller(table, params, np.array(cfg.sample_times), np.array(cfg.weights), cfg.degree,
                                        device="cpu")
    else:
        pred = load_predictor(str(root / "predictor.npz"), device="cpu")
        ctl = engine.mlp_controller(table, params, pred, engine.mlp_max_dist_per_pred(timing, pred.io_config),
                                    device="cpu")
    logs = engine.run_engine(params, ctl, exp.init_position, params.n_logged_cycles(exp.num_frames), device="cpu")
    return engine.logs_to_frame(params, logs).to_csv(index=False)


def _jax_engine_polyfit_text(root) -> str:
    timing = _timing(JaxExperimentConfig, JaxTimingConfig, num_frames=HOST_FRAMES)
    params = je.EngineParams.from_timing(timing, je.headless_frame_shape(timing, EXP_KWARGS["orig_resolution"]))
    cfg = jc.PolyfitConfig(**POLYFIT)
    ctl = je.polyfit_controller(pd.read_csv(root / "worm.csv")[COLS].to_numpy(dtype=float), params,
                                np.array(cfg.sample_times), np.array(cfg.weights), cfg.degree)
    logs = je.run_engine(params, ctl, EXP_KWARGS["init_position"], params.n_logged_cycles(HOST_FRAMES))
    return je.logs_to_frame(params, logs).to_csv(index=False)


@pytest.mark.parametrize("name", ["csv", "csv_step", "optimal", "polyfit", "mlp"])
def test_host_backend_writes_the_jax_host_and_engine_text(files, name):
    got = _host_run("torch", name, files)
    assert got == _host_run("jax", name, files)
    text = got.decode()
    assert len(text.splitlines()) == 1 + (HOST_FRAMES - 1) // 8 * 8
    engine_text = _engine_text(name, files)
    if name != "polyfit":
        assert text.replace("\r\n", "\n") == engine_text
        return
    # Exact .5 ties.  The log's track is clipped to the arena's edge, so from
    # cycle 72 on some fits see a constant coordinate; the camera is 99 px
    # high, so the extrapolated offset is an exact .5, and the last bit of
    # the least squares decides the rounding.  numpy's SVD (the host), JAX's
    # jitted Jacobi (its engine, whose multiply-adds XLA contracts), JAX's
    # op-by-op Jacobi and the port's give four different values there (at
    # cycle 93: 50 + 3.0e-13, 50 - 3.6e-13, 50 - 6.7e-13, 50 + 1.0e-12): JAX's own host
    # and engine part from line 712, the port's engine and JAX's from line
    # 752, the port's engine and the host from line 583 (ROADMAP Queue 3).
    # Up to the first tie the three texts are one.
    host_lines, engine_lines = text.replace("\r\n", "\n").splitlines(), engine_text.splitlines()
    jax_lines = _jax_engine_polyfit_text(files).splitlines()
    assert host_lines[:FIRST_POLYFIT_TIE_LINE] == engine_lines[:FIRST_POLYFIT_TIE_LINE] == jax_lines[:FIRST_POLYFIT_TIE_LINE]
    assert engine_lines[:JAX_ENGINE_PARTS_LINE] == jax_lines[:JAX_ENGINE_PARTS_LINE]


def test_weight_evaluator_equals_jax(tmp_path):
    paths = []
    for i, n in enumerate((900, 1400)):
        paths.append(str(tmp_path / f"log{i}.csv"))
        make_worm_csv(paths[-1], num_frames=n, seed=30 + i, nan_every=23)
    offsets = np.array([-12, -8, -6, -4, -2, 0])
    jt, tt = _timing(JaxExperimentConfig, JaxTimingConfig), _timing(ExperimentConfig, TimingConfig)
    want = jc.WeightEvaluator(paths, jt, offsets, 12, min_speed=0.05, max_speed=5.0)
    got = tc.WeightEvaluator(paths, tt, offsets, 12, min_speed=0.05, max_speed=5.0, device="cpu")
    np.testing.assert_array_equal(got.y_input, want.y_input)
    np.testing.assert_array_equal(got.y_target, want.y_target)
    rng = np.random.default_rng(0)
    for deg in (1, 2):  # the controller's degrees (2: the commands' default)
        for weights in (np.ones(6), rng.uniform(0.1, 3.0, 6), np.array([0.0, 1.0, 2.0, 1.0, 0.5, 1.0])):
            g, w = got.eval(weights, deg=deg), want.eval(weights, deg=deg)
            assert isinstance(g, float)
            assert abs(g - w) <= 1e-12 * abs(w), (deg, weights, g, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            tc.WeightEvaluator(paths, tt, offsets, 12)  # entry points default to the card
        else:
            raise RuntimeError("CUDA present")
    assert pickle.loads(pickle.dumps(tc.PolyfitConfig(**POLYFIT))) == tc.PolyfitConfig(**POLYFIT)
