"""The port's ``simulate`` and ``sweep`` commands against the JAX engine.

Reference: what ``workflows/simulate.py`` (both backends) and
``workflows/sweep.py`` compute, run in-process (the JAX commands cannot
import their package as scripts): ``EngineParams.from_timing``, the
controller factories, ``run_engine`` / ``run_engine_streams`` /
``run_sweep_hetero`` and ``logs_to_frame``.  The port's commands run as
subprocesses (``python -m ...``, ``PYTHONPATH`` the repository root,
``--device cpu``) on the configs, worm tables, polyfit config and
predictor ``.npz`` the JAX package wrote; every ``bboxes.csv`` must be the
JAX text byte for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from tests.synthetic import EXP_KWARGS, TIMING_KWARGS, make_worm_csv
from tests.test_engine_hetero import EXPS, TIMING
from wtracker_tpu.models.resmlp import load_predictor as jax_load_predictor
from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_predictor
from wtracker_tpu.models.resmlp import save_predictor as jax_save_predictor
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim import engine as je
from wtracker_tpu.sim import engine_hetero as jh
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.controllers import MLPController, PolyfitConfig
from wtracker_tpu_torch.workflows import simulate, sweep

ROOT = Path(__file__).resolve().parent.parent
COLS = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]

SIMULATE_RUNS = {
    "csv": ["--controller", "csv"],
    "csv_step": ["--controller", "csv", "--motor", "step"],
    "optimal": ["--controller", "optimal"],
    "polyfit_default": ["--controller", "polyfit"],
    "polyfit_config": ["--controller", "polyfit", "--polyfit-config", "{polyfit}"],
    "mlp": ["--controller", "mlp", "--predictor", "{predictor}"],
}
# the simulate runs repeated with --backend host
HOST_RUNS = ["csv_step", "polyfit_config", "mlp"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    exp = JaxExperimentConfig(**EXP_KWARGS)
    exp.save_json(str(root / "exp.json"))
    JaxTimingConfig(experiment_config=exp, **TIMING_KWARGS).save_json(str(root / "timing.json"))
    make_worm_csv(str(root / "worm.csv"))
    PolyfitConfig(degree=1, sample_times=[3, -8, 0, -4], weights=[1.5, 0.5, 2.0, 1.0]).save_json(str(root / "polyfit.json"))
    jax_save_predictor(
        jax_make_predictor(JaxIOConfig([0, -3, -6], [3]), block_in_dim=16, block_dims=(8, 16), n_blocks=2, seed=1),
        str(root / "predictor.npz"),
    )
    sweep_exps = []
    for i, e in enumerate(EXPS):
        sweep_exps.append(str(root / f"sweep_exp{i}.json"))
        JaxExperimentConfig(**e).save_json(sweep_exps[-1])
        make_worm_csv(str(root / f"sweep_worm{i}.csv"), num_frames=e["num_frames"], seed=11 + i)
    JaxTimingConfig(experiment_config=JaxExperimentConfig(**EXPS[0]), **TIMING).save_json(str(root / "sweep_timing.json"))
    return root, sweep_exps


def _run_all(cmds: dict) -> dict:
    """Start every command at once, then wait for each."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{k} exited {p.returncode}:\n{stderr[-3000:]}"
        out[k] = stdout
    return out


@pytest.fixture(scope="module")
def ran(files):
    root, sweep_exps = files
    common = ["--timing-config", str(root / "timing.json"), "--exp-config", str(root / "exp.json"),
              "--worm-csv", str(root / "worm.csv"), "--device", "cpu"]
    cmds = {
        name: [sys.executable, "-m", "wtracker_tpu_torch.workflows.simulate", *common, "--output", str(root / name),
               *(a.format(polyfit=root / "polyfit.json", predictor=root / "predictor.npz") for a in extra)]
        for name, extra in SIMULATE_RUNS.items()
    }
    worms = [str(root / f"sweep_worm{i}.csv") for i in range(len(EXPS))]
    sweep_cmd = [sys.executable, "-m", "wtracker_tpu_torch.workflows.sweep", "--worm-csvs", *worms, "--device", "cpu"]
    cmds.update({
        f"host_{name}": [sys.executable, "-m", "wtracker_tpu_torch.workflows.simulate", *common, "--backend", "host",
                         "--output", str(root / f"host_{name}"),
                         *(a.format(polyfit=root / "polyfit.json", predictor=root / "predictor.npz") for a in extra)]
        for name, extra in SIMULATE_RUNS.items() if name in HOST_RUNS
    })
    cmds["sweep_mixed"] = [*sweep_cmd, "--exp-configs", *sweep_exps, "--timing-configs",
                           *[str(root / "sweep_timing.json")] * len(EXPS), "--output", str(root / "sweep_mixed")]
    cmds["sweep_homogeneous"] = [*sweep_cmd, "--timing-config", str(root / "timing.json"), "--frame-shape", "608", "698",
                                 "--init-position", "300", "250", "--output", str(root / "sweep_homogeneous")]
    return _run_all(cmds)


def _jax_simulate(root: Path, name: str) -> str:
    """What the JAX simulate command writes with --backend engine."""
    timing = JaxTimingConfig.load_json(str(root / "timing.json"))
    exp = JaxExperimentConfig.load_json(str(root / "exp.json"))
    motor = "step" if name == "csv_step" else "sine"
    params = je.EngineParams.from_timing(timing, je.headless_frame_shape(timing, exp.orig_resolution), motor=motor)
    csv_data = pd.read_csv(root / "worm.csv")[COLS].to_numpy(dtype=float)
    if name.startswith("csv"):
        ctl = je.csv_controller(csv_data, params)
    elif name == "optimal":
        ctl = je.optimal_controller(csv_data, params)
    elif name.startswith("polyfit"):
        cfg = PolyfitConfig.load_json(str(root / "polyfit.json")) if name == "polyfit_config" else PolyfitConfig(
            degree=2, sample_times=[-15, -10, -5, 0, 3]
        )
        ctl = je.polyfit_controller(csv_data, params, np.array(cfg.sample_times), np.array(cfg.weights), cfg.degree)
    else:
        pred = jax_load_predictor(str(root / "predictor.npz"))
        ctl = je.mlp_controller(csv_data, params, pred, MLPController(timing, str(root / "worm.csv"), pred).max_dist_per_pred)
    logs = je.run_engine(params, ctl, exp.init_position, params.n_logged_cycles(exp.num_frames))
    return je.logs_to_frame(params, logs).to_csv(index=False)


@pytest.mark.parametrize("name", list(SIMULATE_RUNS))
def test_simulate_writes_the_jax_engine_csv(name, files, ran):
    root, _ = files
    assert f"{root / name}/bboxes.csv" in ran[name]
    got = (root / name / "bboxes.csv").read_text()
    assert got == _jax_simulate(root, name)
    assert len(got.splitlines()) == 1 + 59 * 8  # 59 cycles of 8 frames


def _jax_host(root: Path, name: str) -> str:
    """What the JAX simulate command writes with --backend host, in-process:
    its ``Simulator`` with the logging wrapper."""
    from wtracker_tpu.sim import controllers as jc
    from wtracker_tpu.sim.motor import StepMotorController
    from wtracker_tpu.sim.simulator import Simulator

    timing = JaxTimingConfig.load_json(str(root / "timing.json"))
    exp = JaxExperimentConfig.load_json(str(root / "exp.json"))
    worm = str(root / "worm.csv")
    if name.startswith("csv"):
        inner = jc.CsvController(timing, worm)
    elif name == "polyfit_config":
        inner = jc.PolyfitController(timing, PolyfitConfig.load_json(str(root / "polyfit.json")), worm)
    else:
        inner = jc.MLPController(timing, worm, jax_load_predictor(str(root / "predictor.npz")))
    out = root / f"jax_host_{name}"
    motor = StepMotorController(timing) if name == "csv_step" else None
    ctl = jc.LoggingController(inner, jc.LogConfig(root_folder=str(out), save_err_view=False))
    Simulator(timing, exp, ctl, motor_controller=motor).run(progress=False)
    return (out / "bboxes.csv").read_bytes().decode()


@pytest.mark.parametrize("name", HOST_RUNS)
def test_simulate_host_backend_writes_the_jax_host_csv(name, files, ran):
    """``--backend host``: the JAX host backend's bytes (``\\r\\n`` line ends,
    the csv module's), and the same rows as the engine's text."""
    root, _ = files
    assert f"wrote {root / f'host_{name}'}/bboxes.csv" in ran[f"host_{name}"]
    got = (root / f"host_{name}" / "bboxes.csv").read_bytes().decode()
    assert got == _jax_host(root, name)
    assert got.replace("\r\n", "\n") == (root / name / "bboxes.csv").read_text()


def test_sweep_mixed_writes_the_jax_sweep_csvs(files, ran):
    root, sweep_exps = files
    exps = [JaxExperimentConfig.load_json(p) for p in sweep_exps]
    base = JaxTimingConfig.load_json(str(root / "sweep_timing.json"))
    timings = [
        JaxTimingConfig(experiment_config=e, imaging_time_ms=base.imaging_time_ms, pred_time_ms=base.pred_time_ms,
                        moving_time_ms=base.moving_time_ms, camera_size_mm=base.camera_size_mm, micro_size_mm=base.micro_size_mm)
        for e in exps
    ]
    params, geometry = jh.geometry_from_configs(timings, exps)
    tables = [pd.read_csv(root / f"sweep_worm{i}.csv")[COLS].to_numpy(dtype=float) for i in range(len(exps))]
    want = jh.run_sweep_hetero(params, geometry, jh.csv_controller_hetero(jh.pad_worm_tables(tables), params, geometry),
                               np.asarray([e.init_position for e in exps]))
    for i in range(len(exps)):
        assert (root / "sweep_mixed" / f"exp{i}" / "bboxes.csv").read_text() == want[i].to_csv(index=False), f"exp{i}"
    assert "swept 2 experiments" in ran["sweep_mixed"]


def test_sweep_homogeneous_writes_the_jax_stream_csvs(files, ran):
    root, _ = files
    timing = JaxTimingConfig.load_json(str(root / "timing.json"))
    params = je.EngineParams.from_timing(timing, (608, 698))
    tables = [pd.read_csv(root / f"sweep_worm{i}.csv")[COLS].to_numpy(dtype=float) for i in range(len(EXPS))]
    csvs = jh.pad_worm_tables(tables)
    logs = je.run_engine_streams(params, je.csv_controller_streams(csvs, params), np.tile([300, 250], (len(tables), 1)),
                                 params.n_logged_cycles(csvs.shape[1]), batched_controller=True)
    for i in range(len(tables)):
        want = je.logs_to_frame(params, je.CycleLog(logs.positions[:, i], logs.worm_bboxes[:, i])).to_csv(index=False)
        assert (root / "sweep_homogeneous" / f"exp{i}" / "bboxes.csv").read_text() == want, f"exp{i}"


def test_unported_options_raise(files, tmp_path):
    root, sweep_exps = files
    common = ["--timing-config", str(root / "timing.json"), "--exp-config", str(root / "exp.json"),
              "--worm-csv", str(root / "worm.csv"), "--output", str(tmp_path / "out"), "--device", "cpu"]
    for backend in ("engine", "host"):  # predictor .pt files still refuse, on both backends
        with pytest.raises(NotImplementedError, match="Queue 3"):
            simulate.main([*common, "--backend", backend, "--controller", "mlp", "--predictor", str(tmp_path / "p.pt")])
    with pytest.raises(SystemExit):
        simulate.main([*common, "--controller", "mlp"])  # no predictor
    with pytest.raises(NotImplementedError, match="item 8"):
        sweep.main(["--worm-csvs", str(root / "worm.csv"), "--exp-configs", sweep_exps[0], "--timing-config",
                    str(root / "timing.json"), "--output", str(tmp_path / "sweep"), "--mesh", "--device", "cpu"])
    assert not (tmp_path / "out").exists() and not (tmp_path / "sweep").exists()
