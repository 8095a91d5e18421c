"""The port's configs and motor profile against the JAX package's.

References: ``wtracker_tpu/sim/config.py`` (``ExperimentConfig``,
``TimingConfig``), ``wtracker_tpu/neural/config.py`` (``IOConfig``) and
``wtracker_tpu/sim/motor.py`` (``sine_step_weights``).  Derived fields, the
persisted JSON text and the motor weights must be equal, not close.
"""

import numpy as np
import pytest

from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.motor import sine_step_weights as jax_sine_step_weights
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.motor import sine_step_weights

# (experiment args, timing kwargs): the repo's deployment config, the test
# suite's small one, and a frame rate whose ms->frame quantization rounds up
CASES = [
    (
        ("example", 61200, 60, (1430, 1671), 90, (800, 700)),
        dict(imaging_time_ms=200.0, pred_time_ms=40.0, moving_time_ms=50.0,
             camera_size_mm=(4.0, 4.0), micro_size_mm=(0.32, 0.32)),
    ),
    (
        ("synt", 480, 60, (500, 600), 90, (300, 250)),
        dict(imaging_time_ms=75.0, pred_time_ms=30.0, moving_time_ms=50.0,
             camera_size_mm=(1.2, 1.1), micro_size_mm=(0.25, 0.25)),
    ),
    (
        ("odd", 1000, 24.5, (700, 900), 77.7, (450, 350)),
        dict(imaging_time_ms=101.0, pred_time_ms=0.5, moving_time_ms=333.3,
             camera_size_mm=(2.5, 3.3), micro_size_mm=(0.1, 0.7)),
    ),
]


def _pair(exp_args, timing_kw):
    jexp, texp = JaxExperimentConfig(*exp_args), ExperimentConfig(*exp_args)
    jt = JaxTimingConfig(experiment_config=JaxExperimentConfig(*exp_args), **timing_kw)
    tt = TimingConfig(experiment_config=ExperimentConfig(*exp_args), **timing_kw)
    return (jexp, texp), (jt, tt)


@pytest.mark.parametrize("exp_args, timing_kw", CASES, ids=[c[0][0] for c in CASES])
def test_derived_fields_equal(exp_args, timing_kw):
    (jexp, texp), (jt, tt) = _pair(exp_args, timing_kw)
    assert vars(texp) == vars(jexp)
    assert vars(tt) == vars(jt)
    assert tt.cycle_frame_num == jt.cycle_frame_num
    assert tt.cycle_time_ms == jt.cycle_time_ms
    assert not hasattr(tt, "experiment_config")


@pytest.mark.parametrize("exp_args, timing_kw", CASES, ids=[c[0][0] for c in CASES])
def test_save_json_text_equal(tmp_path, exp_args, timing_kw):
    (jexp, texp), (jt, tt) = _pair(exp_args, timing_kw)
    for name, j, t in (("exp", jexp, texp), ("timing", jt, tt)):
        j.save_json(str(tmp_path / f"jax_{name}.json"))
        t.save_json(str(tmp_path / f"torch_{name}.json"))
        text = (tmp_path / f"torch_{name}.json").read_text()
        assert text == (tmp_path / f"jax_{name}.json").read_text()
        # load_json keeps the stored derived fields verbatim
        back = type(t).load_json(str(tmp_path / f"torch_{name}.json"))
        assert vars(back) == vars(type(j).load_json(str(tmp_path / f"jax_{name}.json")))


def test_repo_timing_config_loads_like_jax():
    """The committed deployment timing: 12 imaging + 3 moving frames, a
    360 px camera (the video loop's main-path geometry)."""
    t = TimingConfig.load_json("configs/timing_config.json")
    j = JaxTimingConfig.load_json("configs/timing_config.json")
    assert vars(t) == vars(j)
    assert (t.imaging_frame_num, t.moving_frame_num, tuple(t.camera_size_px)) == (12, 3, (360, 360))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17])
def test_sine_step_weights_equal(n):
    got = sine_step_weights(n)
    want = np.asarray(jax_sine_step_weights(n))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [[0, -3, -6, -9, -12], [0, -2, -4], [-1, -5]])
def test_io_config_equal(tmp_path, frames, capsys):
    t, j = IOConfig(frames, [3]), JaxIOConfig(frames, [3])
    assert vars(t) == vars(j)
    t.save_json(str(tmp_path / "t.json"))
    j.save_json(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    out = capsys.readouterr().out
    # both warn on stdout, once each, when the prediction frame is missing
    assert out.count("WARNING::IOConfig::") == (0 if 0 in frames else 2)
