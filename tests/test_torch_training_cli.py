"""The port's three training commands against the JAX package's scripts.

Reference: ``workflows/polyfit_optimizer.py``, ``predictor_training.py``
and ``yolo_training.py``, whose ``main()`` runs in-process with a patched
``sys.argv`` (the scripts cannot import the package as subprocesses here:
ROADMAP Queue 3).  The port's commands run as subprocesses with
``PYTHONPATH`` set and ``--device cpu``.

* ``polyfit_optimizer`` (pop 8, 20 epochs): the ``PolyfitConfig`` JSON's
  weights within rtol 1e-6.
* ``predictor_training`` (2 epochs): the written ``.npz`` against JAX's.
  It runs in float32 as the command does, from each package's own fresh
  init (the port's is Flax's init to 2.4e-7), so it carries XLA:CPU's
  float32 BatchNorm-sum error (``tests/test_torch_yolo_training.py``) and
  Adam's sensitivity to gradients that cancel to near zero; the weights are
  held to the tolerances stated at the test.  ``yolo_training`` is in
  ``tests/test_torch_yolo_training_cli.py``.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tests.synthetic import make_worm_csv

ROOT = Path(__file__).resolve().parent.parent


def _jax_main(name: str, argv: list[str], monkeypatch) -> None:
    spec = importlib.util.spec_from_file_location(f"jax_workflow_{name}", ROOT / "workflows" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    monkeypatch.undo()


def _port(name: str, argv: list[str]) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", f"wtracker_tpu_torch.workflows.{name}", *argv, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_polyfit_optimizer_cli(tmp_path, monkeypatch):
    log = str(tmp_path / "log.csv")
    make_worm_csv(log, num_frames=2400, seed=21, nan_every=0)
    timing = str(ROOT / "configs" / "timing_config.json")  # 360 px: an even camera
    args = ["--timing-config", timing, "--logs", log, "--pop", "8", "--epochs", "20", "--seed", "3"]
    _jax_main("polyfit_optimizer", [*args, "--output", str(tmp_path / "jax.json")], monkeypatch)
    _port("polyfit_optimizer", [*args, "--output", str(tmp_path / "port.json")])
    want, got = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert got["degree"] == want["degree"] and got["sample_times"] == want["sample_times"]
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=1e-6)


def _npz(path) -> dict:
    with np.load(path, allow_pickle=True) as data:
        return {k: data[k] for k in data.files}


def _assert_npz_close(got_path, want_path, rtol, atol, free=(), free_bound=0.0):
    """Every array of the two ``.npz`` files at ``rtol``/``atol``, except
    the keys ending in one of ``free``, held to ``free_bound``."""
    got, want = _npz(got_path), _npz(want_path)
    assert set(got) == set(want)
    assert got["__meta__"].item() == want["__meta__"].item()
    for k in want:
        if k == "__meta__":
            continue
        if k.endswith(free):
            assert np.abs(got[k] - want[k]).max() <= free_bound, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_predictor_training_cli(tmp_path, monkeypatch):
    log = str(tmp_path / "log.csv")
    make_worm_csv(log, num_frames=1500, seed=11, nan_every=41)
    args = ["--logs", log, "--epochs", "2", "--batch", "128"]
    _jax_main("predictor_training", [*args, "--output", str(tmp_path / "jax.npz")], monkeypatch)
    _port("predictor_training", [*args, "--output", str(tmp_path / "port.npz")])
    # A Dense bias that feeds a BatchNorm has no effect on the output, so its
    # gradient is rounding noise that Adam turns into steps of up to lr:
    # those biases, and the running means that carry them, are held to
    # 2·lr a step (2 epochs of 8 steps); the predictions, which they cancel
    # out of, agree.
    pre_bn = tuple(f"{p}/{leaf}" for p in [*(f"layer_{j}" for j in range(4)), "input"] for leaf in ("dense/bias", "bn/mean"))
    _assert_npz_close(tmp_path / "port.npz", tmp_path / "jax.npz", rtol=1e-4, atol=PREDICTOR_ATOL,
                      free=pre_bn, free_bound=2 * 1e-3 * 16)
    from wtracker_tpu_torch.models.resmlp import load_predictor
    from wtracker_tpu_torch.neural.config import DatasetConfig
    from wtracker_tpu_torch.neural.dataset import NumpyDataset

    X = torch.from_numpy(NumpyDataset.create_from_config(DatasetConfig(INPUT_FRAMES, PRED_FRAMES, log)).X)
    got, want = (load_predictor(str(tmp_path / f), device="cpu")(X).numpy() for f in ("port.npz", "jax.npz"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=PREDICTION_ATOL)


# float32 on both sides (module docstring): half an Adam step at lr 1e-3
PREDICTOR_ATOL = 5e-4
PREDICTION_ATOL = 5e-2  # px; measured 0.032 px, from the free biases above
INPUT_FRAMES = [0, -3, -6, -9, -12, -15, -18, -21, -24, -27, -30, -33, -36, -39, -42, -45]  # the command's defaults
PRED_FRAMES = [3, 6, 9, 12]
