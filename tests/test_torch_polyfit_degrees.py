"""The float64 ``polyfit`` at every degree and sample count: deg >= 8 and
N·(deg + 1) beyond the kernel's register form, which K3's general form takes.

Reference: ``wtracker_tpu/ops/polyfit.py::polyfit`` at deg 8, run op by op
(``jax.disable_jit()``; jitting its 432-rotation Jacobi takes over a
minute).  XLA:CPU's rotation rounds its ``rsqrt`` through an estimate and
Newton steps, not correctly, and at deg 8 over 11 samples the scaled normal
matrix's condition number is 1e11-1e12, so the two Jacobis land up to
4.5e-8 of the largest coefficient apart (1.4e-10-4.5e-8 over eight seeded
weightings), each 3e-9-3.6e-7 from the exact least-squares solution.  So
the full-rank case holds the port to JAX within 1e-7 of the largest
coefficient and, against the exact solution (60 digits, ``mpmath``), to at
most twice JAX's own error (1.11x at most over the eight); the
rank-deficient case (the swarm's 8 times) within 1e-8 (3e-12-1.1e-11
measured over three seeded weightings).  At deg <= 5 ``tests/test_torch_polyfit_kernel.py`` holds 1e-10.  On the CPU the
dispatching ``polyfit`` is the plain version bit for bit; the card's side
(K3's general form against the plain version, 0 differing bits) is
``tests/test_torch_kernels_cuda.py``.  Also: ``plan`` in the general form,
and the ``polyfit_optimizer`` command at ``--degree 8``.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mpmath

from tests.synthetic import make_worm_csv
from tests.test_torch_polyfit_kernel import PLAN_M, PLAN_P, SWARM_TIMES, _covered

jp = importlib.import_module("wtracker_tpu.ops.polyfit")  # the package's ``polyfit`` name is the function
tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")  # so is the port's

ROOT = Path(__file__).resolve().parent.parent
WIDE_TIMES = np.arange(-40.0, 1.0, 4.0)  # 11 samples: full rank at deg 8
LONG_TIMES = np.arange(-60.0, 1.0, 4.0)  # 16 samples: full rank up to deg 15


def _case(x: np.ndarray, deg: int, m: int = 2, p: int = 0, seed: int = 0):
    """Seeded (x, y, w): a track with noise at times ``x``, one weighting
    (``p`` = 0) or ``p`` of them."""
    rng = np.random.default_rng([deg, len(x), m, p, seed])
    y = 150 + 2.5 * x[:, None] + 0.01 * x[:, None] ** 2 + rng.normal(0, 0.5, (len(x), m))
    w = rng.uniform(0.2, 2.0, (p, len(x)) if p else len(x))
    return x, y, w


def _exact(x: np.ndarray, y: np.ndarray, deg: int, w: np.ndarray) -> np.ndarray:
    """The weighted least-squares coefficients of a full-rank system,
    solved in 60 digits."""
    with mpmath.workdps(60):
        a = mpmath.matrix([[mpmath.mpf(wi) * mpmath.mpf(xi) ** j for j in range(deg + 1)] for xi, wi in zip(x, w)])
        cols = [mpmath.lu_solve(a.T * a, a.T * mpmath.matrix([mpmath.mpf(wi) * mpmath.mpf(v) for v, wi in zip(col, w)]))
                for col in y.T]
        return np.array([[float(c[j]) for c in cols] for j in range(deg + 1)])


@pytest.mark.parametrize("x", [WIDE_TIMES, SWARM_TIMES], ids=["full_rank_n11", "rank_deficient_n8"])
def test_plain_version_matches_jax_at_deg_8(x):
    """deg 8 (K = 9): 11 samples, and the swarm's 8 (fewer samples than
    terms: the min-norm solution).  Tolerances in the module's docstring."""
    x, y, w = _case(x, 8)
    got = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y), 8, torch.from_numpy(w)).numpy()
    with jax.disable_jit():
        want = np.asarray(jp.polyfit(jnp.asarray(x), jnp.asarray(y), 8, jnp.asarray(w)))
    assert got.shape == want.shape == (9, 2)
    scale = np.abs(want).max()
    if len(x) < 9:
        assert np.abs(got - want).max() <= 1e-8 * scale
        return
    assert np.abs(got - want).max() <= 1e-7 * scale
    exact = _exact(x, y, 8, w)
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max()


@pytest.mark.parametrize("deg, n", [(8, 11), (9, 11), (12, 16), (15, 16), (2, 20_000)])
def test_dispatch_equals_plain_version(deg, n):
    """The degrees and the sample count the register form refused: deg 8,
    9, 12 and 15, and deg 2 over 20,000 samples (N·k = 60,000)."""
    x = (LONG_TIMES if n == 16 else WIDE_TIMES) if n <= 16 else np.arange(n, dtype=np.float64) - n // 2
    x, y, w = _case(x, deg, p=3 if n <= 16 else 0)
    if n <= 16:
        w[2, 4:] = 0.0  # a rank-deficient weighting beside two full ones
    before = tp.polyfit.launches
    args = (torch.from_numpy(x), torch.from_numpy(y), deg, torch.from_numpy(w))
    got = tp.polyfit(*args).numpy()
    plain = tp.polyfit_reference(*args).numpy()
    assert tp.polyfit.launches == before  # the CPU runs the plain version
    assert got.shape == plain.shape == w.shape[:-1] + (deg + 1, 2)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.int64), plain.view(np.int64))


def test_the_kernels_entry_never_runs_the_plain_version_on_the_cpu():
    """The entry that forces the general form raises for a tensor off the
    card, as ``polyfit`` does for a device without a kernel; neither
    launches."""
    x, y, w = (torch.from_numpy(a) for a in _case(WIDE_TIMES, 8))
    before = tp.polyfit.launches
    for workspace in (None, False, True):
        with pytest.raises(ValueError, match="no kernel"):
            tp._polyfit_kernel(x, y, 8, w, workspace=workspace)
    assert tp.polyfit.launches == before


# -- the general form's launch plan, pure Python ---------------------------------


@pytest.mark.parametrize("n, k", [(11, k) for k in range(9, 17)] + [(40, 33), (684, 9), (2049, 3), (20_000, 3),
                                                                     (6145, 1), (11, 80), (5_000, 40)])
def test_plan_places_every_weighting_and_column_once(n, k):
    """K = 9-16 (the wave form) and 33, N beyond the register form's 6,144 /
    K, and K whose arrays leave shared memory for the workspace (the general
    form): every (weighting, column) once, a block's shared memory within
    what an SM holds for ``per_sm`` of them, one wave where the columns
    allow."""
    rng = np.random.default_rng(k * 100_000 + n)
    rows = 8 * n * (k + 1) if 8 * n * (k + 1) <= tp.KERNEL_GENERAL_ROWS else 0
    wave = k <= tp.KERNEL_WAVE_MAX_K
    fixed = tp.wave_static(k) if wave else 8 * tp.general_fixed(k)
    table = 2 * tp.wave_table(k).size if wave else 0
    pairs = [(p, m) for p in PLAN_P[::2] for m in PLAN_M[::2]] + list(zip(rng.integers(1, 1001, 20),
                                                                       rng.integers(1, 10_001, 20)))
    for p, m in pairs:
        grid = tp.plan(int(p), n, k, int(m), 132)
        assert grid.form == ("wave" if wave else "general") and grid.blocks == p * grid.tiles and grid.tile >= 1
        assert (_covered(int(p), int(m), grid) == 1).all(), (p, m)
        in_shared = wave or rows + fixed <= tp.BLOCK_SHARED
        held = 8 * k * grid.hold if wave else 0
        sums = 8 * k * tp.KERNEL_THREADS if wave and not rows else 0  # each thread's sums where the rows do not fit
        assert grid.shared == rows + sums + table + held + (fixed if in_shared and not wave else 0) <= tp.BLOCK_SHARED
        assert grid.hold <= grid.tile and (wave or grid.hold == 0)
        assert grid.workspace == (0 if in_shared else grid.blocks * fixed), (p, m)
        assert 1 <= grid.per_sm <= (tp.KERNEL_WAVE_MIN_BLOCKS[k] if wave else tp.KERNEL_GENERAL_MIN_BLOCKS)
        assert grid.per_sm * (grid.shared + (fixed if wave else 0) + tp.BLOCK_RESERVED) <= tp.SM_SHARED, (p, m)
        threads = tp.KERNEL_WAVE_COL_THREADS if wave else tp.KERNEL_THREADS
        if p * -(-m // threads) <= 132 * grid.per_sm:  # a wave at a column a thread or more
            assert grid.blocks <= 132 * grid.per_sm, (p, m)
    if k <= 33:
        assert tp.plan(1, n, k, 2, 132).workspace == 0  # K = 33's matrices still fit a block
    forced = tp.plan(100, n, k, 6170, 132, workspace=True)
    general_rows = 8 * n * (k + 1) if 8 * n * (k + 1) <= tp.KERNEL_GENERAL_ROWS else 0
    assert forced.form == "general" and forced.shared == general_rows
    assert forced.workspace == forced.blocks * 8 * tp.general_fixed(k)


def test_plan_of_the_swarm_at_deg_8_is_one_wave():
    """The swarm's batch at deg 8 (P=100 weightings of 11 samples, M=6,170)
    fills one wave at 4 blocks an SM in the wave form."""
    grid = tp.plan(100, 11, 9, 6170, 132)
    assert (grid.form, grid.per_sm, grid.workspace) == ("wave", 4, 0)
    assert 132 * 4 // 2 < grid.blocks <= 132 * 4
    assert tp.plan(1, 11, 9, 2, 132).blocks == 1  # the replay's fit: one block


def test_polyfit_optimizer_command_at_deg_8(tmp_path):
    """``polyfit_optimizer --degree 8`` runs the swarm through the deg-8 fit
    and writes a ``PolyfitConfig`` of degree 8 (on the card its default
    device launches K3's general form: ``chip_smoke.py`` phase 41)."""
    log = str(tmp_path / "log.csv")
    make_worm_csv(log, num_frames=1200, seed=21, nan_every=0)
    out = tmp_path / "deg8.json"
    args = ["--timing-config", str(ROOT / "configs" / "timing_config.json"), "--logs", log, "--output", str(out),
            "--degree", "8", "--pop", "4", "--epochs", "2", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "wtracker_tpu_torch.workflows.polyfit_optimizer", *args], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cfg = json.loads(out.read_text())
    assert cfg["degree"] == 8 and cfg["sample_times"] == [-30, -25, -20, -15, -10, -5, 0, 3]
    assert len(cfg["weights"]) == 8 and np.isfinite(cfg["weights"]).all()


def test_chip_smokes_ptxas_report_reads_every_form():
    """``chip_smoke.py::k3_ptxas`` reads each K3 kernel of ``nvcc -Xptxas
    -v``'s report: a register-form and a wave-form instantiation of any K
    (two digits too) and the general form, whose line has no static shared
    memory."""
    from chip_smoke import k3_ptxas

    name = "_ZN47_GLOBAL__N__acf5827d_14_polyfit_f64_cu_8bcedaec"
    report = "\n".join([
        f"ptxas info    : Function properties for {name}14polyfit_kernelILi3EEEvPKdS2_S2_Pdiiiid",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 192 bytes smem",
        f"ptxas info    : Function properties for {name}12polyfit_waveILi12EEEvPKdS2_S2_PdiiiidPKtii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 15176 bytes smem",
        f"ptxas info    : Function properties for {name}12polyfit_waveILi9EEEvPKdS2_S2_PdiiiidPKtii",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 8360 bytes smem",
        f"ptxas info    : Function properties for {name}14polyfit_kernelILi12EEEvPKdS2_S2_Pdiiiid",
        "    8 bytes stack frame, 696 bytes spill stores, 724 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 2400 bytes smem",
        f"ptxas info    : Function properties for {name}15polyfit_generalEPKdS1_S1_PdiiiiidS2_",
        "    48 bytes stack frame, 36 bytes spill stores, 60 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 48 bytes cumulative stack size",
    ])
    assert k3_ptxas(report) == [
        {"form": "register", "k": 3, "spill_stores": 0, "spill_loads": 0, "registers": 64, "static_smem_bytes": 192},
        {"form": "register", "k": 12, "spill_stores": 696, "spill_loads": 724, "registers": 255,
         "static_smem_bytes": 2400},
        {"form": "wave", "k": 9, "spill_stores": 4, "spill_loads": 4, "registers": 64, "static_smem_bytes": 8360},
        {"form": "wave", "k": 12, "spill_stores": 0, "spill_loads": 0, "registers": 80, "static_smem_bytes": 15176},
        {"form": "general", "k": None, "spill_stores": 36, "spill_loads": 60, "registers": 64, "static_smem_bytes": 0},
    ]
