"""The dispatching float64 ``polyfit`` (kernel K3 on the card, its plain
version on the CPU) against the plain version and the JAX package.

Reference: ``wtracker_tpu/ops/polyfit.py::polyfit``, run op by op
(``jax.disable_jit()``: jitting its unrolled Jacobi takes 1.5-25 s a degree
and shape), on seeded numpy inputs.  On the CPU ``polyfit`` must be ``polyfit_reference`` bit for
bit and launch nothing; against JAX the coefficients agree within 1e-10
relative to the largest (XLA:CPU's rotation rounds its ``rsqrt`` through an
estimate and Newton steps, not correctly, so the last bits differ).  The
card's side (K3 against the plain version, 0 differing bits) is
``tests/test_torch_kernels_cuda.py``.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jp = importlib.import_module("wtracker_tpu.ops.polyfit")  # the package's ``polyfit`` name is the function
tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")  # so is the port's

ENGINE_TIMES = np.array([-15.0, -10.0, -5.0, 0.0, 3.0])  # the simulate command's default polyfit sample times
SWARM_TIMES = np.array([-30.0, -25.0, -20.0, -15.0, -10.0, -5.0, 0.0, 3.0])  # polyfit_optimizer's


def _case(name: str, deg: int):
    """(x, y, w) of a named case, seeded by its name and degree."""
    rng = np.random.default_rng([deg, sum(map(ord, name))])
    x = SWARM_TIMES if deg >= 3 else ENGINE_TIMES
    track = np.stack([150 + 2.5 * x + 0.1 * x**2, 170 - 1.5 * x], axis=1)
    y = track + rng.normal(0, 0.5, (len(x), 2))
    w = rng.uniform(0.2, 2.0, len(x))
    if name == "y_1d":
        y = y[:, 0]
    elif name == "w_batched":
        w = rng.uniform(0.0, 1.0, (3, len(x)))
        w[2, : len(x) // 2] = 0.0  # one weighting drops half the samples
    elif name == "zero_weights":
        w[[1, 3]] = 0.0
    elif name == "all_masked":  # the engine's cycle with no valid sample: weights and samples zeroed
        w[:] = 0.0
        y[:] = 0.0
        y[::2] = -0.0
    elif name == "rank_deficient":  # two samples left for deg + 1 unknowns: the min-norm solution
        w[2:] = 0.0
    return x, y, w


def _jax_fit(x, y, deg, w=None):
    """JAX's coefficients op by op, a weighting at a time for a (P, N) ``w``."""
    if w is not None and w.ndim == 2:
        return np.stack([_jax_fit(x, y, deg, row) for row in w])
    with jax.disable_jit():
        return np.asarray(jp.polyfit(jnp.asarray(x), jnp.asarray(y), deg, None if w is None else jnp.asarray(w)))


CASES = ["y_2d", "y_1d", "w_batched", "zero_weights", "all_masked", "rank_deficient"]
# JAX's op-by-op fit takes 0.3-2.7 s at degrees 1-5: every degree on one
# case, every case at the engine's degree
JAX_CASES = [("y_2d", deg) for deg in (1, 2, 3, 4, 5)] + [(name, 2) for name in CASES[1:]]


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", CASES)
def test_dispatch_equals_plain_version(name, deg):
    x, y, w = _case(name, deg)
    before = tp.polyfit.launches
    args = (torch.from_numpy(x), torch.from_numpy(y), deg, torch.from_numpy(w))
    got = tp.polyfit(*args).numpy()
    plain = tp.polyfit_reference(*args).numpy()
    assert tp.polyfit.launches == before  # the CPU runs the plain version, not the kernel
    assert got.shape == plain.shape == w.shape[:-1] + (deg + 1,) + y.shape[1:]
    np.testing.assert_array_equal(got.view(np.int64), plain.view(np.int64))  # every bit, signed zeros too


@pytest.mark.parametrize("name, deg", JAX_CASES)
def test_dispatch_matches_jax(name, deg):
    x, y, w = _case(name, deg)
    got = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y), deg, torch.from_numpy(w)).numpy()
    want = _jax_fit(x, y, deg, w)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if name == "all_masked":
        assert scale == 0 and not np.abs(got).any()
    else:
        assert np.abs(got - want).max() <= 1e-10 * scale


def test_unweighted_fit_equals_unit_weights_bit_for_bit():
    """The kernel fits ``w=None`` as unit weights; in the plain version the
    two give the same bits (a product with 1.0 is exact)."""
    x, y, _ = _case("y_2d", 2)
    none = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y), 2).numpy()
    ones = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y), 2, torch.ones(len(x), dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(none.view(np.int64), ones.view(np.int64))
    want = _jax_fit(x, y, 2)
    assert np.abs(none - want).max() <= 1e-10 * np.abs(want).max()


def test_engine_cycle_fits_equal_jax():
    """The engine controller's fit (N=5 times, deg 2, M=2) over seeded
    cycles with one, three and five valid samples."""
    rng = np.random.default_rng(11)
    for valid in (1, 3, 5):
        mask = np.zeros(5, bool)
        mask[rng.choice(5, valid, replace=False)] = True
        y = np.where(mask[:, None], 180 + rng.normal(0, 3, (5, 2)).round(1), 0.0)
        w = np.where(mask, 1.0, 0.0)
        got = tp.polyfit(torch.from_numpy(ENGINE_TIMES), torch.from_numpy(y), 2, torch.from_numpy(w)).numpy()
        want = _jax_fit(ENGINE_TIMES, y, 2, w)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), valid


def test_a_device_without_a_kernel_raises():
    """Neither the CPU nor the card: no plain-version fallback, no launch."""
    before = tp.polyfit.launches
    with pytest.raises(ValueError, match="no kernel"):
        tp.polyfit(torch.zeros(5, dtype=torch.float64, device="meta"), torch.zeros(5), 2)
    assert tp.polyfit.launches == before


# -- the kernel's launch plan (ops/polyfit.py::plan), pure Python ---------------

PLAN_P = [1, 2, 3, 99, 100, 101, 131, 132, 133, 264, 527, 528, 529, 1000]
PLAN_M = [1, 2, 3, 31, 223, 224, 225, 1120, 1121, 1233, 1234, 1235, 6170, 7993, 9999, 10000]


def _covered(p: int, m: int, grid) -> np.ndarray:
    """How often each (weighting, column) is fitted: block b fits weighting
    b // tiles on columns (b % tiles) * tile up to the next tile or M, as
    the kernel reads its block index."""
    fit, t = np.divmod(np.arange(grid.blocks), grid.tiles)
    lo = t * grid.tile
    assert (lo < m).all()  # no block without a column
    edges = np.zeros((p, m + 1), np.int64)  # +1 where a block's columns start, -1 past their end
    np.add.at(edges, (fit, lo), 1)
    np.add.at(edges, (fit, np.minimum(m, lo + grid.tile)), -1)
    return edges.cumsum(axis=1)[:, :m]


@pytest.mark.parametrize("n, k", [(8, 3), (5, 3), (1536, 4), (6144, 1), (2048, 3)])
def test_plan_fits_every_weighting_and_column_once(n, k):
    """The register form's plan (where ``plan`` routes deg <= 3) places
    every (weighting, column) once."""
    rng = np.random.default_rng(k * 10_000 + n)
    pairs = [(p, m) for p in PLAN_P for m in PLAN_M] + list(zip(rng.integers(1, 1001, 40), rng.integers(1, 10_001, 40)))
    for p, m in pairs:
        grid = tp.plan(int(p), n, k, int(m), 132)
        assert grid.form == "register", (p, m)
        assert grid.blocks == p * grid.tiles and grid.tile >= 1, (p, m)
        assert (_covered(int(p), int(m), grid) == 1).all(), (p, m)
        # the weighting, its rows, the tile's right-hand sides and the static arrays fit per_sm blocks on an SM
        assert grid.shared == 8 * (n * (k + 1) + k * grid.tile) <= tp.BLOCK_SHARED, (p, m)
        static = 8 * (2 * k + 2 * k * k)
        assert grid.per_sm * (grid.shared + static + tp.BLOCK_RESERVED) <= tp.SM_SHARED, (p, m)
        assert 1 <= grid.per_sm <= tp.KERNEL_MIN_BLOCKS[k]
        if p * -(-m // tp.KERNEL_COL_THREADS) <= 132 * grid.per_sm:  # it fits a wave at a column a thread
            assert grid.blocks <= 132 * grid.per_sm, (p, m)


def test_plan_fills_one_wave_at_the_swarms_shape():
    """The particle swarm's batch (P=100 weightings of N=8 samples, deg 2,
    M=6,170 columns) fills one wave of the 132 SMs at 4 blocks an SM,
    a few columns a thread."""
    grid = tp.plan(100, 8, 3, 6170, 132)
    wave = 132 * grid.per_sm
    assert grid.per_sm == 4 and wave // 2 < grid.blocks <= wave
    assert -(-grid.tile // tp.KERNEL_COL_THREADS) <= 8  # right-hand sides a column thread forms
    assert -(-grid.tile // tp.KERNEL_THREADS) <= 8  # columns a thread solves and stores


def test_plan_of_the_replay_is_one_block():
    """The polyfit replay's fit: one weighting of N=5, deg 2, M=2."""
    grid = tp.plan(1, 5, 3, 2, 132)
    assert (grid.blocks, grid.tiles, grid.tile) == (1, 1, 2)


@pytest.mark.parametrize("n, k, form", [
    (5, 0, None), (5, 9, "wave"), (6145, 1, "wave"), (2049, 3, "wave"), (769, 8, "wave"), (878, 7, "wave"),
    (768, 8, "wave"), (6144, 1, "register"), (2048, 3, "register"), (877, 7, "wave"), (11, 17, "general"),
    (1536, 4, "register"), (11, 5, "wave"),
])
def test_plan_refuses_what_the_kernel_cannot_take(n, k, form):
    """The one refusal is k = 0 (deg -1), which JAX cannot fit either.  The
    old limits (deg 8 and up, scaled rows beyond 48 KB) plan the wave form
    up to deg 15 and the general form beyond, and so do deg 4-7 (the wave
    form timed faster there); 48 KB itself stays in the register form up
    to deg 3."""
    if form is None:
        with pytest.raises(ValueError, match="deg >= 0"):
            tp.plan(1, n, k, 2, 132)
        return
    grid = tp.plan(1, n, k, 2, 132)
    assert (grid.form, grid.blocks, grid.workspace) == (form, 1, 0)
    assert tp.register_form(n, k) == (form == "register")


def test_plan_constants_are_the_kernels():
    """The plan mirrors the kernel's block size and residency."""
    src = (Path(tp.__file__).resolve().parents[1] / "csrc" / "polyfit_f64.cu").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [str(tp.KERNEL_THREADS)]
    assert re.findall(r"constexpr int kColThreads = kThreads - (\d+);", src) == [str(tp.KERNEL_THREADS - tp.KERNEL_COL_THREADS)]
    found = re.search(r"constexpr int kMinBlocks\[5\] = \{([\d, ]+)\};", src)
    assert found and tuple(int(v) for v in found.group(1).split(",")) == tp.KERNEL_MIN_BLOCKS
    assert re.findall(r"constexpr size_t kGeneralRows = (\d+)u << 10;", src) == [str(tp.KERNEL_GENERAL_ROWS >> 10)]
    assert re.findall(r"constexpr int kGeneralMinBlocks = (\d+);", src) == [str(tp.KERNEL_GENERAL_MIN_BLOCKS)]
    assert "return 2 * kk + 2 * kk * kk + kk * kThreads;" in src  # general_fixed
    assert re.findall(r"constexpr int kWaveMaxK = (\d+);", src) == [str(tp.KERNEL_WAVE_MAX_K)]
    found = re.search(r"constexpr int kWaveMinBlocks\[kWaveMaxK \+ 1\] = \{([\d, ]+)\};", src)
    assert found and tuple(int(v) for v in found.group(1).split(",")) == tp.KERNEL_WAVE_MIN_BLOCKS
    assert re.findall(r"constexpr int kWaveColThreads = kThreads - (\d+);", src) == [
        str(tp.KERNEL_THREADS - tp.KERNEL_WAVE_COL_THREADS)]
    assert re.findall(r"constexpr int kSweeps = (\d+);", src) == [str(tp.SWEEPS)]
