"""The port's float64 polynomial fit against the JAX package's.

Reference: ``wtracker_tpu/ops/polyfit.py`` (``jacobi_eigh``,
``lstsq_minnorm``, ``polyvander``, ``polyfit``, ``polyval``,
``fit_and_eval``), on seeded numpy inputs.  Tolerances: eigenvalues 1e-12
relative to the largest, least-squares solutions and fit coefficients
1e-10 relative (XLA and torch may contract or order a product differently
in the last bit); Vandermonde matrices of integral points exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jp = importlib.import_module("wtracker_tpu.ops.polyfit")  # the package's ``polyfit`` name is the function
tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")  # so is the port's


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("k", [2, 3, 4, 6])
def test_jacobi_eigenvalues_match_jax(k):
    rng = np.random.default_rng(k)
    m = rng.normal(size=(k + 3, k))
    a = m.T @ m + np.diag(rng.uniform(0, 2, k))
    got_vals, got_vecs = tp.jacobi_eigh(torch.from_numpy(a))
    want_vals, _ = jp.jacobi_eigh(jnp.asarray(a))
    assert _rel_err(np.sort(got_vals.numpy()), np.sort(np.asarray(want_vals))) <= 1e-12
    assert _rel_err(np.sort(got_vals.numpy()), np.linalg.eigvalsh(a)) <= 1e-12
    # a valid decomposition: orthonormal columns that rebuild the matrix
    v = got_vecs.numpy()
    np.testing.assert_allclose(v.T @ v, np.eye(k), atol=1e-12)
    np.testing.assert_allclose(v @ np.diag(got_vals.numpy()) @ v.T, a, atol=1e-11 * np.abs(a).max())


def test_jacobi_on_a_diagonal_matrix_rotates_nothing():
    a = np.diag([3.0, 1.0, 2.0])
    vals, vecs = tp.jacobi_eigh(torch.from_numpy(a))
    np.testing.assert_array_equal(vals.numpy(), [3.0, 1.0, 2.0])
    np.testing.assert_array_equal(vecs.numpy(), np.eye(3))


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient", "zero_weights"])
def test_lstsq_minnorm_matches_jax(case):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(6, 3))
    if case == "rank_deficient":
        a[:, 2] = a[:, 0] + a[:, 1]  # rank 2: the min-norm solution
    if case == "zero_weights":
        a[[1, 4]] = 0.0  # two samples excluded, as a zero fit weight does
    b = rng.normal(size=(6, 2))
    rcond = 6 * np.finfo(np.float64).eps
    got = tp.lstsq_minnorm(torch.from_numpy(a), torch.from_numpy(b), rcond).numpy()
    want = np.asarray(jp.lstsq_minnorm(jnp.asarray(a), jnp.asarray(b), rcond))
    assert _rel_err(got, want) <= 1e-10
    np.testing.assert_allclose(got, np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_polyfit_and_eval_match_jax(deg):
    rng = np.random.default_rng(deg)
    x = np.array([-15.0, -10.0, -5.0, 0.0, 3.0, 6.0])
    y = np.stack([150 + 2.5 * x + 0.1 * x**2, 170 - 1.5 * x], axis=1) + rng.normal(0, 0.5, (6, 2))
    w = np.array([1.0, 0.0, 2.0, 0.5, 1.0, 0.0])  # zero weights drop two samples
    got = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y), deg, torch.from_numpy(w)).numpy()
    want = np.asarray(jp.polyfit(jnp.asarray(x), jnp.asarray(y), deg, jnp.asarray(w)))
    assert got.shape == (deg + 1, 2) and _rel_err(got, want) <= 1e-10
    np.testing.assert_allclose(got, np.polynomial.polynomial.polyfit(x[w > 0], y[w > 0], deg, w=w[w > 0]), rtol=1e-7)

    one = tp.polyfit(torch.from_numpy(x), torch.from_numpy(y[:, 0]), deg).numpy()
    assert one.shape == (deg + 1,)
    assert _rel_err(one, np.asarray(jp.polyfit(jnp.asarray(x), jnp.asarray(y[:, 0]), deg))) <= 1e-10

    at = tp.fit_and_eval(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), 21.0, deg).numpy()
    want_at = np.asarray(jp.fit_and_eval(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.float64(21.0), deg))
    assert _rel_err(at, want_at) <= 1e-10
    np.testing.assert_allclose(tp.polyval(torch.tensor([0.0, 21.0]), torch.from_numpy(got)).numpy()[1], at, rtol=0)


def test_vandermonde_of_integral_points_is_exact():
    x = np.arange(-40.0, 41.0)
    got = tp.polyvander(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got.numpy(), torch.pow(torch.from_numpy(x)[:, None], torch.arange(6.0, dtype=torch.float64)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.polyvander(jnp.asarray(x), 5)))
    assert got.dtype == torch.float64 and got.shape == (81, 6)
