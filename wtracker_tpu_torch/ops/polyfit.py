"""Weighted polynomial least squares in float64 (Vandermonde + min-norm solve).

Port of :mod:`wtracker_tpu.ops.polyfit`: the column-scaled least-squares
algorithm of ``numpy.polynomial.polyutils._fit``, solved through an
eigendecomposition of the (tiny, ≤ 6×6) normal matrix by the JAX package's
cyclic Jacobi rotations, rotation for rotation.  ``torch.linalg.eigh`` or
``lstsq`` would compute another decomposition, and the replay engine's logs
must equal the JAX engine's byte for byte.

Two rules keep the arithmetic the same on the CPU and on the card:

* every sum over samples or matrix rows is a chain of elementwise adds in a
  fixed order (:func:`_sum0`), never a BLAS/cuBLAS product or a reduction
  kernel, whose summation order differs between devices;
* powers are built by repeated multiplication, which is exact for the
  integral sample times and evaluation points of the controllers (so it
  equals ``jnp.power`` there);
* square roots are correctly rounded on both (:func:`_sqrt`): the card's
  ``torch.sqrt`` is, torch's float64 one on the CPU is not.

Zero weights exclude samples: a row with ``w == 0`` contributes nothing to
the normal equations, so a data-dependent mask (missing detections) needs no
change of shape and no host sync.  Every step is an eager torch op, one
kernel launch each on the card; a degree-2 fit is about 1,500 of them, most
in :func:`jacobi_eigh`.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

__all__ = ["jacobi_eigh", "lstsq_minnorm", "polyvander", "polyfit", "polyval", "fit_and_eval"]


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis as ``((x0 + x1) + x2) + …``."""
    return reduce(torch.add, x.unbind(0))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  torch's float64 ``sqrt`` on the CPU
    is one ulp off for some inputs (about 0.7 % of them on an AVX-512 host:
    ``sqrt(8)`` among them); the card's and numpy's are correctly rounded,
    so a CPU tensor goes through numpy."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def jacobi_eigh(a: torch.Tensor, sweeps: int = 12) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition by cyclic Jacobi rotations.

    For the tiny (k ≤ 8) normal matrices of polynomial fitting: ``sweeps ·
    k(k−1)/2`` Givens rotations, unrolled in Python, with the JAX package's
    float64 expressions (a rotation whose pivot is below ``tiny`` is the
    identity, selected with ``torch.where``, never by a branch on a value).
    Rows ``p`` and ``q`` of a rotation are one strided view, updated as
    ``c·rows + (−s, s)·rows.flip()``: the same two products and one add
    per entry as ``c·row_p − s·row_q`` and ``s·row_p + c·row_q``.

    Returns ``(eigenvalues, eigenvectors)`` with columns as eigenvectors,
    like ``jnp.linalg.eigh`` (not sorted).
    """
    k = a.shape[0]
    a = a.clone()
    flat = a.view(-1)
    v = torch.eye(k, dtype=a.dtype, device=a.device)
    tiny = torch.finfo(a.dtype).tiny
    signs = torch.tensor([-1.0, 1.0], dtype=a.dtype, device=a.device)

    for _ in range(sweeps):
        for p in range(k - 1):
            for q in range(p + 1, k):
                d = q - p
                apq, app, aqq = a[p, q], a[p, p], a[q, q]

                rotate = apq.abs() > tiny
                safe_apq = torch.where(rotate, apq, 1.0)
                tau = (aqq - app) / (2.0 * safe_apq)
                root = _sqrt(tau * tau + 1.0)
                sgn = torch.sign(tau)
                t = torch.where(sgn == 0, (tau + root).reciprocal(), sgn / (tau.abs() + root))
                c = _sqrt(t * t + 1.0).reciprocal()
                s = t * c
                c = torch.where(rotate, c, 1.0)
                ms = torch.where(rotate, s, 0.0) * signs  # (−s, s)

                # a <- Gᵀ a G on rows/cols p, q, then the pivot pair zeroed
                rows = a[p::d][:2]
                rows.copy_(c * rows + ms[:, None] * rows.flip(0))
                cols = a[:, p::d][:, :2]
                cols.copy_(c * cols + ms * cols.flip(1))
                flat[p * k + q :: d * (k - 1)][:2].zero_()  # a[p, q] and a[q, p]

                vcols = v[:, p::d][:, :2]
                vcols.copy_(c * vcols + ms * vcols.flip(1))

    return a.diagonal().clone(), v


def lstsq_minnorm(a: torch.Tensor, b: torch.Tensor, rcond: float) -> torch.Tensor:
    """Min-norm least-squares solution of ``a @ x = b`` via normal equations.

    Eigen-decomposes ``aᵀa`` (symmetric PSD, (k, k)) with :func:`jacobi_eigh`
    and drops eigenvalues below ``max(rcond², 16·eps)·λmax``, mirroring
    ``np.linalg.lstsq``'s singular-value cutoff (the floor is the
    normal-equations noise level: forming ``aᵀa`` squares singular values but
    not the noise).  ``b`` is (n, M).
    """
    ata = _sum0(a[:, :, None] * a[:, None, :])
    atb = _sum0(a[:, :, None] * b[:, None, :])
    evals, evecs = jacobi_eigh(ata)
    evals = evals.clamp_min(0.0)
    eps = torch.finfo(ata.dtype).eps
    cutoff = max(rcond**2, 16 * eps) * evals.max()
    keep = evals > cutoff
    inv = torch.where(keep, torch.where(keep, evals, 1.0).reciprocal(), 0.0)
    proj = _sum0(evecs[:, :, None] * atb[:, None, :])  # evecsᵀ @ atb
    scaled = inv[:, None] * proj
    return _sum0((evecs[:, :, None] * scaled[None, :, :]).transpose(0, 1))  # evecs @ scaled


def polyvander(x: torch.Tensor, deg: int) -> torch.Tensor:
    """Increasing-order Vandermonde matrix, shape ``(*x.shape, deg + 1)``,
    with ``x^j = x^(j−1)·x`` (exact for integral ``x``)."""
    cols = [torch.ones_like(x)]
    for _ in range(deg):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def polyfit(x: torch.Tensor, y: torch.Tensor, deg: int, w: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares polynomial fit; mirrors ``np.polynomial.polynomial.polyfit``.

    Args:
        x: sample positions, shape (N,).
        y: sample values, shape (N,) or (N, M) for M simultaneous fits.
        deg: polynomial degree.
        w: optional per-sample weights (N,); zero excludes a sample.

    Returns:
        float64 coefficients in increasing order, shape (deg + 1,) or (deg + 1, M).
    """
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=x.device)

    lhs = polyvander(x, deg)
    rhs = y if y.ndim > 1 else y[:, None]
    if w is not None:
        w = torch.as_tensor(w, dtype=torch.float64, device=x.device)
        lhs = lhs * w[:, None]
        rhs = rhs * w[:, None]

    # column scaling for conditioning, as numpy's polyutils._fit
    scl = _sqrt(_sum0(lhs * lhs))
    scl = torch.where(scl == 0, 1.0, scl)

    rcond = x.shape[0] * torch.finfo(x.dtype).eps
    c = lstsq_minnorm(lhs / scl, rhs, rcond) / scl[:, None]
    return c if y.ndim > 1 else c[:, 0]


def polyval(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomial(s) at ``x``: increasing-order ``coeffs`` along
    axis 0, trailing axes broadcast against ``x``'s shape."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float64)
    x = torch.as_tensor(x, dtype=torch.float64, device=coeffs.device)
    van = polyvander(x, coeffs.shape[0] - 1)
    terms = van.movedim(-1, 0).reshape(coeffs.shape[0], *x.shape, *([1] * (coeffs.ndim - 1))) * coeffs.reshape(
        coeffs.shape[0], *([1] * x.ndim), *coeffs.shape[1:]
    )
    return _sum0(terms)


def fit_and_eval(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, x_eval, deg: int) -> torch.Tensor:
    """Fit + single-point evaluation: the polyfit controller's per-cycle work."""
    return polyval(x_eval, polyfit(x, y, deg, w))
