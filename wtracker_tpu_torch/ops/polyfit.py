"""Weighted polynomial least squares in float64 (Vandermonde + min-norm solve).

Port of :mod:`wtracker_tpu.ops.polyfit`: the column-scaled least-squares
algorithm of ``numpy.polynomial.polyutils._fit``, solved through an
eigendecomposition of the (deg + 1)² normal matrix (3×3 for the deployed
fits) by the JAX package's cyclic Jacobi rotations, rotation for rotation.
``torch.linalg.eigh`` or ``lstsq`` would compute another decomposition, and
the replay engine's logs must equal the JAX engine's byte for byte.

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
change of shape and no host sync.

:func:`polyfit` on the card is one launch of the hand-written kernel
``csrc/polyfit_f64.cu``, which computes the whole fit with the plain
version's arithmetic and gives its bits; on the CPU it runs the plain
version, :func:`polyfit_reference`, whose every step is an eager torch op
(about 1,500 launches a degree-2 fit on the card, most in
:func:`jacobi_eigh`).  The kernel has two forms, one launch either way: a
register form for small degrees and sample counts, and a general form for
every other ``deg ≥ 0`` and ``N ≥ 1``; :func:`plan` picks the form and cuts
a launch into blocks of columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache, reduce

import numpy as np
import torch

__all__ = ["jacobi_eigh", "lstsq_minnorm", "polyvander", "polyfit", "polyfit_reference", "polyval", "fit_and_eval"]

# the kernel's constants (csrc/polyfit_f64.cu; a CPU test reads them back)
KERNEL_THREADS = 256  # kThreads: warp 0 the setup, the other warps the columns' right-hand sides
KERNEL_COL_THREADS = KERNEL_THREADS - 32
KERNEL_MIN_BLOCKS = (1, 4, 4, 4, 2, 2, 1, 1)  # kMinBlocks[deg + 1]: the register form's blocks resident on an SM
KERNEL_REGISTER_ROWS = 48 << 10  # bytes of (N, deg + 1) scaled Vandermonde rows plan sends to the register form
KERNEL_GENERAL_ROWS = 48 << 10  # kGeneralRows: bytes of weighting and rows the general form keeps in shared memory
KERNEL_GENERAL_MIN_BLOCKS = 4  # kGeneralMinBlocks: its blocks resident on an SM
SMS = 132  # the H100's streaming multiprocessors
SM_SHARED = 233_472  # shared memory an SM holds (228 KB)
BLOCK_SHARED = 232_448  # shared memory a block may use (227 KB)
BLOCK_RESERVED = 1024  # the runtime's shared memory for each resident block


@dataclass(frozen=True)
class Plan:
    """One launch of the kernel: ``tiles`` blocks a weighting, each on
    ``tile`` columns (block ``b`` fits weighting ``b // tiles`` on columns
    ``(b % tiles) * tile`` up to the next tile or M), ``blocks`` in all,
    ``shared`` bytes of dynamic shared memory a block, ``per_sm`` blocks
    resident on an SM; ``form`` is ``"register"`` or ``"general"``, and
    ``workspace`` the bytes of global memory the general form keeps its
    blocks' matrices in (0: in shared memory)."""

    tile: int
    tiles: int
    blocks: int
    shared: int
    per_sm: int
    form: str = "register"
    workspace: int = 0


def _check_terms(k: int) -> None:
    if k < 1:
        raise ValueError(f"polyfit needs deg >= 0, got deg {k - 1}")


def register_form(n: int, k: int) -> bool:
    """Whether :func:`plan` sends N samples of k terms to the register form:
    k ≤ 7 (deg ≤ 6; at k = 8 it spilled and timed slower at the swarm's
    batch than the general form, ``PERF.md``) and rows within 48 KB."""
    return k < len(KERNEL_MIN_BLOCKS) and n * k * 8 <= KERNEL_REGISTER_ROWS


def general_fixed(k: int) -> int:
    """Doubles of a general-form block's arrays besides the rows: scl and
    inv, the matrix and its eigenvectors, each thread's scaled projection
    (the ``.cu``'s ``general_fixed``)."""
    return 2 * k + 2 * k * k + k * KERNEL_THREADS


def plan(p: int, n: int, k: int, m: int, sms: int = SMS, workspace: bool | None = None) -> Plan:
    """The kernel's form and grid for P weightings of N samples, k = deg +
    1 terms and M columns on a card of ``sms`` SMs: the register form where
    :func:`register_form` takes the call, else the general form.
    ``workspace`` forces the general form, its block's matrices in the
    global workspace (True) or in shared memory (False).

    Every block runs its weighting's serial setup (the Jacobi) beside or
    before its columns, so the batch should fit in one wave of resident
    blocks: then all the chains run at once.  The weightings' share of that
    wave sets the tiles a weighting, never more than give each column thread
    a column.  In the register form a block's shared memory holds its
    weighting (N), the scaled rows (N·k) and its columns' right-hand sides
    (k·tile), at most what lets the kernel's ``per_sm`` blocks share an SM.
    The general form's holds the weighting and rows while they fit
    ``KERNEL_GENERAL_ROWS``, and the block's matrices and its threads'
    arrays (:func:`general_fixed`) unless they go to the workspace, which
    they do where the whole would not fit a block.  A batch larger than a
    wave (P above it, or columns beyond shared memory) takes more waves."""
    _check_terms(k)
    if workspace is not None or not register_form(n, k):
        return _plan_general(p, n, k, m, sms, workspace)
    fixed = 8 * (n * (k + 1) + 2 * k + 2 * k * k)  # weighting, rows; static scl, inv, evecs, ata
    per_sm = KERNEL_MIN_BLOCKS[k]
    while per_sm > 1 and fixed + 8 * k > SM_SHARED // per_sm - BLOCK_RESERVED:
        per_sm -= 1
    room = min(BLOCK_SHARED, SM_SHARED // per_sm - BLOCK_RESERVED) - fixed
    tiles = max(1, min(sms * per_sm // max(p, 1), -(-m // KERNEL_COL_THREADS)))
    tile = max(1, min(-(-m // tiles), room // (8 * k)))
    tiles = max(1, -(-m // tile))
    return Plan(tile=tile, tiles=tiles, blocks=p * tiles, shared=8 * (n * (k + 1) + k * tile), per_sm=per_sm)


def _plan_general(p: int, n: int, k: int, m: int, sms: int, workspace: bool | None) -> Plan:
    rows = 8 * n * (k + 1) if 8 * n * (k + 1) <= KERNEL_GENERAL_ROWS else 0
    fixed = 8 * general_fixed(k)
    if workspace is None:
        workspace = rows + fixed > BLOCK_SHARED
    shared = rows + (0 if workspace else fixed)
    per_sm = KERNEL_GENERAL_MIN_BLOCKS
    while per_sm > 1 and shared > SM_SHARED // per_sm - BLOCK_RESERVED:
        per_sm -= 1
    tiles = max(1, min(sms * per_sm // max(p, 1), -(-m // KERNEL_THREADS)))
    tile = max(1, -(-m // tiles))
    tiles = max(1, -(-m // tile))
    return Plan(tile=tile, tiles=tiles, blocks=p * tiles, shared=shared, per_sm=per_sm, form="general",
                workspace=p * tiles * fixed if workspace else 0)


@cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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

    For the k × k normal matrices of polynomial fitting (k = deg + 1): ``sweeps ·
    k(k−1)/2`` Givens rotations, unrolled in Python, with the JAX package's
    float64 expressions (a rotation whose pivot is below ``tiny`` is the
    identity, selected with ``torch.where``, never by a branch on a value).
    Rows ``p`` and ``q`` of a rotation are one strided view, updated as
    ``c·rows + (−s, s)·rows.flip()``: the same two products and one add
    per entry as ``c·row_p − s·row_q`` and ``s·row_p + c·row_q``.  Leading
    axes of ``a`` (..., k, k) are a batch of matrices, each rotated by the
    same launches.

    Returns ``(eigenvalues, eigenvectors)`` with columns as eigenvectors,
    like ``jnp.linalg.eigh`` (not sorted).
    """
    k = a.shape[-1]
    a = a.clone()
    flat = a.view(*a.shape[:-2], k * k)
    v = torch.eye(k, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    tiny = torch.finfo(a.dtype).tiny
    signs = torch.tensor([-1.0, 1.0], dtype=a.dtype, device=a.device)

    for _ in range(sweeps):
        for p in range(k - 1):
            for q in range(p + 1, k):
                d = q - p
                apq, app, aqq = a[..., p, q], a[..., p, p], a[..., q, q]

                rotate = apq.abs() > tiny
                safe_apq = torch.where(rotate, apq, 1.0)
                tau = (aqq - app) / (2.0 * safe_apq)
                root = _sqrt(tau * tau + 1.0)
                sgn = torch.sign(tau)
                t = torch.where(sgn == 0, (tau + root).reciprocal(), sgn / (tau.abs() + root))
                c = _sqrt(t * t + 1.0).reciprocal()
                s = t * c
                c = torch.where(rotate, c, 1.0)[..., None, None]
                ms = torch.where(rotate, s, 0.0)[..., None] * signs  # (..., 2): (−s, s)

                # a <- Gᵀ a G on rows/cols p, q, then the pivot pair zeroed
                rows = a[..., p::d, :][..., :2, :]
                rows.copy_(c * rows + ms[..., :, None] * rows.flip(-2))
                cols = a[..., :, p::d][..., :, :2]
                cols.copy_(c * cols + ms[..., None, :] * cols.flip(-1))
                flat[..., p * k + q :: d * (k - 1)][..., :2].zero_()  # a[p, q] and a[q, p]

                vcols = v[..., :, p::d][..., :, :2]
                vcols.copy_(c * vcols + ms[..., None, :] * vcols.flip(-1))

    return a.diagonal(dim1=-2, dim2=-1).clone(), v


def lstsq_minnorm(a: torch.Tensor, b: torch.Tensor, rcond: float) -> torch.Tensor:
    """Min-norm least-squares solution of ``a @ x = b`` via normal equations.

    Eigen-decomposes ``aᵀa`` (symmetric PSD, (k, k)) with :func:`jacobi_eigh`
    and drops eigenvalues below ``max(rcond², 16·eps)·λmax``, mirroring
    ``np.linalg.lstsq``'s singular-value cutoff (the floor is the
    normal-equations noise level: forming ``aᵀa`` squares singular values but
    not the noise).  ``a`` is (..., n, k) and ``b`` (..., n, M), leading
    axes a batch.
    """
    at, bt = a.movedim(-2, 0), b.movedim(-2, 0)  # samples first, summed in order
    ata = _sum0(at[..., :, None] * at[..., None, :])
    atb = _sum0(at[..., :, None] * bt[..., None, :])
    evals, evecs = jacobi_eigh(ata)
    evals = evals.clamp_min(0.0)
    eps = torch.finfo(ata.dtype).eps
    cutoff = max(rcond**2, 16 * eps) * evals.amax(dim=-1, keepdim=True)
    keep = evals > cutoff
    inv = torch.where(keep, torch.where(keep, evals, 1.0).reciprocal(), 0.0)
    proj = _sum0((evecs[..., :, :, None] * atb[..., :, None, :]).movedim(-3, 0))  # evecsᵀ @ atb
    scaled = inv[..., :, None] * proj
    return _sum0((evecs[..., :, :, None] * scaled[..., None, :, :]).movedim(-2, 0))  # evecs @ scaled


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
        w: optional per-sample weights (N,), or (..., N) for a batch of
            weightings of the same samples; zero excludes a sample.

    Returns:
        float64 coefficients in increasing order, shape (..., deg + 1) or
        (..., deg + 1, M).

    ``x`` on the card launches the kernel (one launch a call, counted in
    ``polyfit.launches``; ``y`` and ``w`` go to ``x``'s device); on the CPU
    this is :func:`polyfit_reference`.  The kernel takes every ``deg`` ≥ 0
    and N ≥ 1; :func:`plan` picks its form and sets its grid.
    """
    x = torch.as_tensor(x, dtype=torch.float64)
    if x.device.type == "cpu":
        return polyfit_reference(x, y, deg, w)
    return _polyfit_kernel(x, y, deg, w)


def _polyfit_kernel(x: torch.Tensor, y: torch.Tensor, deg: int, w: torch.Tensor | None = None,
                    workspace: bool | None = None) -> torch.Tensor:
    """:func:`polyfit` on the card; ``workspace`` forces the general form
    as :func:`plan` takes it (tests reach the general form at small
    degrees, and its global workspace, through it)."""
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    from wtracker_tpu_torch.ops import _build

    y = torch.as_tensor(y, dtype=torch.float64, device=x.device)
    if x.ndim != 1 or y.ndim not in (1, 2) or y.shape[0] != x.shape[0] or x.shape[0] == 0:
        raise ValueError(f"x must be (N,) and y (N,) or (N, M) with N > 0, got {tuple(x.shape)} and {tuple(y.shape)}")
    n, k = x.shape[0], deg + 1
    _check_terms(k)
    if w is None:
        w = torch.ones(n, dtype=torch.float64, device=x.device)  # x * 1.0 is x: the plain version's unweighted bits
    w = torch.as_tensor(w, dtype=torch.float64, device=x.device)
    if w.ndim == 0 or w.shape[-1] != n:
        raise ValueError(f"w must be (..., {n}), got {tuple(w.shape)}")
    batch = w.shape[:-1]
    rhs = y if y.ndim > 1 else y[:, None]
    m = rhs.shape[1]
    x, rhs, w = x.contiguous(), rhs.contiguous(), w.reshape(-1, n).contiguous()
    out = torch.empty((w.shape[0], k, m), dtype=torch.float64, device=x.device)
    eps = torch.finfo(torch.float64).eps
    cut_factor = max((n * eps) ** 2, 16 * eps)  # lstsq_minnorm's, with polyfit's rcond
    if w.shape[0]:
        grid = plan(w.shape[0], n, k, m, _sms(x.device), workspace)
        scratch = torch.empty(grid.workspace // 8, dtype=torch.float64, device=x.device) if grid.workspace else None
        lib = _build.load("polyfit_f64")
        with torch.cuda.device(x.device):
            err = lib.polyfit_f64(1 if grid.form == "register" else 2, x.data_ptr(), rhs.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), w.shape[0], n, m, k, grid.tile, grid.tiles, cut_factor,
                                  None if scratch is None else scratch.data_ptr(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"polyfit kernel launch failed with CUDA error {err}")
        polyfit.launches += 1
    out = out.reshape(*batch, k, m)
    return out if y.ndim > 1 else out[..., 0]


polyfit.launches = 0


def polyfit_reference(x: torch.Tensor, y: torch.Tensor, deg: int, w: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`polyfit` (the same arguments and result),
    one eager torch op a step on any device."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=x.device)

    lhs = polyvander(x, deg)
    rhs = y if y.ndim > 1 else y[:, None]
    if w is not None:
        w = torch.as_tensor(w, dtype=torch.float64, device=x.device)
        lhs = lhs * w[..., :, None]
        rhs = rhs * w[..., :, None]

    # column scaling for conditioning, as numpy's polyutils._fit
    scl = _sqrt(_sum0((lhs * lhs).movedim(-2, 0)))
    scl = torch.where(scl == 0, 1.0, scl)

    rcond = x.shape[0] * torch.finfo(x.dtype).eps
    c = lstsq_minnorm(lhs / scl[..., None, :], rhs, rcond) / scl[..., :, None]
    return c if y.ndim > 1 else c[..., 0]


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
