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
:func:`jacobi_eigh`).  The kernel has three forms, one launch each, and
:func:`plan` picks the form and cuts a launch into blocks of columns:

* the register form, deg ≤ 3 over rows within 48 KB, whose lane 0 runs
  the rotations one after another in registers;
* the wave form, every other call with deg ≤ 15, which runs the rotations
  as a wavefront: rotation (p, q) of sweep s only waits for the rotations
  before it that share p or q, so those of one anti-diagonal, step
  ``s·k + p + q − 1`` for k ≥ 3, compute their scalars at once, and each
  matrix entry then takes its own updates in the cyclic order
  (:func:`wave_schedule` lays this out, :func:`wave_table` packs it for
  the kernel); the eigenvectors are rotated beside it from the stored
  scalars, and each column is solved in one pass in registers;
* the general form, deg ≥ 16, with k at run time, which runs the
  rotations one after another over a warp.
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
KERNEL_MIN_BLOCKS = (1, 4, 4, 4, 2)  # kMinBlocks[deg + 1]: the register form's blocks resident on an SM
KERNEL_REGISTER_ROWS = 48 << 10  # bytes of (N, deg + 1) scaled Vandermonde rows plan sends to the register form
KERNEL_GENERAL_ROWS = 48 << 10  # kGeneralRows: bytes of weighting and rows the general form keeps in shared memory
KERNEL_GENERAL_MIN_BLOCKS = 4  # kGeneralMinBlocks: its blocks resident on an SM
KERNEL_WAVE_MAX_K = 16  # kWaveMaxK: the wave form's largest k (deg 15); the general form takes the rest
# kWaveMinBlocks[k]: the wave form's blocks resident on an SM (at most 64, 85 or 128 registers a
# thread, the most blocks whose build spills nothing: each column's k sums and k projections in registers)
KERNEL_WAVE_MIN_BLOCKS = (1, 4, 4, 4, 4, 4, 4, 3, 3, 4, 3, 2, 2, 2, 2, 2, 2)
KERNEL_WAVE_COL_THREADS = KERNEL_THREADS - 64  # kWaveColThreads: warps 2-7 form right-hand sides beside the Jacobi
SWEEPS = 12  # kSweeps: jacobi_eigh's default, the kernel's sweeps
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
    resident on an SM; ``form`` is ``"register"``, ``"wave"`` or
    ``"general"``, ``workspace`` the bytes of global memory the general form
    keeps its blocks' matrices in (0: in shared memory), and ``hold`` the
    columns a wave-form block forms the right-hand sides of beside its
    Jacobi, into shared memory."""

    tile: int
    tiles: int
    blocks: int
    shared: int
    per_sm: int
    form: str = "register"
    workspace: int = 0
    hold: int = 0


def _check_terms(k: int) -> None:
    if k < 1:
        raise ValueError(f"polyfit needs deg >= 0, got deg {k - 1}")


def register_form(n: int, k: int) -> bool:
    """Whether :func:`plan` sends N samples of k terms to the register form:
    k ≤ 4 (deg ≤ 3; from deg 4 the wave form timed faster at the replay's
    and the swarm's shapes, ``PERF.md``) and rows within 48 KB."""
    return k < len(KERNEL_MIN_BLOCKS) and n * k * 8 <= KERNEL_REGISTER_ROWS


def general_fixed(k: int) -> int:
    """Doubles of a general-form block's arrays besides the rows: scl and
    inv, the matrix and its eigenvectors, each thread's scaled projection
    (the ``.cu``'s ``general_fixed``)."""
    return 2 * k + 2 * k * k + k * KERNEL_THREADS


def wave_static(k: int) -> int:
    """Bytes of a wave-form block's static shared memory: scl and inv, the
    matrix (and a spare entry) and its eigenvectors, each rotation's c, −s
    and s (and a spare rotation's), the rows-done counter (padded)."""
    return 8 * (2 * k + 2 * k * k + 1 + 3 * (SWEEPS * k * (k - 1) // 2 + 1)) + 16


def plan(p: int, n: int, k: int, m: int, sms: int = SMS, workspace: bool | None = None) -> Plan:
    """The kernel's form and grid for P weightings of N samples, k = deg +
    1 terms and M columns on a card of ``sms`` SMs: the register form where
    :func:`register_form` takes the call, else the wave form up to k =
    ``KERNEL_WAVE_MAX_K``, else the general form.  ``workspace`` forces the
    general form, its block's matrices in the global workspace (True) or in
    shared memory (False).

    Every block runs its weighting's serial setup (the Jacobi) beside or
    before its columns, so the batch should fit in one wave of resident
    blocks: then all the chains run at once.  The weightings' share of that
    wave sets the tiles a weighting, never more than give each column thread
    a column.  In the register form a block's shared memory holds its
    weighting (N), the scaled rows (N·k) and its columns' right-hand sides
    (k·tile), at most what lets the kernel's ``per_sm`` blocks share an SM.
    The wave form's holds the weighting and rows while they fit
    ``KERNEL_GENERAL_ROWS`` (beyond it each thread's k sums of a column),
    the schedule's table (:func:`wave_table`) and, in what is left of the
    SM's share beside its static arrays (:func:`wave_static`), the
    right-hand sides of its first ``hold`` columns, formed beside the
    Jacobi; the rest are formed and solved in one pass after it.  The
    general form's holds the weighting and rows while they fit, and the
    block's matrices and its threads' arrays (:func:`general_fixed`) unless
    they go to the workspace, which they do where the whole would not fit
    a block.  A batch larger than a wave (P above it, or columns beyond
    shared memory) takes more waves."""
    _check_terms(k)
    if workspace is not None or k > KERNEL_WAVE_MAX_K:
        return _plan_general(p, n, k, m, sms, workspace)
    if not register_form(n, k):
        return _plan_wave(p, n, k, m, sms)
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


def _plan_wave(p: int, n: int, k: int, m: int, sms: int) -> Plan:
    rows = 8 * n * (k + 1)  # the weighting and rows, or beyond KERNEL_GENERAL_ROWS each thread's k sums
    fixed = (rows if rows <= KERNEL_GENERAL_ROWS else 8 * k * KERNEL_THREADS) + 2 * wave_table(k).size
    per_sm = KERNEL_WAVE_MIN_BLOCKS[k]
    while per_sm > 1 and fixed + wave_static(k) > SM_SHARED // per_sm - BLOCK_RESERVED:
        per_sm -= 1
    tiles = max(1, min(sms * per_sm // max(p, 1), -(-m // KERNEL_WAVE_COL_THREADS)))
    tile = max(1, -(-m // tiles))
    tiles = max(1, -(-m // tile))
    room = min(BLOCK_SHARED, SM_SHARED // per_sm - BLOCK_RESERVED) - wave_static(k) - fixed
    hold = max(0, min(tile, room // (8 * k)))
    return Plan(tile=tile, tiles=tiles, blocks=p * tiles, shared=fixed + 8 * k * hold, per_sm=per_sm, form="wave",
                hold=hold)


@dataclass(frozen=True)
class WaveSchedule:
    """The wave form's Jacobi (:func:`wave_schedule`).

    ``rotations[r]`` is rotation r's (p, q), in jacobi_eigh's cyclic order
    over all sweeps.  ``rows`` is what warp 0 runs, one row after another
    with a warp barrier after each: a row's tasks go one to a lane, and
    each is ``(r, -1)``, rotation r's scalars (from the pivot entries
    a[p][p], a[p][q], a[q][q]; it writes the new a[p][p] and a[q][q], zeroes
    a[p][q] and stores c and s), or ``(r, j)``, rotation r's update of the
    pair a[p][j], a[q][j].  ``scalar_row[r]`` is the row that computes
    rotation r's scalars.  Only the upper triangle is stored: the plain
    version keeps the matrix bitwise symmetric."""

    rotations: tuple
    rows: tuple
    scalar_row: tuple


def _entries(p: int, q: int, j: int) -> tuple:
    """The stored (upper-triangle) entries that task (rotation (p, q), j)
    reads and writes."""
    if j < 0:
        return (p, p), (q, q), (p, q)
    return (min(p, j), max(p, j)), (min(q, j), max(q, j))


@cache
def wave_schedule(k: int, sweeps: int = SWEEPS, lanes: int = 32) -> WaveSchedule:
    """The wave form's exact wavefront of jacobi_eigh's rotations.

    Every task reads and writes its entries (:func:`_entries`), so a task
    follows the last earlier task (cyclic order) on each of them, and an
    update follows its rotation's scalars: each entry then takes the plain
    version's updates in its order, from the same values, so the result has
    its bits.  A rotation's scalars run in the first step after its pivot
    entries are final (for k ≥ 3 step ``s·k + p + q − 1`` in sweep s);
    each step is one row of scalars (the rotations of a step share no
    index) and then as many rows of updates as the next step's scalars
    need, each task in the first row after all the tasks it follows; other
    ready updates fill the free lanes of those rows, earliest first.
    Updates that no later scalars read (the off-diagonal entries after the
    last rotations touching them) are left out: the plain version returns
    only the diagonal and the eigenvectors."""
    rotations = tuple((p, q) for _ in range(sweeps) for p in range(k - 1) for q in range(p + 1, k))
    tasks, preds, last, scalars = [], [], {}, {}
    for r, (p, q) in enumerate(rotations):
        for j in [-1] + [j for j in range(k) if j not in (p, q)]:
            before = {last[e] for e in _entries(p, q, j) if e in last}
            if j < 0:
                scalars[r] = len(tasks)
            else:
                before.add(scalars[r])
            for e in _entries(p, q, j):
                last[e] = len(tasks)
            preds.append(before)
            tasks.append((r, j))
    live = [j < 0 for _, j in tasks]
    for i in range(len(tasks) - 1, -1, -1):
        if live[i]:
            for d in preds[i]:
                live[d] = True
    step = [0] * len(tasks)  # a scalar task's step, with chains of updates free
    for i, (_, j) in enumerate(tasks):
        step[i] = max([step[d] + (j < 0) for d in preds[i]], default=0)
    by_step = {}
    for i, (_, j) in enumerate(tasks):
        if j < 0:
            by_step.setdefault(step[i], []).append(i)
    succ = [[] for _ in tasks]
    for i, before in enumerate(preds):
        for d in before:
            succ[d].append(i)
    row_of, rows, ready = {}, [], set()

    def place(chosen):
        for i in chosen:
            row_of[i] = len(rows)
        rows.append(chosen)
        for i in chosen:
            for s in succ[i]:
                if live[s] and tasks[s][1] >= 0 and s not in row_of and all(d in row_of for d in preds[s]):
                    ready.add(s)

    for t in sorted(by_step):
        place(by_step[t])
        need, stack = set(), [d for i in by_step.get(t + 1, ()) for d in preds[i] if d not in row_of]
        while stack:
            d = stack.pop()
            if d not in need:
                need.add(d)
                stack.extend(e for e in preds[d] if e not in row_of)
        while need - row_of.keys():
            first = sorted(ready & need)
            chosen = (first + sorted(ready - need))[:lanes]
            ready.difference_update(chosen)
            place(chosen)
    scalar_row = tuple(row_of[scalars[r]] for r in range(len(rotations)))
    return WaveSchedule(rotations, tuple(tuple(tasks[i] for i in row) for row in rows), scalar_row)


@cache
def wave_table(k: int) -> np.ndarray:
    """:func:`wave_schedule` packed for the kernel, uint16: each rotation's
    scalar row + 1 (what the eigenvector lanes wait for), each row's first
    task (``len(rows) + 1`` offsets, bit 15 set on a row of scalars), then,
    from an even offset, the tasks as uint32: ``1 << 31 | r << 18 | p << 9
    | q`` for rotation r's scalars, ``r << 18 | e1 << 9 | e2`` for its update
    of the stored entries e1 = (p, j) and e2 = (q, j) (``row · k + column``
    in the upper triangle); padded to a multiple of 4 entries (the kernel
    copies it to shared memory 8 bytes at a time)."""
    if k > KERNEL_WAVE_MAX_K:
        raise ValueError(f"k = {k} does not fit the wave form's table")
    sched = wave_schedule(k)
    words = []
    for row in sched.rows:
        for r, j in row:
            p, q = sched.rotations[r]
            if j < 0:
                words.append(1 << 31 | r << 18 | p << 9 | q)
            else:
                (ip, jp), (iq, jq) = _entries(p, q, j)
                words.append(r << 18 | (ip * k + jp) << 9 | (iq * k + jq))
    starts = np.cumsum([0] + [len(row) for row in sched.rows])
    flags = [0x8000 * (i < len(sched.rows) and sched.rows[i][0][1] < 0) for i in range(len(starts))]
    head = np.concatenate([np.array(sched.scalar_row, np.int64) + 1, starts + flags]).astype(np.uint16)
    head = np.concatenate([head, np.zeros(len(head) % 2, np.uint16)])
    table = np.concatenate([head, np.array(words, np.uint32).view(np.uint16)])
    return np.concatenate([table, np.zeros(-len(table) % 4, np.uint16)])


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


def jacobi_eigh(a: torch.Tensor, sweeps: int = SWEEPS) -> tuple[torch.Tensor, torch.Tensor]:
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
    for a, v in jacobi_rotations(a, sweeps):
        pass
    return a.diagonal(dim1=-2, dim2=-1).clone(), v


def jacobi_rotations(a: torch.Tensor, sweeps: int = SWEEPS):
    """:func:`jacobi_eigh`'s rotations one at a time: yields the matrix and
    the eigenvectors (updated in place) once before the first rotation and
    after each."""
    k = a.shape[-1]
    a = a.clone()
    flat = a.view(*a.shape[:-2], k * k)
    v = torch.eye(k, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    tiny = torch.finfo(a.dtype).tiny
    signs = torch.tensor([-1.0, 1.0], dtype=a.dtype, device=a.device)
    yield a, v

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
                yield a, v


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
    """:func:`polyfit` on the card; ``workspace`` forces the general form as
    :func:`plan` takes it (tests reach the general form at small degrees,
    and its global workspace, through it)."""
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
        grid = plan(w.shape[0], n, k, m, _build.sm_count(x.device), workspace)
        scratch = torch.empty(grid.workspace // 8, dtype=torch.float64, device=x.device) if grid.workspace else None
        table = _wave_table_on(x.device, k) if grid.form == "wave" else None
        lib = _build.load("polyfit_f64")
        with torch.cuda.device(x.device):
            err = lib.polyfit_f64(FORMS[grid.form], x.data_ptr(), rhs.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  w.shape[0], n, m, k, grid.tile, grid.tiles, cut_factor,
                                  None if scratch is None else scratch.data_ptr(),
                                  None if table is None else table.data_ptr(),
                                  len(wave_schedule(k).rows) if table is not None else 0,
                                  0 if table is None else table.numel(), grid.hold,
                                  torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"polyfit kernel launch failed with CUDA error {err}")
        polyfit.launches += 1
    out = out.reshape(*batch, k, m)
    return out if y.ndim > 1 else out[..., 0]


FORMS = {"register": 1, "general": 2, "wave": 3}  # the C entry's ``form``


@cache
def _wave_table_on(device: torch.device, k: int) -> torch.Tensor:
    """:func:`wave_table` on ``device``, uploaded once."""
    return torch.from_numpy(wave_table(k).view(np.int16)).to(device)


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
