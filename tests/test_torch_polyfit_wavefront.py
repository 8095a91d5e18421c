"""K3's wave form on the CPU: the schedule of its Jacobi and an emulation of
the kernel's arithmetic in its order, against the plain version.

The wave form (``csrc/polyfit_f64.cu::polyfit_wave``) runs the plain
version's rotations (``ops/polyfit.py::jacobi_eigh``) as a wavefront: the
table it reads (``ops/polyfit.py::wave_table``) holds, row after row, the
rotations whose scalars a row computes and the updates of matrix entries it
applies, one task a lane.  Here the schedule's rules are checked for k =
1-16, the table is decoded as the kernel decodes it, and a numpy emulation
of the kernel (the same rounded operations, the upper triangle only, the
eigenvector rows rotated after the fact from the stored scalars, each
column solved in one pass) is held to the plain version bit for bit: the
eigendecomposition on seeded normal matrices (full rank, rank-deficient,
all zero, a pivot below ``DBL_MIN``), and the whole fit at deg 0-15.  The
plain version is held to the JAX package by ``tests/test_torch_polyfit.py``,
``test_torch_polyfit_kernel.py`` and ``test_torch_polyfit_degrees.py``; the
kernel itself to the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")  # the package's ``polyfit`` name is the function

TINY = np.finfo(np.float64).tiny


def _decode(k: int):
    """``wave_table(k)`` read as the kernel reads it: each rotation's scalar
    row, each row's kind (scalars or updates) and tasks: ``(r, p, q)`` for
    rotation r's scalars, ``(r, e1, e2)`` for its update of the stored
    entries e1 and e2 (flat upper-triangle indices)."""
    table = tp.wave_table(k).astype(np.int64)
    n_rot = tp.SWEEPS * k * (k - 1) // 2
    n_rows = len(tp.wave_schedule(k).rows)
    ready, start = table[:n_rot], table[n_rot : n_rot + n_rows + 1]
    words = tp.wave_table(k)[(n_rot + n_rows + 2) // 2 * 2 :].view(np.uint32).astype(np.int64)
    first = start & 0x7FFF
    rows = [((s0 & 0x8000) != 0, [((w >> 18) & 0x1FFF, (w >> 9) & 0x1FF, w & 0x1FF, (w >> 31) == 1) for w in words[a:b]])
            for s0, a, b in zip(start[:-1], first[:-1], first[1:])]
    assert len(table) % 4 == 0 and not words[first[-1]:].any() and not start[-1] & 0x8000
    return [int(v) - 1 for v in ready], rows


@pytest.mark.parametrize("k", range(1, 17))
def test_schedule_is_an_exact_wavefront_of_the_cyclic_order(k):
    """Every rotation of 12 sweeps once, in jacobi_eigh's order; a row's
    tasks are all scalars or all updates, touch disjoint entries (so the
    rotations of a row share no index) and are at most a warp; each rotation's scalars after every earlier task
    on its pivot entries, each update after its rotation's scalars, and each
    entry's tasks in cyclic order; every task a later rotation's scalars
    read is there; the table decodes to the schedule."""
    sched = tp.wave_schedule(k)
    rotations = [(p, q) for _ in range(tp.SWEEPS) for p in range(k - 1) for q in range(p + 1, k)]
    assert list(sched.rotations) == rotations
    ready, decoded = _decode(k)
    assert ready == list(sched.scalar_row) and len(decoded) == len(sched.rows)
    for (scalars, words), row in zip(decoded, sched.rows):  # a row is all scalars or all updates, as flagged
        assert all(s == scalars for *_, s in words) and [r for r, *_ in words] == [r for r, _ in row]
        for (r, e1, e2, s), (_, j) in zip(words, row):
            p, q = rotations[r]
            assert (e1, e2) == ((p, q) if s else tuple(i * k + j for i, j in tp._entries(p, q, j)))
    rows = [list(row) for row in sched.rows]
    row_of = {task: i for i, row in enumerate(rows) for task in row}
    assert len(row_of) == sum(map(len, rows))  # no task twice
    assert sorted(r for r, j in row_of if j < 0) == list(range(len(rotations)))
    for r, row in enumerate(sched.scalar_row):
        assert row_of[r, -1] == row
    for row in rows:
        assert 1 <= len(row) <= 32 and len({j < 0 for _, j in row}) == 1
        touched = [e for r, j in row for e in tp._entries(*rotations[r], j)]
        assert len(touched) == len(set(touched))
    order = {}  # the cyclic order of every task: a rotation's scalars, then its updates by j
    for r, (p, q) in enumerate(rotations):
        for j in [-1] + [j for j in range(k) if j not in (p, q)]:
            order[r, j] = len(order)
    last = {}
    for (r, j), _ in sorted(order.items(), key=lambda item: item[1]):
        p, q = rotations[r]
        if j < 0:  # what the scalars read is final, its last writer scheduled before them
            for e in tp._entries(p, q, j):
                if e in last:
                    assert last[e] in row_of and row_of[last[e]] < row_of[r, j], (e, last[e], (r, j))
        elif (r, j) in row_of:
            assert row_of[r, j] > row_of[r, -1]
        if (r, j) in row_of or j < 0:
            for e in tp._entries(p, q, j):
                last[e] = (r, j)
    per_entry = {}
    for t, row in row_of.items():
        for e in tp._entries(*rotations[t[0]], t[1]):
            per_entry.setdefault(e, []).append((row, order[t]))
    for e, mine in per_entry.items():  # each entry's tasks in cyclic order
        mine.sort()
        assert [o for _, o in mine] == sorted(o for _, o in mine), e
    n_scalar_rows = len({row for row in sched.scalar_row})
    if k >= 3:  # the closed form: rotation (p, q) of sweep s in step s k + p + q - 1
        steps = sorted(set(sched.scalar_row))
        for r, (p, q) in enumerate(rotations):
            assert steps.index(sched.scalar_row[r]) == r // (k * (k - 1) // 2) * k + p + q - 1
        assert n_scalar_rows == 13 * k - 3 if k >= 4 else n_scalar_rows == len(rotations)
    assert max((sum(j < 0 for _, j in row) for row in rows), default=0) <= max(k // 2, 1)


def _rotation(app, apq, aqp, aqq):
    """The kernel's ``rotation``: c, the selected s and the new a[p][p] and
    a[q][q], with its reciprocal form of sign(tau) / (|tau| + root)."""
    rotate = np.abs(apq) > TINY
    tau = (aqq - app) / (2.0 * np.where(rotate, apq, 1.0))
    root = np.sqrt(tau * tau + 1.0)
    sgn = (0.0 < tau).astype(np.float64) - (tau < 0.0)
    r = 1.0 / np.where(sgn == 0.0, tau + root, np.abs(tau) + root)
    t = np.where(sgn < 0.0, -r, r)
    c_rot = 1.0 / np.sqrt(t * t + 1.0)
    c, s = np.where(rotate, c_rot, 1.0), np.where(rotate, t * c_rot, 0.0)
    ms_p, ms_q = s * -1.0, s * 1.0
    rpp, rpq = c * app + ms_p * aqp, c * apq + ms_p * aqq
    rqp, rqq = c * aqp + ms_q * app, c * aqq + ms_q * apq
    return c, s, c * rpp + ms_p * rpq, c * rqq + ms_q * rqp


def _wave_eigh(a: np.ndarray):
    """The kernel's Jacobi on a batch (..., k, k): warp 0's rows from the
    decoded table on the upper triangle (a row of scalars runs only its
    scalars, a row of updates only its updates), then the eigenvector rows
    rotated by each rotation's stored c, −s and s in cyclic order."""
    k = a.shape[-1]
    flat = np.triu(a).reshape(*a.shape[:-2], k * k).copy()
    _, rows = _decode(k)
    rot = {}
    with np.errstate(all="ignore"):
        for scalars, words in rows:
            for r, e1, e2, s in words:
                if scalars and s:
                    p, q = e1, e2
                    apq = flat[..., p * k + q]
                    c, s_sel, flat[..., p * k + p], flat[..., q * k + q] = _rotation(flat[..., p * k + p], apq, apq,
                                                                                     flat[..., q * k + q])
                    flat[..., p * k + q] = 0.0
                    rot[r] = c, s_sel * -1.0, s_sel * 1.0
                elif not scalars and not s:
                    c, ms_p, ms_q = rot[r]
                    xp, xq = flat[..., e1].copy(), flat[..., e2].copy()
                    flat[..., e1], flat[..., e2] = c * xp + ms_p * xq, c * xq + ms_q * xp
        v = np.broadcast_to(np.eye(k), a.shape).copy()
        rotations = tp.wave_schedule(k).rotations
        for r, (p, q) in enumerate(rotations):
            c, ms_p, ms_q = (x[..., None] for x in rot[r])
            vp, vq = v[..., :, p].copy(), v[..., :, q].copy()
            v[..., :, p], v[..., :, q] = c * vp + ms_p * vq, c * vq + ms_q * vp
    return np.diagonal(flat.reshape(a.shape), axis1=-2, axis2=-1).copy(), v


def _normal_matrices(k: int) -> np.ndarray:
    """Seeded normal matrices: full rank, rank-deficient, all zero, one whose
    first pivot is below DBL_MIN, one with a zeroed column."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(5, k + 3, k))
    a[1, :, -1] = 3.0 * a[1, :, 0]
    a[1, 2:] = 0.0
    a[2] = 0.0
    a[4, :, k // 2] = 0.0
    m = a.transpose(0, 2, 1) @ a
    m = (m + m.transpose(0, 2, 1)) / 2  # exactly symmetric
    if k > 1:
        m[3, 0, 1] = m[3, 1, 0] = 1e-310
    return m


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).view(np.int64)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16])
def test_the_kernels_order_gives_the_plain_versions_bits(k):
    """Eigenvalues and eigenvectors of the emulated wave form = jacobi_eigh's,
    bit for bit."""
    m = _normal_matrices(k)
    want_w, want_v = tp.jacobi_eigh(torch.from_numpy(m))
    got_w, got_v = _wave_eigh(m)
    np.testing.assert_array_equal(_bits(got_w), _bits(want_w.numpy()))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))


@pytest.mark.parametrize("k", [2, 3, 5, 9, 16])
def test_the_plain_version_keeps_the_matrix_symmetric(k):
    """jacobi_eigh's matrix equals its transpose bit for bit before and
    after every rotation (what lets the kernel keep one triangle)."""
    m = torch.from_numpy(_normal_matrices(k))
    count = 0
    for a, _ in tp.jacobi_rotations(m):
        assert torch.equal(a.view(torch.int64), a.transpose(-1, -2).view(torch.int64)), count
        count += 1
    assert count == 1 + tp.SWEEPS * k * (k - 1) // 2


def _wave_fit(x, y, deg, w):
    """The whole wave-form fit as the kernel computes it, numpy: x (N,), y
    (N, M), w (P, N) -> (P, deg + 1, M)."""
    n, k = len(x), deg + 1
    van = np.ones((n, k))
    for j in range(1, k):
        van[:, j] = van[:, j - 1] * x
    lhs = van[None] * w[:, :, None]
    ss = lhs[:, 0] * lhs[:, 0]
    for i in range(1, n):
        ss = ss + lhs[:, i] * lhs[:, i]
    scl = np.sqrt(ss)
    scl = np.where(scl == 0.0, 1.0, scl)
    lhs = lhs / scl[:, None, :]
    ata = lhs[:, 0, :, None] * lhs[:, 0, None, :]
    for i in range(1, n):
        ata = ata + lhs[:, i, :, None] * lhs[:, i, None, :]
    ev, v = _wave_eigh(ata)
    ev = np.where(np.isnan(ev), ev, np.maximum(ev, 0.0))
    eps = np.finfo(np.float64).eps
    cutoff = ev.max(axis=-1, keepdims=True) * max((n * eps) ** 2, 16 * eps)
    with np.errstate(divide="ignore"):
        inv = np.where(ev > cutoff, 1.0 / ev, 0.0)
    rhs = y[None] * w[:, :, None]  # (P, N, M)
    b = lhs[:, 0, :, None] * rhs[:, 0, None, :]
    for i in range(1, n):
        b = b + lhs[:, i, :, None] * rhs[:, i, None, :]
    proj = v[:, 0, :, None] * b[:, 0, None, :]
    for i in range(1, k):
        proj = proj + v[:, i, :, None] * b[:, i, None, :]
    sc = inv[:, :, None] * proj
    res = v[:, :, 0, None] * sc[:, 0, None, :]
    for j in range(1, k):
        res = res + v[:, :, j, None] * sc[:, j, None, :]
    return res / scl[:, :, None]


@pytest.mark.parametrize("deg", range(16))
def test_the_kernels_whole_fit_gives_the_plain_versions_bits(deg):
    """Setup, wavefront, cutoff and one-pass columns, emulated, = the plain
    polyfit bit for bit: three weightings (full, two samples zeroed, all
    but two zeroed) and an all-masked one over 11 or 16 sample times."""
    x = np.arange(-60.0, 1.0, 4.0) if deg >= 9 else np.arange(-40.0, 1.0, 4.0)
    rng = np.random.default_rng(deg)
    y = 180 + 2.5 * x[:, None] + 0.1 * x[:, None] ** 2 + rng.normal(0, 3, (len(x), 3))
    w = rng.uniform(0.2, 2.0, (4, len(x)))
    w[1, [1, 3]] = 0.0
    w[2, 2:] = 0.0
    w[3] = 0.0
    want = tp.polyfit_reference(torch.from_numpy(x), torch.from_numpy(y), deg, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_bits(_wave_fit(x, y, deg, w)), _bits(want))


@pytest.mark.parametrize("k", range(1, 17))
def test_plan_forces_the_wave_form_at_every_k(k):
    """The wave form's plan at every k it takes (at k <= 4 ``plan`` routes
    it only rows beyond 48 KB), its shared memory the rows (while they fit;
    beyond them each thread's k sums), the table and the right-hand sides of
    as many of a block's columns as the rest of an SM's share holds; k = 17
    goes to the general form."""
    for n, p, m in ((11, 1, 2), (11, 100, 5728), (8, 100, 6170), (2000, 3, 5)):
        grid = tp._plan_wave(p, n, k, m, 132)
        assert tp.plan(p, n, k, m, 132) == grid or tp.register_form(n, k)
        rows = 8 * n * (k + 1) if 8 * n * (k + 1) <= tp.KERNEL_GENERAL_ROWS else 8 * k * tp.KERNEL_THREADS
        assert grid.form == "wave" and grid.shared == rows + 2 * tp.wave_table(k).size + 8 * k * grid.hold
        assert grid.per_sm * (grid.shared + tp.wave_static(k) + tp.BLOCK_RESERVED) <= tp.SM_SHARED
        assert 0 <= grid.hold <= grid.tile and (grid.hold == grid.tile or grid.per_sm * (
            grid.shared + 8 * k + tp.wave_static(k) + tp.BLOCK_RESERVED) > tp.SM_SHARED)  # as many as fit
        assert grid.tiles * grid.tile >= m > (grid.tiles - 1) * grid.tile and grid.blocks == p * grid.tiles
    assert tp.plan(1, 11, 17, 2, 132).form == "general"
