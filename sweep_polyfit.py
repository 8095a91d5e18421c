#!/usr/bin/env python3
"""Times the float64 polyfit kernel (K3) against variants of itself.

The kernel's register form (``wtracker_tpu_torch/csrc/polyfit_f64.cu``,
the form deg 2 takes at these shapes) runs a weighting's serial setup (the
12-sweep Jacobi) in warp 0 beside the column work of warps 1-7, then solves
and stores its columns.  This script builds a copy
of the source for each variant below, with one change each, loads it with
the shipped entry point's C signature, and times it beside the shipped
kernel at the polyfit replay's shape (one weighting of N=5 samples, deg 2,
M=2) and the particle swarm's (P=100 weightings of N=8, deg 2, M=6,170):

- ``per_sm2``, ``per_sm3``: 2 or 3 blocks of 256 threads resident on an SM
  for deg <= 2 (the kernel has 4: at most 64 registers a thread), with
  ``ops/polyfit.py::plan`` sizing the tiles for that wave;
- ``store16``: each thread solves two neighbouring columns and writes each
  row of the pair as one 16-byte store (the kernel: one column, 8-byte
  stores); for an even M only, which both shapes are;
- ``unroll2``: the solve's loop over a thread's columns unrolled by two;
  these four are held bit for bit to the plain version at both shapes;
- ``no_jacobi``: no Jacobi sweep (the setup without its chain);
  ``no_store``: the solve runs but its result is not written (a store that
  never fires); ``no_rhs``: warps 1-7 form no right-hand side (no y read);
  ``no_solve``: each column's right-hand side is stored as it is (no
  projection, solve or unscaling); ``no_div``: the unscaling multiplies
  where it divides.  These are timing ablations: their outputs are wrong
  by construction and are not checked;
- ``timeline``: the shipped kernel with clock stamps at the ends of its
  phases (held bit for bit), read after one launch: where a block's time
  goes.

Then the wave form (deg 4-15) at deg 8, at the polyfit replay's shape
with 11 sample times (P=1, M=2) and the swarm's (P=100 weightings of
them, M=5,728, the WeightEvaluator's columns at those times), beside
these variants of it:

- ``wave_min2``: 2 blocks an SM (the kernel has 4 at K = 9);
- ``wave_no_hold``: no right-hand side formed beside the Jacobi (each
  column's formed and solved after it); these two are held bit for bit;
- ``wave_timeline``: the shipped kernel with clock stamps at each row of
  warp 0's program and at the ends of the eigenvectors and the columns
  (held bit for bit), read after one launch (block 0);
- ``wave_no_jacobi``: the Jacobi's program not run (the rows count 0);
  ``wave_no_scalars``: each rotation's scalars replaced by c = 1, s = 0
  (no quotient, root or reciprocal); ``wave_no_updates``: the rows of
  updates run, but update nothing; ``wave_no_vectors``: no eigenvector
  row rotated.  These are timing ablations, not checked.

Each time is a median of 50 calls, each after a spin and an L2 flush
(``chip_smoke.time_ms``), shipped first and last.  With ``--parent DIR``
(the parent commit's tree unpacked there, e.g. by ``git archive``) its K3
is timed too (``chip_smoke.parent_polyfit``).  The shipped library and the
main path are not touched.

Needs one CUDA card, ``nvcc`` and the checkout; run it from the checkout's
root as ``python3 sweep_polyfit.py [--parent DIR]``.  Prints the card line,
then one JSON line.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import SEED, card_line, parent_polyfit, time_ms

STORE = """  for (int c = threadIdx.x; c < cols; c += kThreads) {
    double b[K];"""
STORE_LINE = "      ob[static_cast<size_t>(i) * m + c] = quo(res, scl[i]);"
STORE16 = """  for (int c = 2 * threadIdx.x; c < cols; c += 2 * kThreads) {
    double res2[2][K];
    for (int h = 0; h < 2; ++h) {
    double b[K];
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = c + h < cols ? atb[j * tile + c + h] : 0.0;
    double scaled[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      double proj = mul(evecs[0][j], b[0]);
#pragma unroll
      for (int i = 1; i < K; ++i) proj = add(proj, mul(evecs[i][j], b[i]));
      scaled[j] = mul(inv[j], proj);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      double res = mul(evecs[i][0], scaled[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) res = add(res, mul(evecs[i][j], scaled[j]));
      res2[h][i] = quo(res, scl[i]);
    }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (c + 1 < cols) *reinterpret_cast<double2*>(ob + static_cast<size_t>(i) * m + c) = make_double2(res2[0][i], res2[1][i]);
      else ob[static_cast<size_t>(i) * m + c] = res2[0][i];
    }
  }
  if (false) {
    const int c = 0;
    double b[K];"""
# the timeline: per block, the card's clock at its start and end (ns) and the
# SM cycles from its start to the end of its setup, of lane 0's Jacobi, of
# the last right-hand side, of the meeting and of the last store
TIMELINE = [
    ("namespace {\n", """namespace {

__device__ unsigned long long g_stamps[8 * 4096];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  const int ct = static_cast<int>(threadIdx.x) - 32;  // a column thread's index, warps 1-7\n",
     """  const int ct = static_cast<int>(threadIdx.x) - 32;  // a column thread's index, warps 1-7
  __shared__ unsigned long long t_rhs, t_end;
  const long long t0 = clock64();
  unsigned long long* st = g_stamps + 8 * (blockIdx.x % 4096);
  if (threadIdx.x == 0) {
    t_rhs = 0;
    t_end = 0;
    st[0] = now_ns();
  }
"""),
    ("  for (int e = threadIdx.x; e < n * K; e += kThreads) lhs[e] = quo(lhs[e], scl[e % K]);\n  __syncthreads();\n",
     "  for (int e = threadIdx.x; e < n * K; e += kThreads) lhs[e] = quo(lhs[e], scl[e % K]);\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) st[1] = clock64() - t0;\n"),
    ("        for (int i = 0; i < K; ++i) evecs[i][j] = v[i][j];\n      }\n    }\n  } else {",
     "        for (int i = 0; i < K; ++i) evecs[i][j] = v[i][j];\n      }\n      st[2] = clock64() - t0;\n    }\n  } else {"),
    ("      for (int j = 0; j < K; ++j) atb[j * tile + c] = acc[j];\n    }\n  }\n  __syncthreads();\n",
     "      for (int j = 0; j < K; ++j) atb[j * tile + c] = acc[j];\n    }\n"
     "    atomicMax(&t_rhs, static_cast<unsigned long long>(clock64() - t0));\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n    st[3] = t_rhs;\n    st[4] = clock64() - t0;\n  }\n"),
    ("      ob[static_cast<size_t>(i) * m + c] = quo(res, scl[i]);\n    }\n  }\n}\n",
     "      ob[static_cast<size_t>(i) * m + c] = quo(res, scl[i]);\n    }\n  }\n"
     "  atomicMax(&t_end, static_cast<unsigned long long>(clock64() - t0));\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n    st[5] = t_end;\n    st[6] = now_ns();\n  }\n}\n"),
    ("}  // namespace\n", """}  // namespace

extern "C" int polyfit_stamps(void* dst, int count) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(unsigned long long) * count));
}
"""),
]
# the wave form's timeline (block 0): warp 0's SM clock at the start of each row of its program and at
# its end, warp 1's at the end of its eigenvector rows, thread 0's after the block's last column
WAVE_TIMELINE = [
    ("namespace {\n", """namespace {

__device__ unsigned g_wave_stamps[4100];
"""),
    ("  __shared__ int rows_done;", "  __shared__ int rows_done;\n  __shared__ unsigned row_stamps[1024];"),
    ("      unsigned s3 = row + 3 <= rows ? start[row + 3] : 0;\n      if (task & kScalars) {",
     "      unsigned s3 = row + 3 <= rows ? start[row + 3] : 0;\n"
     "      if (lane == 0 && row < 1024) row_stamps[row] = static_cast<unsigned>(clock64());\n      if (task & kScalars) {"),
    ("        scalars = (s1 & kScalarsRow) != 0;\n        wave_update(a, rot, r, e1, e2);",
     "        scalars = (s1 & kScalarsRow) != 0;\n"
     "        if (lane == 0 && row < 1024) row_stamps[row] = static_cast<unsigned>(clock64());\n"
     "        wave_update(a, rot, r, e1, e2);"),
    ("    if (lane == 0) *static_cast<volatile int*>(&rows_done) = 0x7fffffff;",
     "    if (lane == 0 && blockIdx.x == 0) {\n"
     "      for (int i = 0; i < rows && i < 1024; ++i) g_wave_stamps[i] = row_stamps[i];\n"
     "      g_wave_stamps[4096] = static_cast<unsigned>(clock64());\n    }\n"
     "    if (lane == 0) *static_cast<volatile int*>(&rows_done) = 0x7fffffff;"),
    ("      for (int r = 0, p = 0, q = 1; r < kRot; ++r) {",
     "      for (int r = 0, p = 0, q = 1; r <= kRot; ++r) {\n"
     "        if (r == kRot) {\n          if (lane == 0 && blockIdx.x == 0) g_wave_stamps[4097] = static_cast<unsigned>(clock64());\n"
     "          break;\n        }"),
    ("    column_solve<K>(b, evecs, inv, scl, ob + c, m);\n  }\n}",
     "    column_solve<K>(b, evecs, inv, scl, ob + c, m);\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) g_wave_stamps[4098] = static_cast<unsigned>(clock64());\n}"),
    ("}  // namespace\n", """}  // namespace

extern "C" int wave_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_wave_stamps, sizeof(unsigned) * 4100));
}
"""),
]
WAVE_VARIANTS = {  # name: (substitutions, the wave form's blocks an SM at K = 9 or None, checked, launch overrides)
    "wave_min2": ([("constexpr int kWaveMinBlocks[kWaveMaxK + 1] = {1, 4, 4, 4, 4, 4, 4, 3, 3, 4,",
                    "constexpr int kWaveMinBlocks[kWaveMaxK + 1] = {1, 4, 4, 4, 4, 4, 4, 3, 3, 2,")], 2, True, {}),
    "wave_no_hold": ([], None, True, {"hold": 0}),
    "wave_no_jacobi": ([], None, False, {"rows": 0}),
    "wave_no_scalars": ([("        const Rotation rt = rotation(a[p * K + p], apq, apq, a[q * K + q]);",
                          "        const Rotation rt = {1.0, 0.0, a[p * K + p], a[q * K + q]};")], None, False, {}),
    "wave_no_updates": ([("        wave_update(a, rot, r, e1, e2);\n", "")], None, False, {}),
    "wave_no_vectors": ([("      for (int r = 0, p = 0, q = 1; r < kRot; ++r) {",
                          "      for (int r = 0, p = 0, q = 1; r < 0; ++r) {")], None, False, {}),
    "wave_timeline": (WAVE_TIMELINE, None, True, {}),
}
VARIANTS = {  # name: (substitutions, blocks an SM for deg <= 2 or None, checked against the plain version)
    "per_sm2": ([("constexpr int kMinBlocks[5] = {1, 4, 4, 4,", "constexpr int kMinBlocks[5] = {1, 2, 2, 2,")], 2, True),
    "per_sm3": ([("constexpr int kMinBlocks[5] = {1, 4, 4, 4,", "constexpr int kMinBlocks[5] = {1, 3, 3, 3,")], 3, True),
    "store16": ([(STORE, STORE16)], None, True),
    "no_jacobi": ([("constexpr int kSweeps = 12;", "constexpr int kSweeps = 0;")], None, False),
    "no_store": ([(STORE_LINE, "      if (res == 1.25e-300) ob[static_cast<size_t>(i) * m + c] = quo(res, scl[i]);")], None, False),
    "no_rhs": ([("      for (int i0 = 0; i0 < n; i0 += kRows) {", "      for (int i0 = 0; i0 < 0; i0 += kRows) {")], None, False),
    "no_solve": ([(STORE_LINE, "      ob[static_cast<size_t>(i) * m + c] = b[i];")], None, False),
    "no_div": ([(STORE_LINE, "      ob[static_cast<size_t>(i) * m + c] = mul(res, scl[i]);")], None, False),
    "unroll2": ([(STORE, "#pragma unroll 2\n" + STORE)], None, True),
    "timeline": (TIMELINE, None, True),
}


def build_all(sources: dict, tmp: Path) -> dict:
    """One nvcc a variant, all started together, with K3's flags; returns
    each variant's entry point."""
    from wtracker_tpu_torch.ops import _build

    procs = {}
    for name, src in sources.items():
        (tmp / f"{name}.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.flags("polyfit_f64"), "-o", str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log}")
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).polyfit_f64
        fn.argtypes, fn.restype = _build.SIGNATURES["polyfit_f64"]
        fns[name] = fn
    return fns


@contextlib.contextmanager
def blocks_per_sm(tp, per_sm: int | None, deg: int):
    """``plan`` sized for ``per_sm`` blocks an SM: the register form's for
    deg <= 2, the wave form's at deg 8."""
    saved = tp.KERNEL_MIN_BLOCKS, tp.KERNEL_WAVE_MIN_BLOCKS
    if per_sm is not None and deg <= 2:
        tp.KERNEL_MIN_BLOCKS = (saved[0][0], per_sm, per_sm, per_sm, *saved[0][4:])
    elif per_sm is not None:
        tp.KERNEL_WAVE_MIN_BLOCKS = tuple(per_sm if k == deg + 1 else v for k, v in enumerate(saved[1]))
    try:
        yield
    finally:
        tp.KERNEL_MIN_BLOCKS, tp.KERNEL_WAVE_MIN_BLOCKS = saved


def launcher(fn, tp, per_sm, x, y, w, deg: int = 2, overrides: dict | None = None):
    """The wrapper's launch of library ``fn`` at ``deg``, its plan made once
    (``overrides`` replaces the wave form's ``rows`` or ``hold``)."""
    n, m, k = x.shape[0], y.shape[1], deg + 1
    w2 = w.reshape(-1, n)
    with blocks_per_sm(tp, per_sm, deg):
        grid = tp.plan(w2.shape[0], n, k, m, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((w2.shape[0], k, m), dtype=torch.float64, device="cuda")
    eps = torch.finfo(torch.float64).eps
    cut = max((n * eps) ** 2, 16 * eps)
    table = tp._wave_table_on(x.device, k) if grid.form == "wave" else None
    launch = {"rows": len(tp.wave_schedule(k).rows) if table is not None else 0, "hold": grid.hold, **(overrides or {})}

    def run():
        err = fn(tp.FORMS[grid.form], x.data_ptr(), y.data_ptr(), w2.data_ptr(), out.data_ptr(), w2.shape[0], n, m, k,
                 grid.tile, grid.tiles, cut, None, None if table is None else table.data_ptr(), launch["rows"],
                 0 if table is None else table.numel(), launch["hold"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    return run, {"tile": grid.tile, "tiles": grid.tiles, "blocks": grid.blocks, "per_sm": grid.per_sm, **launch}


def timeline(lib_dir: Path, run, blocks: int) -> dict:
    """One launch of the ``timeline`` variant after an L2 flush and a spin,
    as ``time_ms`` times it: each phase's end from its block's start (µs,
    at the SM clock that the block's own start and end on the card's
    clock imply), median and largest over the blocks, and the spread of
    the blocks' starts and ends on the card's clock."""
    stamps = ctypes.CDLL(str(lib_dir / "timeline.so")).polyfit_stamps
    stamps.argtypes, stamps.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda._sleep(1_000_000)
    run()
    torch.cuda.synchronize()
    count = 8 * min(blocks, 4096)
    host = np.zeros(count, np.uint64)
    if stamps(host.ctypes.data, count):
        raise RuntimeError("could not read the timeline")
    st = host.reshape(-1, 8).astype(np.float64)
    ns_per_cycle = (st[:, 6] - st[:, 0]) / np.maximum(st[:, 5], 1)
    out = {"ns_per_cycle_median": float(np.median(ns_per_cycle)),
           "starts_spread_us": float(st[:, 0].max() - st[:, 0].min()) / 1e3,
           "ends_spread_us": float(st[:, 6].max() - st[:, 6].min()) / 1e3,
           "first_start_to_last_end_us": float(st[:, 6].max() - st[:, 0].min()) / 1e3}
    for slot, name in ((1, "setup"), (2, "jacobi"), (3, "rhs"), (4, "meeting"), (5, "end")):
        us = st[:, slot] * ns_per_cycle / 1e3
        out[name] = {"median": float(np.median(us)), "max": float(us.max())}
    return out


def wave_timeline(lib_dir: Path, run, tp, k: int) -> dict:
    """One launch of the ``wave_timeline`` variant after an L2 flush and a
    spin: block 0's cycles a row of scalars and a row of updates (median
    and mean), the program's cycles in all, and the cycles from its end to
    the eigenvector lanes' end and to the last column's."""
    stamps = ctypes.CDLL(str(lib_dir / "wave_timeline.so")).wave_stamps
    stamps.argtypes, stamps.restype = [ctypes.c_void_p], ctypes.c_int
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda._sleep(1_000_000)
    run()
    torch.cuda.synchronize()
    host = np.zeros(4100, np.uint32)
    if stamps(host.ctypes.data):
        raise RuntimeError("could not read the wave timeline")
    sched = tp.wave_schedule(k)
    rows = len(sched.rows)
    if rows > 1024:
        raise ValueError(f"the wave timeline stamps 1,024 rows, not {rows}")
    ends = np.append(host[:rows].astype(np.int64), int(host[4096]))
    cycles = np.diff(ends) % (1 << 32)
    scalars = np.array([row[0][1] < 0 for row in sched.rows])
    return {"rows": rows, "scalar_rows": int(scalars.sum()), "program_cycles": int((ends[-1] - ends[0]) % (1 << 32)),
            "scalar_row_cycles": {"median": float(np.median(cycles[scalars])), "mean": float(cycles[scalars].mean())},
            "update_row_cycles": {"median": float(np.median(cycles[~scalars])), "mean": float(cycles[~scalars].mean())},
            "vectors_end_after_program": _signed(int(host[4097]) - int(host[4096])),
            "columns_end_after_program": _signed(int(host[4098]) - int(host[4096]))}


def _signed(cycles: int) -> int:
    """A difference of two 32-bit clock stamps."""
    cycles %= 1 << 32
    return cycles - (1 << 32) if cycles >= 1 << 31 else cycles


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_polyfit: no CUDA card is visible", file=sys.stderr)
        return 2
    import importlib

    tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")
    root = Path(__file__).resolve().parent
    source = (root / "wtracker_tpu_torch" / "csrc" / "polyfit_f64.cu").read_text()
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    rng = np.random.default_rng(SEED)

    def track(t, m):
        return torch.from_numpy(180 + 2.5 * t[:, None] + 0.1 * t[:, None] ** 2 + rng.normal(0, 3, (len(t), m))).cuda()

    t5, t8 = np.array([-15.0, -10.0, -5.0, 0.0, 3.0]), np.array([-30.0, -25.0, -20.0, -15.0, -10.0, -5.0, 0.0, 3.0])
    t11 = np.arange(-40.0, 1.0, 4.0)
    shapes = {  # name: (x, y, w, deg, the variants timed there)
        "replay": (torch.from_numpy(t5).cuda(), track(t5, 2), torch.ones(1, 5, dtype=torch.float64, device="cuda"), 2,
                   tuple(VARIANTS)),
        "swarm": (torch.from_numpy(t8).cuda(), track(t8, 6170), torch.from_numpy(rng.uniform(1e-6, 5.0, (100, 8))).cuda(),
                  2, tuple(VARIANTS)),
        "replay_deg8": (torch.from_numpy(t11).cuda(), track(t11, 2), torch.ones(1, 11, dtype=torch.float64, device="cuda"),
                        8, tuple(WAVE_VARIANTS)),
        "swarm_deg8": (torch.from_numpy(t11).cuda(), track(t11, 5728),
                       torch.from_numpy(rng.uniform(1e-6, 5.0, (100, 11))).cuda(), 8,
                       tuple(v for v in WAVE_VARIANTS if v != "wave_timeline")),  # its stamps' shared memory cuts residency
    }
    variants = {**{k: (*v, {}) for k, v in VARIANTS.items()}, **WAVE_VARIANTS}
    for sub in variants.values():
        for old, _ in sub[0]:
            if source.count(old) != 1:
                raise RuntimeError(f"the kernel source changed: {old!r} is not found once")
    results = {}
    with tempfile.TemporaryDirectory(prefix="sweep_polyfit_") as tmp:
        sources = {"shipped": source}
        for name, (subs, _, _, _) in variants.items():
            if subs:
                sources[name] = source
                for old, new in subs:
                    sources[name] = sources[name].replace(old, new)
        fns = build_all(sources, Path(tmp))
        libs = {"shipped": (fns["shipped"], None, True, {}),
                **{k: (fns.get(k, fns["shipped"]), v[1], v[2], v[3]) for k, v in variants.items()}}
        old_fit = parent_polyfit(parent, Path(tmp)) if parent is not None else None
        for shape, (x, y, w, deg, timed) in shapes.items():
            want = tp.polyfit_reference(x, y, deg, w)
            row = {}
            for name in ("shipped", *timed, "shipped"):
                fn, per_sm, checked, overrides = libs[name]
                run, grid = launcher(fn, tp, per_sm, x, y, w, deg, overrides)
                got = run()
                torch.cuda.synchronize()
                same = bool(torch.equal(got.view(torch.int64), want.view(torch.int64)))
                if checked and not same:
                    raise AssertionError(f"{name} differs from the plain version at the {shape} shape")
                entry = row.setdefault(name, {"ms": [], "plan": grid, "checked": checked, "bits_equal": same})
                entry["ms"].append(time_ms(run))
                if name == "timeline":
                    entry["phases_us"] = timeline(Path(tmp), run, grid["blocks"])
                if name == "wave_timeline":
                    entry["cycles"] = wave_timeline(Path(tmp), run, tp, deg + 1)
            if old_fit is not None:
                row["parent"] = {"ms": [time_ms(lambda: old_fit(x, y, w, deg))]}
            results[shape] = row
    print(card_line())
    print(json.dumps({"sweep_polyfit": results, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
