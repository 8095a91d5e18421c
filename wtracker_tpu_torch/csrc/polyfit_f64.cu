// Weighted polynomial least squares in float64, one launch a call, for sm_90a.
//
// Replaces the work XLA lowers for wtracker_tpu/ops/polyfit.py :: polyfit
// (-> lstsq_minnorm -> jacobi_eigh): the Vandermonde matrix, the weights,
// numpy's column scaling, the normal matrix and right-hand side, 12 sweeps
// of cyclic Jacobi rotations, the eigenvalue cutoff, the min-norm solve and
// the unscaling.  The plain PyTorch version is
// wtracker_tpu_torch/ops/polyfit.py :: polyfit_reference, and this kernel
// gives its bits exactly: the replay engine's bboxes.csv on the card must be
// the CPU's text byte for byte.
//
// Why a kernel: torch has no op that gives these bits (torch.linalg.eigh and
// lstsq compute another decomposition), and the plain version is ~1,500
// eager launches a degree-2 fit, ~1,480 of them the Jacobi rotations.
//
// What bounds it on the H100.  A call has two parts of different shapes.
// * The setup of a weighting (its scaled Vandermonde rows, the k x k normal
//   matrix, 12 Jacobi sweeps, the cutoff) is a few thousand operations in
//   one serial chain: a rotation's scalars wait for the rotations before it
//   that share an index, and hold a quotient, two square roots and two
//   reciprocals, each tens of cycles deep.  At deg 2 its 36 rotations take
//   ~13 us on one lane, whatever the thread count; at deg 8 the wave form
//   below runs its 432 in 114 steps.
// * The columns (right-hand side, projection, solve, unscaling) are
//   independent of each other: at the particle swarm's shape (100
//   weightings, N=8, 6,170 columns) ~60 M float64 operations and the
//   14.8 MB (P, k, M) result, whose write is the call's bound, ~4.5 us
//   (chip_smoke.py::polyfit_work counts both).
// So the chain bounds the kernel at both shapes: at the replay's (1
// weighting, N=5, 2 columns) it is the kernel beside the launch; at the
// swarm's the right-hand sides run beside it and the solve and the write
// come after it (sweep_polyfit.py's timelines and ablations, PERF.md).
//
// The design.
// * The grid is weightings x column tiles, flattened: block b fits
//   weighting b / tiles on columns [(b % tiles) * tile, + tile).
//   ops/polyfit.py :: plan picks the tile so that the batch fills about one
//   wave of blocks (kMinBlocks[K] resident on each SM, held by
//   __launch_bounds__), so every block's setup chain runs at the same time
//   and each thread holds a few columns.
// * Each block computes its own weighting's setup: the blocks of one
//   weighting run the same chain side by side, so its latency is paid once
//   a wave.  Sharing it over a cluster through distributed shared memory
//   would save only its operations (~3 % of the swarm's) and add a cluster
//   barrier to the chain.
// * Warp 0 runs the setup: its lanes form the normal matrix's k^2 entries
//   at once, lane 0 runs the Jacobi in registers (K = deg + 1 is a template
//   parameter, so the arrays unroll).  Meanwhile warps 1-7 form their
//   columns' right-hand sides A^T (w y) into shared memory, each column's y
//   loads issued kRows at a time ahead of their use (a thread's first ones
//   before the setup starts).  The block meets once; then all its threads
//   project, solve, unscale and store their columns, coalesced.
// * The chain itself is shorter than a plain reading of the plain version:
//   1 / x is __drcp_rn (IEEE 1 / x), and sign(tau) / d is the reciprocal of
//   d with tau's sign (round to nearest is symmetric), so a rotation holds
//   one quotient where it held three.
//
// Exactness.  The plain version runs one torch op a step, so each product,
// sum, quotient and square root is rounded on its own.  Here every such step
// is an explicit round-to-nearest intrinsic (__dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn, __drcp_rn, __dsqrt_rn), and the file is also
// compiled with --fmad=false, so no product and sum contract into an FMA.
// Division, reciprocal and square root are IEEE on both sides (torch's
// reciprocal() is 1 / x, and a tensor divided by a tensor is a / b; no
// division by a Python number appears in the fit).  Sums run in the plain
// version's order, ((x0 + x1) + x2) + ..., starting from the first term (so
// a -0.0 stays -0.0), and each column's sums stay inside one thread, so the
// tiling reorders none.  Rotations whose pivot is below DBL_MIN are
// selected away as torch.where does, after the same arithmetic, and rows
// and columns update as c*x + (-+s)*x_flipped.
//
// Three forms, one entry point that takes the form as its first argument;
// ops/polyfit.py :: plan picks it.  The register form above
// (polyfit_kernel<K>) holds lane 0's Jacobi and each column's K sums in
// registers; it takes K <= 4 (deg <= 3: deg 2 is the deployed fit; from deg
// 4 the wave form timed faster) and rows that fit 48 KB.  The wave form
// (polyfit_wave<K>, K <= 16) takes every other call up to deg 15:
// * Its Jacobi is an exact wavefront of the plain version's cyclic order.
//   Rotation (p, q) reads only a[p][p], a[p][q] and a[q][q], so its scalars
//   can run once the rotations before it that share p or q are applied,
//   while others go on: for K >= 3 the rotations of one anti-diagonal,
//   step s K + p + q - 1 of sweep s, share no index and run together, 13K -
//   3 steps for 12 sweeps (114 at K = 9, against 432 rotations).  Each
//   matrix entry still takes its own updates in the plain version's order,
//   from the same values, so every rounded operation is the one
//   jacobi_eigh does.  ops/polyfit.py :: wave_schedule lays the steps out
//   as rows of tasks, one to a lane of warp 0 and a __syncwarp after each:
//   a row of scalars (each lane a rotation's c, s and new diagonal, as
//   jacobi_warp computes them), then the rows of pair updates (a[p][j],
//   a[q][j]) that the next step's scalars need, each in the first row
//   after everything it follows; wave_table packs them, and the block
//   copies the table to shared memory.  The plain version keeps the matrix
//   bitwise symmetric after every rotation, so only the upper triangle is
//   stored.  The rows of updates run in a loop of their own with no
//   branch (an idle lane updates a spare entry by a spare rotation), each
//   lane reading and decoding its next task while it runs this one's.
// * The eigenvectors are off the chain: each rotation's c, -s and s are
//   kept, and warp 1's lane i rotates row i of v in cyclic order beside the
//   Jacobi, each rotation once warp 0 has published its scalars' row.
// * The columns go in one pass: while warp 0 runs the Jacobi, warps 2-7
//   form the right-hand sides of the block's first `hold` columns (as many
//   as the SM's shared memory holds) into shared memory; after it every
//   thread takes its columns, forms the rest's right-hand sides, projects,
//   solves and unscales each over all K terms in registers.
// * The weighting and the scaled rows stay in shared memory while they fit
//   kGeneralRows; beyond it each entry is recomputed where it is read, as
//   the same chain of rounded operations (x^j as j products, times w, over
//   scl[j]), so it has the stored bits, and each thread's sums then wait in
//   its slice of shared memory across the quotients.
// The general form (polyfit_general, K a runtime argument) takes deg >= 16:
// warp 0 runs the rotations one after another on the k x k matrix in shared
// memory (every lane computes the rotation's scalars, lane j updates entry j
// of rows and columns p and q), warps 1-7 form right-hand sides into the
// output's columns meanwhile, and each thread solves its columns a kChunk of
// terms at a time; its matrices live in a global workspace where they do not
// fit a block's shared memory.  So every k >= 1 and n >= 1 fits, in one
// launch, with the same bits.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;  // warp 0 the setup, warps 1-7 the right-hand sides
constexpr int kColThreads = kThreads - 32;
constexpr int kRows = 8;  // y rows whose loads a column thread issues together
constexpr int kSweeps = 12;  // jacobi_eigh's default
// blocks of kThreads resident on an SM, by K = deg + 1 (__launch_bounds__:
// at most 64 registers a thread for K <= 3, 128 for K = 4; lane 0 holds
// the Jacobi's 2 K^2 doubles)
constexpr int kMinBlocks[5] = {1, 4, 4, 4, 2};
// the general form: terms a thread sums at once, the bytes of weighting and
// scaled rows it keeps in shared memory, blocks resident on an SM
constexpr int kChunk = 8;
constexpr size_t kGeneralRows = 48u << 10;
constexpr int kGeneralMinBlocks = 4;
// the wave form: its largest K (deg 15), its blocks resident on an SM by K (at
// most 64, 85 or 128 registers a thread: the most blocks whose build spills
// nothing), the threads that form right-hand sides beside the Jacobi (warps 2-7)
constexpr int kWaveMaxK = 16;
constexpr int kWaveMinBlocks[kWaveMaxK + 1] = {1, 4, 4, 4, 4, 4, 4, 3, 3, 4, 3, 2, 2, 2, 2, 2, 2};
constexpr int kWaveColThreads = kThreads - 64;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }

__device__ __forceinline__ bool is_nan(double v) { return v != v; }

// torch.sign: (0 < v) - (v < 0), so +0.0 for a zero or a NaN
__device__ __forceinline__ double sign_of(double v) { return static_cast<double>((0.0 < v) - (v < 0.0)); }

// Jacobi eigendecomposition of the symmetric a (in place: its diagonal ends
// as the eigenvalues) with eigenvectors in v's columns, as
// ops/polyfit.py :: jacobi_eigh rotation for rotation.
template <int K>
__device__ void jacobi(double (&a)[K][K], double (&v)[K][K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < K - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < K; ++q) {
        const double apq = a[p][q], app = a[p][p], aqq = a[q][q];
        const bool rotate = fabs(apq) > DBL_MIN;
        const double safe_apq = rotate ? apq : 1.0;
        const double tau = quo(sub(aqq, app), mul(2.0, safe_apq));
        const double root = __dsqrt_rn(add(mul(tau, tau), 1.0));
        const double sgn = sign_of(tau);
        // t = 1 / (tau + root) where sign(tau) is 0, else sign(tau) / (|tau| + root)
        const double r = rcp(sgn == 0.0 ? add(tau, root) : add(fabs(tau), root));
        const double t = sgn < 0.0 ? -r : r;
        const double c_rot = rcp(__dsqrt_rn(add(mul(t, t), 1.0)));
        const double s = mul(t, c_rot);
        const double c = rotate ? c_rot : 1.0;
        const double s_sel = rotate ? s : 0.0;
        const double ms_p = mul(s_sel, -1.0), ms_q = mul(s_sel, 1.0);  // (-s, s)

        // a <- G^T a G on rows/cols p, q, then the pivot pair zeroed
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const double xp = a[p][j], xq = a[q][j];
          a[p][j] = add(mul(c, xp), mul(ms_p, xq));
          a[q][j] = add(mul(c, xq), mul(ms_q, xp));
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const double xp = a[i][p], xq = a[i][q];
          a[i][p] = add(mul(c, xp), mul(ms_p, xq));
          a[i][q] = add(mul(c, xq), mul(ms_q, xp));
        }
        a[p][q] = 0.0;
        a[q][p] = 0.0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const double xp = v[i][p], xq = v[i][q];
          v[i][p] = add(mul(c, xp), mul(ms_p, xq));
          v[i][q] = add(mul(c, xq), mul(ms_q, xp));
        }
      }
    }
  }
}

// rows i0 .. i0 + kRows - 1 of one y column (0.0 past row n), loads issued together
__device__ __forceinline__ void load_rows(double (&v)[kRows], const double* col, int i0, int n, int m) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = i0 + r < n ? __ldg(col + static_cast<size_t>(i0 + r) * m) : 0.0;
}

// x (n,), y (n, m), w (P, n) -> out (P, K, m), in blocks of `tile` columns,
// `tiles` a weighting; cut_factor is max(rcond^2, 16 eps) with rcond = n eps,
// computed by the wrapper as the plain version computes it.
template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks[K])
    polyfit_kernel(const double* __restrict__ x, const double* __restrict__ y, const double* __restrict__ w,
                   double* __restrict__ out, int n, int m, int tile, int tiles, double cut_factor) {
  extern __shared__ double smem[];
  double* ws = smem;          // (n,): the weighting
  double* lhs = ws + n;       // (n, K): the weighted Vandermonde rows, then scaled
  double* atb = lhs + n * K;  // (K, tile): the block's right-hand sides
  __shared__ double scl[K], inv[K], evecs[K][K], ata[K * K];
  const int fit = blockIdx.x / tiles;
  const int col0 = (blockIdx.x - fit * tiles) * tile;
  const int cols = min(tile, m - col0);
  const double* wb = w + static_cast<size_t>(fit) * n;
  const double* yb = y + col0;
  const int ct = static_cast<int>(threadIdx.x) - 32;  // a column thread's index, warps 1-7

  double ys[kRows];
  if (ct >= 0 && ct < cols) load_rows(ys, yb + ct, 0, n, m);  // in flight through the setup

  for (int i = threadIdx.x; i < n; i += kThreads) ws[i] = wb[i];
  for (int e = threadIdx.x; e < n * K; e += kThreads) {
    const int i = e / K, j = e - i * K;
    const double xi = x[i];
    double van = 1.0;  // x^j as x^(j-1) * x
    for (int d = 0; d < j; ++d) van = mul(van, xi);
    lhs[e] = mul(van, wb[i]);
  }
  __syncthreads();
  if (threadIdx.x < K) {  // column scaling, as numpy's polyutils._fit
    const int j = threadIdx.x;
    double ss = mul(lhs[j], lhs[j]);
    for (int i = 1; i < n; ++i) ss = add(ss, mul(lhs[i * K + j], lhs[i * K + j]));
    const double r = __dsqrt_rn(ss);
    scl[j] = r == 0.0 ? 1.0 : r;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * K; e += kThreads) lhs[e] = quo(lhs[e], scl[e % K]);
  __syncthreads();

  if (ct < 0) {  // warp 0: the normal matrix, one entry a lane, then lane 0's Jacobi
    for (int e = threadIdx.x; e < K * K; e += 32) {
      const int p = e / K, q = e - p * K;
      double acc = mul(lhs[p], lhs[q]);
      for (int i = 1; i < n; ++i) acc = add(acc, mul(lhs[i * K + p], lhs[i * K + q]));
      ata[e] = acc;
    }
    __syncwarp();
    if (threadIdx.x == 0) {
      double a[K][K], v[K][K];
#pragma unroll
      for (int p = 0; p < K; ++p) {
#pragma unroll
        for (int q = 0; q < K; ++q) a[p][q] = ata[p * K + q];
      }
      jacobi<K>(a, v);
      double ev[K];
#pragma unroll
      for (int j = 0; j < K; ++j) ev[j] = is_nan(a[j][j]) ? a[j][j] : fmax(a[j][j], 0.0);  // clamp_min(0.0)
      double top = ev[0];  // amax: a NaN wins
#pragma unroll
      for (int j = 1; j < K; ++j) {
        if (!is_nan(top) && (is_nan(ev[j]) || ev[j] > top)) top = ev[j];
      }
      const double cutoff = mul(top, cut_factor);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        inv[j] = ev[j] > cutoff ? rcp(ev[j]) : 0.0;
#pragma unroll
        for (int i = 0; i < K; ++i) evecs[i][j] = v[i][j];
      }
    }
  } else {  // warps 1-7: atb = A^T (w y) for the block's columns, summed over the samples in order
    for (int c = ct; c < cols; c += kColThreads) {
      const double* yc = yb + c;
      double acc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = 0.0;
      for (int i0 = 0; i0 < n; i0 += kRows) {
        if (c != ct || i0 != 0) load_rows(ys, yc, i0, n, m);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          if (i < n) {
            const double rhs = mul(ys[r], ws[i]);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              const double term = mul(lhs[i * K + j], rhs);
              acc[j] = i == 0 ? term : add(acc[j], term);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) atb[j * tile + c] = acc[j];
    }
  }
  __syncthreads();

  double* ob = out + static_cast<size_t>(fit) * K * m + col0;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    double b[K];
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = atb[j * tile + c];
    double scaled[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {  // inv * (evecs^T @ atb)
      double proj = mul(evecs[0][j], b[0]);
#pragma unroll
      for (int i = 1; i < K; ++i) proj = add(proj, mul(evecs[i][j], b[i]));
      scaled[j] = mul(inv[j], proj);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {  // evecs @ scaled, unscaled
      double res = mul(evecs[i][0], scaled[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) res = add(res, mul(evecs[i][j], scaled[j]));
      ob[static_cast<size_t>(i) * m + c] = quo(res, scl[i]);
    }
  }
}

template <int K>
int launch(const double* x, const double* y, const double* w, double* out, int batch, int n, int m, int tile,
           int tiles, double cut_factor, cudaStream_t stream) {
  const size_t shared = sizeof(double) * (static_cast<size_t>(n) * (K + 1) + static_cast<size_t>(K) * tile);
  if (shared > (48u << 10)) {
    const cudaError_t err =
        cudaFuncSetAttribute(polyfit_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(batch) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  polyfit_kernel<K><<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(x, y, w, out, n, m, tile, tiles,
                                                                                cut_factor);
  return static_cast<int>(cudaGetLastError());
}

// -- the general form ----------------------------------------------------------

// doubles of a block's arrays besides the rows: scl and inv (k each), the
// matrix a and the eigenvectors v (k x k each), and each thread's scaled
// projection (k, stored [term][thread])
__host__ __device__ inline size_t general_fixed(int k) {
  const size_t kk = static_cast<size_t>(k);
  return 2 * kk + 2 * kk * kk + kk * kThreads;
}

// whether the weighting and the (n, k) scaled rows stay in shared memory
__host__ __device__ inline bool general_rows(int n, int k) {
  return sizeof(double) * static_cast<size_t>(n) * (static_cast<size_t>(k) + 1) <= kGeneralRows;
}

// x^to as polyvander builds it: products by x from 1.0, here continued from
// van = x^from
__device__ __forceinline__ double power_from(double van, double xi, int from, int to) {
  for (int d = from; d < to; ++d) van = mul(van, xi);
  return van;
}

// One rotation's scalars from its pivot entries app = a[p][p], apq = a[p][q],
// aqp = a[q][p] and aqq = a[q][q], as ops/polyfit.py :: jacobi_eigh computes
// them: c, the selected s (0 where the pivot is below DBL_MIN, after the same
// arithmetic), and the new a[p][p] and a[q][q] (where rows and columns p and
// q cross: the rows' update, then the columns'; a[p][q] and a[q][p] are then
// zeroed).
struct Rotation {
  double c, s, npp, nqq;
};

__device__ __forceinline__ Rotation rotation(double app, double apq, double aqp, double aqq) {
  const bool rotate = fabs(apq) > DBL_MIN;
  const double safe_apq = rotate ? apq : 1.0;
  const double tau = quo(sub(aqq, app), mul(2.0, safe_apq));
  const double root = __dsqrt_rn(add(mul(tau, tau), 1.0));
  const double sgn = sign_of(tau);
  const double r = rcp(sgn == 0.0 ? add(tau, root) : add(fabs(tau), root));
  const double t = sgn < 0.0 ? -r : r;
  const double c_rot = rcp(__dsqrt_rn(add(mul(t, t), 1.0)));
  const double s = mul(t, c_rot);
  const double c = rotate ? c_rot : 1.0;
  const double s_sel = rotate ? s : 0.0;
  const double ms_p = mul(s_sel, -1.0), ms_q = mul(s_sel, 1.0);  // (-s, s)
  const double rpp = add(mul(c, app), mul(ms_p, aqp)), rpq = add(mul(c, apq), mul(ms_p, aqq));
  const double rqp = add(mul(c, aqp), mul(ms_q, app)), rqq = add(mul(c, aqq), mul(ms_q, apq));
  return {c, s_sel, add(mul(c, rpp), mul(ms_p, rpq)), add(mul(c, rqq), mul(ms_q, rqp))};
}

// (xp, xq) <- (c xp - s xq, c xq + s xp) as the plain version rounds it:
// c * x + (-s, s) * x_flipped
__device__ __forceinline__ void rotate_pair(double c, double s, double& xp, double& xq) {
  const double ms_p = mul(s, -1.0), ms_q = mul(s, 1.0);
  const double p = xp, q = xq;
  xp = add(mul(c, p), mul(ms_p, q));
  xq = add(mul(c, q), mul(ms_q, p));
}

// Warp 0's Jacobi on the k x k a (row-major, in place: its diagonal ends as
// the eigenvalues) with the eigenvectors in v's columns (v starts as the
// identity), as ops/polyfit.py :: jacobi_eigh rotation for rotation.
__device__ void jacobi_warp(double* a, double* v, int k, int lane) {
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int p = 0; p < k - 1; ++p) {
      for (int q = p + 1; q < k; ++q) {
        const Rotation rot = rotation(a[p * k + p], a[p * k + q], a[q * k + p], a[q * k + q]);
        __syncwarp();  // every lane has read the pivot's entries before any is written
        if (lane == 0) {
          a[p * k + p] = rot.npp;
          a[q * k + q] = rot.nqq;
          a[p * k + q] = 0.0;
          a[q * k + p] = 0.0;
        }
        for (int j = lane; j < k; j += 32) {
          if (j != p && j != q) {
            rotate_pair(rot.c, rot.s, a[p * k + j], a[q * k + j]);  // rows p and q at column j
            rotate_pair(rot.c, rot.s, a[j * k + p], a[j * k + q]);  // columns p and q at row j
          }
          rotate_pair(rot.c, rot.s, v[j * k + p], v[j * k + q]);
        }
        __syncwarp();
      }
    }
  }
}

// The whole fit for any k: x (n,), y (n, m), w (P, n) -> out (P, k, m) in
// blocks of `tile` columns, `tiles` a weighting, as polyfit_kernel<K> lays
// out its grid.  With `workspace` (general_fixed(k) doubles a block) the
// block's matrices and threads' arrays live there instead of in shared
// memory.
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
    polyfit_general(const double* __restrict__ x, const double* __restrict__ y, const double* __restrict__ w,
                    double* __restrict__ out, int n, int m, int k, int tile, int tiles, double cut_factor,
                    double* workspace) {
  extern __shared__ double smem[];
  const bool rows = general_rows(n, k);
  double* ws = smem;      // (n,): the weighting, when rows
  double* lhs = ws + n;   // (n, k): the weighted Vandermonde rows, then scaled, when rows
  double* scl = workspace != nullptr ? workspace + blockIdx.x * general_fixed(k)
                                     : smem + (rows ? static_cast<size_t>(n) * (k + 1) : 0);
  double* inv = scl + k;
  double* a = inv + k;                           // (k, k): the normal matrix, rotated
  double* v = a + static_cast<size_t>(k) * k;    // (k, k): the eigenvectors
  double* st = v + static_cast<size_t>(k) * k + threadIdx.x;  // a thread's scaled projection, at st[j * kThreads]
  const int fit = blockIdx.x / tiles;
  const int col0 = (blockIdx.x - fit * tiles) * tile;
  const int cols = min(tile, m - col0);
  const double* wb = w + static_cast<size_t>(fit) * n;
  const double* yb = y + col0;
  const int tid = threadIdx.x;

  if (rows) {
    for (int i = tid; i < n; i += kThreads) ws[i] = wb[i];
    for (int e = tid; e < n * k; e += kThreads) {
      const int i = e / k, j = e - i * k;
      lhs[e] = mul(power_from(1.0, x[i], 0, j), wb[i]);
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kThreads) {  // column scaling, as numpy's polyutils._fit
    double ss = 0.0;
    for (int i = 0; i < n; ++i) {
      const double l = rows ? lhs[i * k + j] : mul(power_from(1.0, x[i], 0, j), wb[i]);
      const double sq = mul(l, l);
      ss = i == 0 ? sq : add(ss, sq);
    }
    const double r = __dsqrt_rn(ss);
    scl[j] = r == 0.0 ? 1.0 : r;
  }
  __syncthreads();
  if (rows) {
    for (int e = tid; e < n * k; e += kThreads) lhs[e] = quo(lhs[e], scl[e % k]);
    __syncthreads();
  }

  // the normal matrix, an entry a thread, summed over the samples in order
  for (int e = tid; e < k * k; e += kThreads) {
    const int p = e / k, q = e - p * k;
    const int lo = min(p, q), hi = max(p, q);
    double acc = 0.0;
    for (int i = 0; i < n; ++i) {
      double lp, lq;
      if (rows) {
        lp = lhs[i * k + p];
        lq = lhs[i * k + q];
      } else {
        const double xi = x[i], wi = wb[i];
        const double vlo = power_from(1.0, xi, 0, lo), vhi = power_from(vlo, xi, lo, hi);
        lp = quo(mul(p == lo ? vlo : vhi, wi), scl[p]);
        lq = quo(mul(q == lo ? vlo : vhi, wi), scl[q]);
      }
      const double term = mul(lp, lq);
      acc = i == 0 ? term : add(acc, term);
    }
    a[e] = acc;
    v[e] = p == q ? 1.0 : 0.0;
  }
  __syncthreads();

  double* ob = out + static_cast<size_t>(fit) * k * m + col0;
  if (tid < 32) {  // warp 0: the Jacobi, then the eigenvalues' cutoff
    jacobi_warp(a, v, k, tid);
    double top = 0.0;  // amax of the eigenvalues clamped at 0: a NaN wins
    for (int j = 0; j < k; ++j) {
      const double ev = is_nan(a[j * k + j]) ? a[j * k + j] : fmax(a[j * k + j], 0.0);
      if (j == 0 || (!is_nan(top) && (is_nan(ev) || ev > top))) top = ev;
    }
    const double cutoff = mul(top, cut_factor);
    for (int j = tid; j < k; j += 32) {
      const double ev = is_nan(a[j * k + j]) ? a[j * k + j] : fmax(a[j * k + j], 0.0);
      inv[j] = ev > cutoff ? rcp(ev) : 0.0;
    }
  } else {  // warps 1-7: b = A^T (w y) into the block's output columns, each term summed over the samples in order
    for (int c = tid - 32; c < cols; c += kColThreads) {
      const double* yc = yb + c;
      for (int j0 = 0; j0 < k; j0 += kChunk) {
        double acc[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) acc[u] = 0.0;
        for (int i = 0; i < n; ++i) {
          const double wi = rows ? ws[i] : wb[i];
          const double rhs = mul(__ldg(yc + static_cast<size_t>(i) * m), wi);
          const double xi = rows ? 0.0 : x[i];
          double van = rows ? 0.0 : power_from(1.0, xi, 0, j0);
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int j = j0 + u;
            if (j < k) {
              double l;
              if (rows) {
                l = lhs[i * k + j];
              } else {
                if (u > 0) van = mul(van, xi);
                l = quo(mul(van, wi), scl[j]);
              }
              const double term = mul(l, rhs);
              acc[u] = i == 0 ? term : add(acc[u], term);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (j0 + u < k) ob[static_cast<size_t>(j0 + u) * m + c] = acc[u];
        }
      }
    }
  }
  __syncthreads();

  for (int c = tid; c < cols; c += kThreads) {  // b from the output column, then the column's solution over it
    for (int j0 = 0; j0 < k; j0 += kChunk) {  // inv * (evecs^T @ b)
      double acc[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) acc[u] = 0.0;
      for (int i = 0; i < k; ++i) {
        const double b = ob[static_cast<size_t>(i) * m + c];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (j0 + u < k) {
            const double term = mul(v[i * k + j0 + u], b);
            acc[u] = i == 0 ? term : add(acc[u], term);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u < k) st[static_cast<size_t>(j0 + u) * kThreads] = mul(inv[j0 + u], acc[u]);
      }
    }
    for (int i0 = 0; i0 < k; i0 += kChunk) {  // evecs @ scaled, unscaled
      double acc[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) acc[u] = 0.0;
      for (int j = 0; j < k; ++j) {
        const double sc = st[static_cast<size_t>(j) * kThreads];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (i0 + u < k) {
            const double term = mul(v[(i0 + u) * k + j], sc);
            acc[u] = j == 0 ? term : add(acc[u], term);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i0 + u < k) ob[static_cast<size_t>(i0 + u) * m + c] = quo(acc[u], scl[i0 + u]);
      }
    }
  }
}

int launch_general(const double* x, const double* y, const double* w, double* out, int batch, int n, int m, int k,
                   int tile, int tiles, double cut_factor, double* workspace, cudaStream_t stream) {
  const size_t shared = sizeof(double) * ((general_rows(n, k) ? static_cast<size_t>(n) * (k + 1) : 0) +
                                          (workspace != nullptr ? 0 : general_fixed(k)));
  if (shared > (48u << 10)) {
    const cudaError_t err =
        cudaFuncSetAttribute(polyfit_general, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(batch) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  polyfit_general<<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(x, y, w, out, n, m, k, tile, tiles,
                                                                             cut_factor, workspace);
  return static_cast<int>(cudaGetLastError());
}

// -- the wave form -------------------------------------------------------------

// y rows of column yc, weighted, times the scaled rows: b = A^T (w y), each
// term summed over the samples in order in this thread; the rows from shared
// memory (lhs, ws), y loads issued kRows at a time, or, beyond it, recomputed
// as the same chain of rounded operations (x^j as j products from 1, times
// w, over scl[j]), the sums kept in the thread's slice of shared memory
// (acc[j * kThreads]) across the quotients, whose slow paths are calls
template <int K>
__device__ __forceinline__ void column_rhs(double (&b)[K], const double* yc, int n, int m, bool rows,
                                           const volatile double* ws, const volatile double* lhs, const double* x,
                                           const double* wb, const double* scl, volatile double* acc) {
  if (rows) {
    double ys[kRows];
    for (int i0 = 0; i0 < n; i0 += kRows) {
      load_rows(ys, yc, i0, n, m);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= n) break;
        const double rhs = mul(ys[r], ws[i]);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const double term = mul(lhs[i * K + j], rhs);
          b[j] = i == 0 ? term : add(b[j], term);
        }
      }
    }
    return;
  }
  double y_next = __ldg(yc);
  for (int i = 0; i < n; ++i) {
    const double xi = x[i], wi = wb[i];
    const double rhs = mul(y_next, wi);
    if (i + 1 < n) y_next = __ldg(yc + static_cast<size_t>(i + 1) * m);
    double van = 1.0;
    for (int j = 0; j < K; ++j) {
      if (j > 0) van = mul(van, xi);
      const double term = mul(quo(mul(van, wi), scl[j]), rhs);
      acc[j * kThreads] = i == 0 ? term : add(acc[j * kThreads], term);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = acc[j * kThreads];
}

// one column's solution from its right-hand sides b: evecs (inv * (evecs^T b)),
// unscaled, stored at oc[i * m].  Each sum runs in the plain version's order;
// the projection takes a row of evecs at a time (the volatile reads keep the
// compiler from hoisting all K^2 of them into registers), and each result
// is divided and stored as soon as it is summed.
template <int K>
__device__ __forceinline__ void column_solve(const double (&b)[K], const volatile double* evecs, const double* inv,
                                             const double* scl, double* oc, int m) {
  double sc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {  // sc[j] = sum over i of evecs[i][j] b[i]
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const double term = mul(evecs[i * K + j], b[i]);
      sc[j] = i == 0 ? term : add(sc[j], term);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) sc[j] = mul(inv[j], sc[j]);
#pragma unroll
  for (int i = 0; i < K; ++i) {  // sum over j of evecs[i][j] sc[j], over scl[i]
    double res = mul(evecs[i * K], sc[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) res = add(res, mul(evecs[i * K + j], sc[j]));
    oc[static_cast<size_t>(i) * m] = quo(res, scl[i]);
  }
}

// The wave form's program (ops/polyfit.py :: wave_table): rows of 32-bit
// tasks, one to a lane.  A rotation's scalars are 1 << 31 | r << 18 | p << 9 | q;
// its update of the stored entries e1 = (p, j) and e2 = (q, j) of the upper
// triangle is r << 18 | e1 << 9 | e2.  A row's first task sits at
// start[row] & 0x7fff, and bit 15 marks a row of scalars.
constexpr unsigned kScalars = 1u << 31;
constexpr unsigned kScalarsRow = 0x8000u;
constexpr int kPublish = 4;  // rows of scalars between two publications of their rotations' c and s

// rotation r's stored c, -s and s applied to a[e1] and a[e2] (an idle lane's
// task names the spare rotation kRot, c = 1 and s = 0, and the spare entry)
__device__ __forceinline__ void wave_update(double* a, const double* rot, int r, int e1, int e2) {
  const double c = rot[3 * r], ms_p = rot[3 * r + 1], ms_q = rot[3 * r + 2];
  const double xp = a[e1], xq = a[e2];
  a[e1] = add(mul(c, xp), mul(ms_p, xq));
  a[e2] = add(mul(c, xq), mul(ms_q, xp));
}

// bytes of the wave form's static shared memory (ops/polyfit.py :: wave_static)
__host__ __device__ constexpr size_t wave_static(int k) {
  return sizeof(double) * (2 * k + 2 * k * k + 1 + 3 * (kSweeps * k * (k - 1) / 2 + 1)) + 16;
}

// The whole fit for K = deg + 1 <= kWaveMaxK: x (n,), y (n, m), w (P, n) ->
// out (P, K, m), the grid as polyfit_kernel<K> lays it out.  `table` is
// ops/polyfit.py :: wave_table(K), `rows` its rows and `table_len` its
// uint16 entries (a multiple of 4); the block copies it to shared memory
// after its weighting and rows and the right-hand sides of its first `hold`
// columns, which warps 2-7 form beside the Jacobi.
template <int K>
__global__ void __launch_bounds__(kThreads, kWaveMinBlocks[K])
    polyfit_wave(const double* __restrict__ x, const double* __restrict__ y, const double* __restrict__ w,
                 double* __restrict__ out, int n, int m, int tile, int tiles, double cut_factor,
                 const unsigned short* __restrict__ table, int rows, int table_len, int hold) {
  constexpr int kRot = kSweeps * K * (K - 1) / 2;
  extern __shared__ double smem[];
  // the matrix's upper triangle (a[K * K] a spare entry), and each rotation's c, -s and s (rotation kRot a spare)
  __shared__ double scl[K], inv[K], a[K * K + 1], evecs[K * K], rot[3 * (kRot + 1)];
  __shared__ int rows_done;  // rows of warp 0's program run, published every kPublish rows of scalars
  const bool in_smem = general_rows(n, K);
  double* ws = smem;     // (n,): the weighting, when in_smem
  double* lhs = ws + n;  // (n, K): the weighted Vandermonde rows, then scaled, when in_smem
  volatile double* acc = smem + threadIdx.x;  // (K, kThreads): each thread's sums, when not in_smem
  double* atb = smem + (in_smem ? static_cast<size_t>(n) * (K + 1) : static_cast<size_t>(K) * kThreads);  // (K, hold)
  unsigned short* tbl = reinterpret_cast<unsigned short*>(atb + static_cast<size_t>(K) * hold);
  const int fit = blockIdx.x / tiles;
  const int col0 = (blockIdx.x - fit * tiles) * tile;
  const int cols = min(tile, m - col0);
  const double* wb = w + static_cast<size_t>(fit) * n;
  const double* yb = y + col0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < table_len / 4; i += kThreads) {
    reinterpret_cast<uint2*>(tbl)[i] = __ldg(reinterpret_cast<const uint2*>(table) + i);
  }
  if (tid == 0) {
    rows_done = 0;
    rot[3 * kRot] = 1.0;
    rot[3 * kRot + 1] = 0.0;
    rot[3 * kRot + 2] = 0.0;
  }
  if (in_smem) {
    for (int i = tid; i < n; i += kThreads) ws[i] = wb[i];
    for (int e = tid; e < n * K; e += kThreads) {
      const int i = e / K, j = e - i * K;
      lhs[e] = mul(power_from(1.0, x[i], 0, j), wb[i]);
    }
    __syncthreads();
  }
  if (tid < K) {  // column scaling, as numpy's polyutils._fit
    const int j = tid;
    double ss = 0.0;
    for (int i = 0; i < n; ++i) {
      const double l = in_smem ? lhs[i * K + j] : mul(power_from(1.0, x[i], 0, j), wb[i]);
      const double sq = mul(l, l);
      ss = i == 0 ? sq : add(ss, sq);
    }
    const double r = __dsqrt_rn(ss);
    scl[j] = r == 0.0 ? 1.0 : r;
  }
  __syncthreads();
  if (in_smem) {
    for (int e = tid; e < n * K; e += kThreads) lhs[e] = quo(lhs[e], scl[e % K]);
    __syncthreads();
  }
  // the normal matrix's upper triangle (the plain version keeps it symmetric
  // bit for bit), an entry a thread, summed over the samples in order
  if (tid < K * K) {
    const int p = tid / K, q = tid - p * K;
    if (p <= q) {
      double acc = 0.0;
      for (int i = 0; i < n; ++i) {
        double lp, lq;
        if (in_smem) {
          lp = lhs[i * K + p];
          lq = lhs[i * K + q];
        } else {
          const double xi = x[i], wi = wb[i];
          const double vp = power_from(1.0, xi, 0, p), vq = power_from(vp, xi, p, q);
          lp = quo(mul(vp, wi), scl[p]);
          lq = quo(mul(vq, wi), scl[q]);
        }
        const double term = mul(lp, lq);
        acc = i == 0 ? term : add(acc, term);
      }
      a[tid] = acc;
    }
  }
  __syncthreads();

  const unsigned short* ready = tbl;          // (kRot,): the row that computes the rotation's scalars, + 1
  const unsigned short* start = ready + kRot;  // (rows + 1,): each row's first task, bit 15 on a row of scalars
  const unsigned* tasks = reinterpret_cast<const unsigned*>(tbl + ((kRot + rows + 2) & ~1));
  if (warp == 0) {
    // the wavefront: each step is a row of rotations' scalars (their c and
    // s published every kPublish such rows, behind a fence that costs the
    // warp ~60 cycles) and the rows of updates that the next step's scalars
    // wait for, in a loop of their own with no branch.  A lane reads and
    // decodes its task of the next row (and the row after that's start)
    // while it runs this one's.
    constexpr unsigned kIdle = static_cast<unsigned>(kRot) << 18 | (K * K) << 9 | (K * K);
    unsigned s1 = rows >= 1 ? start[1] : 0, s2 = rows >= 2 ? start[2] : 0;
    const int first = rows >= 1 ? start[0] & 0x7fff : 0;
    unsigned task = lane < static_cast<int>(s1 & 0x7fff) - first ? tasks[first + lane] : kIdle;
    int scalar_rows = 0;
    for (int row = 0; row < rows;) {
      unsigned next = row + 1 < rows && lane < static_cast<int>((s2 & 0x7fff) - (s1 & 0x7fff))
                          ? tasks[(s1 & 0x7fff) + lane] : kIdle;
      unsigned s3 = row + 3 <= rows ? start[row + 3] : 0;
      if (task & kScalars) {
        const int r = (task >> 18) & 0x1fff, p = (task >> 9) & 0x1ff, q = task & 0x1ff;
        const double apq = a[p * K + q];
        const Rotation rt = rotation(a[p * K + p], apq, apq, a[q * K + q]);
        a[p * K + p] = rt.npp;
        a[q * K + q] = rt.nqq;
        a[p * K + q] = 0.0;
        rot[3 * r] = rt.c;
        rot[3 * r + 1] = mul(rt.s, -1.0);
        rot[3 * r + 2] = mul(rt.s, 1.0);
      }
      // the next row's update, decoded off the rows' chain (unused if it is a row of scalars)
      int r = (next >> 18) & 0x1fff, e1 = (next >> 9) & 0x1ff, e2 = next & 0x1ff;
      __syncwarp();
      if (lane == 0 && ++scalar_rows % kPublish == 0) {
        asm volatile("fence.acq_rel.cta;" ::: "memory");  // c and s before the count that publishes them
        *static_cast<volatile int*>(&rows_done) = row + 1;
      }
      for (bool scalars = (s1 & kScalarsRow) != 0; ++row < rows && !scalars;) {
        s1 = s2;
        s2 = s3;
        next = row + 1 < rows && lane < static_cast<int>((s2 & 0x7fff) - (s1 & 0x7fff)) ? tasks[(s1 & 0x7fff) + lane]
                                                                                         : kIdle;
        s3 = row + 3 <= rows ? start[row + 3] : 0;
        scalars = (s1 & kScalarsRow) != 0;
        wave_update(a, rot, r, e1, e2);
        r = (next >> 18) & 0x1fff;
        e1 = (next >> 9) & 0x1ff;
        e2 = next & 0x1ff;
        __syncwarp();
      }
      task = next;
      s1 = s2;
      s2 = s3;
    }
    if (lane == 0) *static_cast<volatile int*>(&rows_done) = 0x7fffffff;
    double top = 0.0;  // amax of the eigenvalues clamped at 0: a NaN wins
    for (int j = 0; j < K; ++j) {
      const double ev = is_nan(a[j * K + j]) ? a[j * K + j] : fmax(a[j * K + j], 0.0);
      if (j == 0 || (!is_nan(top) && (is_nan(ev) || ev > top))) top = ev;
    }
    const double cutoff = mul(top, cut_factor);
    if (lane < K) {
      const double ev = is_nan(a[lane * K + lane]) ? a[lane * K + lane] : fmax(a[lane * K + lane], 0.0);
      inv[lane] = ev > cutoff ? rcp(ev) : 0.0;
    }
  } else if (warp == 1) {
    // the eigenvectors off the chain: lane i rotates row i, rotation after
    // rotation in cyclic order, each once its scalars are out
    if (lane < K) {
      double* vr = evecs + lane * K;
      for (int j = 0; j < K; ++j) vr[j] = j == lane ? 1.0 : 0.0;
      int seen = 0;
      for (int r = 0, p = 0, q = 1; r < kRot; ++r) {
        if (seen < ready[r]) {
          while (seen < ready[r]) seen = *static_cast<volatile int*>(&rows_done);
          asm volatile("fence.acq_rel.cta;" ::: "memory");
        }
        const volatile double* cs = rot + 3 * r;
        const double vp = vr[p], vq = vr[q];
        vr[p] = add(mul(cs[0], vp), mul(cs[1], vq));
        vr[q] = add(mul(cs[0], vq), mul(cs[2], vp));
        if (++q == K) {  // the next (p, q) in cyclic order
          q = ++p + 1;
          if (q == K) p = 0, q = 1;
        }
      }
    }
  } else {  // warps 2-7: the first `hold` columns' right-hand sides, beside the Jacobi
    for (int c = tid - 64; c < min(hold, cols); c += kWaveColThreads) {
      double b[K];
      column_rhs<K>(b, yb + c, n, m, in_smem, ws, lhs, x, wb, scl, acc);
#pragma unroll
      for (int j = 0; j < K; ++j) atb[j * hold + c] = b[j];
    }
  }
  __syncthreads();

  double* ob = out + static_cast<size_t>(fit) * K * m + col0;
  for (int c = tid; c < cols; c += kThreads) {  // each column in one pass
    double b[K];
    if (c < hold) {
#pragma unroll
      for (int j = 0; j < K; ++j) b[j] = atb[j * hold + c];
    } else {
      column_rhs<K>(b, yb + c, n, m, in_smem, ws, lhs, x, wb, scl, acc);
    }
    column_solve<K>(b, evecs, inv, scl, ob + c, m);
  }
}

template <int K>
int launch_wave(const double* x, const double* y, const double* w, double* out, int batch, int n, int m, int tile,
                int tiles, double cut_factor, const unsigned short* table, int rows, int table_len, int hold,
                cudaStream_t stream) {
  if (table == nullptr || table_len % 4 != 0 || hold < 0 || hold > tile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(double) * ((general_rows(n, K) ? static_cast<size_t>(n) * (K + 1)
                                                                : static_cast<size_t>(K) * kThreads) +
                                          static_cast<size_t>(K) * hold) +
                        sizeof(unsigned short) * static_cast<size_t>(table_len);
  if (shared + wave_static(K) > (48u << 10)) {  // the default limit counts static shared memory too
    const cudaError_t err =
        cudaFuncSetAttribute(polyfit_wave<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(batch) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  polyfit_wave<K><<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(x, y, w, out, n, m, tile, tiles,
                                                                              cut_factor, table, rows, table_len, hold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry point: `form` 1 the register form (k = deg + 1 in [1, 4], its
// n * (k + 1) + k * tile doubles of shared memory within a block's), 2 the
// general form (any k >= 1 and n >= 1; `workspace` null or general_fixed(k)
// doubles a block), 3 the wave form (k in [1, kWaveMaxK], any n >= 1;
// `table` ops/polyfit.py :: wave_table(k), of `rows` rows and `table_len`
// uint16 entries; the right-hand sides of a block's first `hold` columns in
// shared memory); `tile` columns a block and `tiles` blocks a weighting,
// all from ops/polyfit.py :: plan (the wrapper checks the rest); returns the
// launch's CUDA error code.
extern "C" int polyfit_f64(int form, const void* x, const void* y, const void* w, void* out, int batch, int n, int m,
                           int k, int tile, int tiles, double cut_factor, void* workspace, const void* table, int rows,
                           int table_len, int hold, void* stream) {
  const auto* xd = static_cast<const double*>(x);
  const auto* yd = static_cast<const double*>(y);
  const auto* wd = static_cast<const double*>(w);
  auto* od = static_cast<double*>(out);
  const auto* td = static_cast<const unsigned short*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 1 || tiles < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 2) return launch_general(xd, yd, wd, od, batch, n, m, k, tile, tiles, cut_factor,
                                       static_cast<double*>(workspace), s);
  if (form == 3) {
    switch (k) {
#define WAVE(K) \
  case K: return launch_wave<K>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, td, rows, table_len, hold, s);
      WAVE(1) WAVE(2) WAVE(3) WAVE(4) WAVE(5) WAVE(6) WAVE(7) WAVE(8)
      WAVE(9) WAVE(10) WAVE(11) WAVE(12) WAVE(13) WAVE(14) WAVE(15) WAVE(16)
#undef WAVE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (form != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch<1>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 2: return launch<2>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 3: return launch<3>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 4: return launch<4>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
