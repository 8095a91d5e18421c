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
//   one serial chain: each rotation waits for the one before, and holds a
//   quotient, two square roots and two reciprocals, each tens of cycles
//   deep.  At deg 2 its 36 rotations take ~13 us on one lane, whatever the
//   thread count.
// * The columns (right-hand side, projection, solve, unscaling) are
//   independent of each other: at the particle swarm's shape (100
//   weightings, N=8, 6,170 columns) ~60 M float64 operations and the
//   14.8 MB (P, k, M) result, whose write is the call's bound, ~4.5 us
//   (chip_smoke.py::polyfit_work counts both).
// So the chain bounds the kernel at both shapes: at the replay's (1
// weighting, N=5, 2 columns) it is the kernel beside the launch; at the
// swarm's the right-hand sides run beside it and only the solve and the
// write (~2 us) come after it (sweep_polyfit.py's timeline and ablations).
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
// Two forms, one entry point that takes the form as its first argument;
// ops/polyfit.py :: plan picks it.  The register form above
// (polyfit_kernel<K>) holds lane 0's Jacobi and each column's K sums in
// registers, so it takes K <= 7 only (at K = 8 it spilled, and timed slower
// at the swarm's batch than the general form: PERF.md), and rows that fit
// 48 KB.  Every other call goes to the general form (polyfit_general),
// whose K is a runtime argument:
// * warp 0 runs the Jacobi on the k x k matrix and its eigenvectors in
//   shared memory: every lane computes the rotation's scalars and the four
//   entries where rows and columns p and q cross (the rows' update, then
//   the columns', then the pivot pair zeroed, as the plain version orders
//   them) from the pivot's four entries, which lane 0 then stores, while
//   lane j updates column j of rows p and q, row j of columns p and q and
//   row j of the eigenvectors (j outside p and q touches no entry another
//   lane reads);
// * the normal matrix is an entry a thread; while warp 0 runs the Jacobi,
//   warps 1-7 form their columns' right-hand sides into the block's output
//   columns, which the solve later overwrites; after the Jacobi every
//   thread projects and solves its columns; each works a kChunk of terms at
//   a time, each sum still one chain in order, the projection through k
//   doubles of the thread's own;
// * the weighting and the scaled rows stay in shared memory while they fit
//   kGeneralRows; beyond it each entry is recomputed where it is read, as
//   the same chain of rounded operations (x^j as j products, times w, over
//   scl[j]), so it has the stored bits;
// * where the matrices and the threads' arrays do not fit a block's shared
//   memory, they live in a global workspace that the wrapper allocates.
// So every k >= 1 and n >= 1 fits, in one launch, with the same bits.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;  // warp 0 the setup, warps 1-7 the right-hand sides
constexpr int kColThreads = kThreads - 32;
constexpr int kRows = 8;  // y rows whose loads a column thread issues together
constexpr int kSweeps = 12;  // jacobi_eigh's default
// blocks of kThreads resident on an SM, by K = deg + 1 (__launch_bounds__:
// at most 64 registers a thread for K <= 3, 128 for K <= 5; lane 0 holds
// the Jacobi's 2 K^2 doubles)
constexpr int kMinBlocks[8] = {1, 4, 4, 4, 2, 2, 1, 1};
// the general form: terms a thread sums at once, the bytes of weighting and
// scaled rows it keeps in shared memory, blocks resident on an SM
constexpr int kChunk = 8;
constexpr size_t kGeneralRows = 48u << 10;
constexpr int kGeneralMinBlocks = 4;

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

// Warp 0's Jacobi on the k x k a (row-major, in place: its diagonal ends as
// the eigenvalues) with the eigenvectors in v's columns (v starts as the
// identity), as ops/polyfit.py :: jacobi_eigh rotation for rotation.
__device__ void jacobi_warp(double* a, double* v, int k, int lane) {
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int p = 0; p < k - 1; ++p) {
      for (int q = p + 1; q < k; ++q) {
        const double app = a[p * k + p], apq = a[p * k + q], aqp = a[q * k + p], aqq = a[q * k + q];
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
        // where rows and columns p and q cross: the rows' update, then the columns', then the pair zeroed
        const double rpp = add(mul(c, app), mul(ms_p, aqp)), rpq = add(mul(c, apq), mul(ms_p, aqq));
        const double rqp = add(mul(c, aqp), mul(ms_q, app)), rqq = add(mul(c, aqq), mul(ms_q, apq));
        const double npp = add(mul(c, rpp), mul(ms_p, rpq)), nqq = add(mul(c, rqq), mul(ms_q, rqp));
        __syncwarp();  // every lane has read the pivot's entries before any is written
        if (lane == 0) {
          a[p * k + p] = npp;
          a[q * k + q] = nqq;
          a[p * k + q] = 0.0;
          a[q * k + p] = 0.0;
        }
        for (int j = lane; j < k; j += 32) {
          if (j != p && j != q) {
            const double xp = a[p * k + j], xq = a[q * k + j];  // rows p and q at column j
            a[p * k + j] = add(mul(c, xp), mul(ms_p, xq));
            a[q * k + j] = add(mul(c, xq), mul(ms_q, xp));
            const double yp = a[j * k + p], yq = a[j * k + q];  // columns p and q at row j
            a[j * k + p] = add(mul(c, yp), mul(ms_p, yq));
            a[j * k + q] = add(mul(c, yq), mul(ms_q, yp));
          }
          const double vp = v[j * k + p], vq = v[j * k + q];
          v[j * k + p] = add(mul(c, vp), mul(ms_p, vq));
          v[j * k + q] = add(mul(c, vq), mul(ms_q, vp));
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

}  // namespace

// The C entry point: `form` 1 the register form (k = deg + 1 in [1, 7], its
// n * (k + 1) + k * tile doubles of shared memory within a block's), 2 the
// general form (any k >= 1 and n >= 1; `workspace` null or general_fixed(k)
// doubles a block); `tile` columns a block and `tiles` blocks a weighting,
// all from ops/polyfit.py :: plan (the wrapper checks the rest); returns
// the launch's CUDA error code.
extern "C" int polyfit_f64(int form, const void* x, const void* y, const void* w, void* out, int batch, int n, int m,
                           int k, int tile, int tiles, double cut_factor, void* workspace, void* stream) {
  const auto* xd = static_cast<const double*>(x);
  const auto* yd = static_cast<const double*>(y);
  const auto* wd = static_cast<const double*>(w);
  auto* od = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 1 || tiles < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 2) return launch_general(xd, yd, wd, od, batch, n, m, k, tile, tiles, cut_factor,
                                       static_cast<double*>(workspace), s);
  if (form != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch<1>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 2: return launch<2>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 3: return launch<3>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 4: return launch<4>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 5: return launch<5>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 6: return launch<6>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    case 7: return launch<7>(xd, yd, wd, od, batch, n, m, tile, tiles, cut_factor, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
