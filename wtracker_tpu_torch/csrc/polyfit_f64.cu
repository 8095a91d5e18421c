// Weighted polynomial least squares in float64, one launch a fit, for sm_90a.
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
// Bound on the H100: a fit is a few thousand float64 operations (a degree-2
// fit of 5 samples and 2 columns ~2,800, most in the 36 rotations) and ~200
// bytes, so one fit is at the launch floor; the particle swarm's batch (100
// weightings x 6,170 columns) is ~61 M operations and 15 MB, bound by its
// bytes at ~4.5 us (chip_smoke.py::polyfit_work counts them).
//
// Exactness.  The plain version runs one torch op a step, so each product,
// sum, quotient and square root is rounded on its own.  Here every such step
// is an explicit round-to-nearest intrinsic (__dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn, __dsqrt_rn), and the file is also compiled with
// --fmad=false, so no product and sum contract into an FMA.  Division and
// square root are IEEE on both sides (torch's reciprocal() is 1 / x, and
// a tensor divided by a tensor is a / b; no division by a Python number
// appears in the fit).  Sums run in the plain version's order,
// ((x0 + x1) + x2) + ..., starting from the first term (so a -0.0 stays
// -0.0).  Rotations whose pivot is below DBL_MIN are selected away as
// torch.where does, after the same arithmetic, and rows and columns update
// as c*x + (-+s)*x_flipped.
//
// Design (simple first): one block per weighting (the P axis, 1 without a
// batch).  The block's threads build the scaled Vandermonde rows in shared
// memory; thread 0 forms the k x k normal matrix and runs the Jacobi in
// registers (K = deg + 1 <= 8 is a template parameter, so the arrays are
// unrolled); then the threads share the M right-hand-side columns for the
// projection, the solve and the unscaling.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 12;  // jacobi_eigh's default

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

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
        const double t = sgn == 0.0 ? quo(1.0, add(tau, root)) : quo(sgn, add(fabs(tau), root));
        const double c_rot = quo(1.0, __dsqrt_rn(add(mul(t, t), 1.0)));
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

// x (n,), y (n, m), w (P, n) -> out (P, K, m); cut_factor is
// max(rcond^2, 16 eps) with rcond = n eps, computed by the wrapper as the
// plain version computes it.
template <int K>
__global__ void __launch_bounds__(kThreads)
    polyfit_kernel(const double* __restrict__ x, const double* __restrict__ y, const double* __restrict__ w,
                   double* __restrict__ out, int n, int m, double cut_factor) {
  extern __shared__ double lhs[];  // (n, K): the weighted Vandermonde rows, then scaled
  __shared__ double scl[K], inv[K], evecs[K][K];
  const double* wb = w + static_cast<size_t>(blockIdx.x) * n;

  for (int e = threadIdx.x; e < n * K; e += blockDim.x) {
    const int i = e / K, j = e % K;
    double van = 1.0;  // x^j as x^(j-1) * x
    for (int d = 0; d < j; ++d) van = mul(van, x[i]);
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
  for (int e = threadIdx.x; e < n * K; e += blockDim.x) lhs[e] = quo(lhs[e], scl[e % K]);
  __syncthreads();

  if (threadIdx.x == 0) {
    double a[K][K], v[K][K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        double acc = mul(lhs[p], lhs[q]);
        for (int i = 1; i < n; ++i) acc = add(acc, mul(lhs[i * K + p], lhs[i * K + q]));
        a[p][q] = acc;
      }
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
      inv[j] = ev[j] > cutoff ? quo(1.0, ev[j]) : 0.0;
#pragma unroll
      for (int i = 0; i < K; ++i) evecs[i][j] = v[i][j];
    }
  }
  __syncthreads();

  double* ob = out + static_cast<size_t>(blockIdx.x) * K * m;
  for (int col = threadIdx.x; col < m; col += blockDim.x) {
    double atb[K];
#pragma unroll
    for (int j = 0; j < K; ++j) atb[j] = mul(lhs[j], mul(y[col], wb[0]));
    for (int i = 1; i < n; ++i) {
      const double rhs = mul(y[static_cast<size_t>(i) * m + col], wb[i]);
#pragma unroll
      for (int j = 0; j < K; ++j) atb[j] = add(atb[j], mul(lhs[i * K + j], rhs));
    }
    double scaled[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {  // inv * (evecs^T @ atb)
      double proj = mul(evecs[0][j], atb[0]);
#pragma unroll
      for (int i = 1; i < K; ++i) proj = add(proj, mul(evecs[i][j], atb[i]));
      scaled[j] = mul(inv[j], proj);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {  // evecs @ scaled, unscaled
      double res = mul(evecs[i][0], scaled[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) res = add(res, mul(evecs[i][j], scaled[j]));
      ob[static_cast<size_t>(i) * m + col] = quo(res, scl[i]);
    }
  }
}

template <int K>
int launch(const double* x, const double* y, const double* w, double* out, int batch, int n, int m,
           double cut_factor, cudaStream_t stream) {
  const size_t shared = sizeof(double) * static_cast<size_t>(n) * K;
  polyfit_kernel<K><<<batch, kThreads, shared, stream>>>(x, y, w, out, n, m, cut_factor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry point: k = deg + 1 in [1, 8], n * k * 8 bytes of shared
// memory at most 48 KB (the wrapper checks both); returns the launch's CUDA
// error code.
extern "C" int polyfit_f64(const void* x, const void* y, const void* w, void* out, int batch, int n, int m, int k,
                           double cut_factor, void* stream) {
  const auto* xd = static_cast<const double*>(x);
  const auto* yd = static_cast<const double*>(y);
  const auto* wd = static_cast<const double*>(w);
  auto* od = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 2: return launch<2>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 3: return launch<3>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 4: return launch<4>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 5: return launch<5>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 6: return launch<6>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 7: return launch<7>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    case 8: return launch<8>(xd, yd, wd, od, batch, n, m, cut_factor, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
