// int8 NHWC x int8 HWIO convolution with exact int32 accumulation and a fused
// float32 epilogue, for sm_90a.
//
// Replaces the XLA-lowered int8 convolution of the JAX package's int8 serving
// form: wtracker_tpu/models/yolov8_int8.py :: _conv_s8 with the epilogues of
// _ApplyOps.convbn (dequantize, bias, SiLU, requantize to int8) and
// _ApplyOps.plain_conv (dequantize, bias, bf16 logits).  It is not a Pallas
// kernel; torch has no CUDA int8 convolution, so the port writes its own.
// The plain PyTorch version is wtracker_tpu_torch/ops/conv_s8.py ::
// conv_s8_reference.
//
// What it computes, for a k x k kernel (k = 1 or 3) at stride 1 or 2 with
// "same" padding k / 2:
//   acc[n, oy, ox, oc] = sum over (kh, kw, ci) of
//       x[n, oy*s - k/2 + kh, ox*s - k/2 + kw, ci] * w[kh, kw, ci, oc]
// (zero outside the image), exact in int32 (|acc| < 9*512*127*127 < 2^31),
// then one of three epilogues, each value rounded as the plain version
// rounds it (one torch operation at a time, so no fused multiply-add):
//   kAcc:    the int32 accumulators;
//   kLogits: bf16(float(acc) * sw[oc] + b[oc]);
//   kSiluQ:  y = float(acc) * sw[oc] + b[oc];  h = 0.5 * y;
//            s = h * (tanh(h) + 1);  int8(clip(rint(s * inv_s_out), +-127)).
// The products and sums use __fmul_rn / __fadd_rn, which the compiler never
// contracts, and tanhf / rintf (round half to even, as torch.round).
//
// Bound on the H100: at YOLOv8s@416 and N = 12 views the 63 convolutions of
// a forward have a summed bound of about 0.12 ms (PERF.md), most of them
// set by their bytes (activations in and out at 3.35 TB/s) rather than by
// their operations at the int8 tensor cores' 1,979 TOP/s.  This kernel does
// not use the tensor cores: __dp4a runs on the CUDA cores (about 134 TOP/s
// at most on the H100), so that instruction's issue rate is what limits it.
//
// Design (simple first; tensor cores are later work):
// - An implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin.  The
//   reduction runs in 32-bit words of 4 channels of one tap (__dp4a: four
//   int8 products and an int32 add per instruction, on the CUDA cores, not
//   the tensor cores).  Cin is padded to a multiple of 4 per tap (b0's
//   Cin = 3 reads 3 bytes and a zero).  The wrapper packs the weights once,
//   as int32 words wp[k4][Cout], each 4 consecutive channels of one tap.
// - A block computes 128 pixels x 64 channels with 256 threads, a thread
//   8 x 4 accumulators in registers.  Per stage it stages 8 words of the
//   reduction (32 channels) of A (pixels) and B (weights) in shared memory,
//   double-buffered: the next stage's global loads are issued into registers
//   before the current stage's 256 dp4a, so one barrier a stage suffices.
// - A pixel's group of 4 channels is one 32-bit load where Cin is a multiple
//   of 4 and the strides and base are 4-byte aligned (the wrapper checks and
//   says so with `vec`); otherwise it is read byte by byte.  The input may be
//   a channel slice of a wider tensor (C2f's split): the wrapper passes the
//   batch, row and pixel strides.
// - The epilogue runs in registers; silu_q stores 4 channels as one 32-bit
//   word where Cout is a multiple of 4.
// Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output pixels a block computes
constexpr int kBN = 64;   // output channels a block computes
constexpr int kBK = 8;    // 32-bit words of the reduction a stage holds
constexpr int kThreads = 256;
constexpr int kTM = 8;    // pixels a thread computes
constexpr int kTN = 4;    // channels a thread computes
constexpr int kALoads = kBK * kBM / kThreads;  // A words a thread loads a stage
constexpr int kBLoads = kBK * kBN / kThreads;  // B words a thread loads a stage

enum Epilogue { kAcc = 0, kLogits = 1, kSiluQ = 2 };

struct Conv {
  const int8_t* x;
  const int32_t* wp;
  const float* sw;
  const float* bias;
  void* out;
  long long sn, sh, sw_px;  // input strides (elements = bytes) of batch, row, pixel
  int h, w, cin;
  int ho, wo, cout;
  int k, stride, pad;
  int cg;  // 4-channel groups a tap: ceil(cin / 4)
  int k4;  // words of the reduction: k * k * cg
  int m;   // output pixels: n * ho * wo
  int vec;
  float inv_s_out;
};

// The output pixel of one A row, decoded once per block.
struct Row {
  const int8_t* base;  // x + n * sn
  int iy0, ix0;        // top-left input coordinate of the window
  bool valid;
};

__device__ __forceinline__ Row decode_row(const Conv& c, int m) {
  Row r;
  r.valid = m < c.m;
  int hw = c.ho * c.wo;
  int n = r.valid ? m / hw : 0;
  int rem = r.valid ? m - n * hw : 0;
  int oy = rem / c.wo;
  int ox = rem - oy * c.wo;
  r.base = c.x + (long long)n * c.sn;
  r.iy0 = oy * c.stride - c.pad;
  r.ix0 = ox * c.stride - c.pad;
  return r;
}

// Word kg of row r: the 4 channels 4g..4g+3 of tap (kh, kw), zero outside.
__device__ __forceinline__ int load_a(const Conv& c, const Row& r, int kg) {
  if (!r.valid || kg >= c.k4) return 0;
  int tap = kg / c.cg;
  int g = kg - tap * c.cg;
  int kh = tap / c.k;
  int kw = tap - kh * c.k;
  int iy = r.iy0 + kh;
  int ix = r.ix0 + kw;
  if (iy < 0 || iy >= c.h || ix < 0 || ix >= c.w) return 0;
  const int8_t* p = r.base + (long long)iy * c.sh + (long long)ix * c.sw_px + 4 * g;
  if (c.vec) return *reinterpret_cast<const int*>(p);
  unsigned v = 0;
  int left = c.cin - 4 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < left) v |= (unsigned)(uint8_t)p[i] << (8 * i);
  }
  return (int)v;
}

__device__ __forceinline__ int load_b(const Conv& c, int kg, int oc) {
  return (kg < c.k4 && oc < c.cout) ? c.wp[(long long)kg * c.cout + oc] : 0;
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads) conv_s8_kernel(Conv c) {
  __shared__ __align__(16) int a_s[2][kBK][kBM];
  __shared__ __align__(16) int b_s[2][kBK][kBN];

  const int t = threadIdx.x;
  const int m_blk = blockIdx.x * kBM;
  const int n_blk = blockIdx.y * kBN;

  // loader roles: A row t % kBM, words t / kBM + 2j; B words t + 256j
  const int a_row = t % kBM;
  const int a_k = t / kBM;
  const Row row = decode_row(c, m_blk + a_row);

  // compute roles: pixels m0..m0+7, channels n0..n0+3
  const int m0 = (t / (kBN / kTN)) * kTM;
  const int n0 = (t % (kBN / kTN)) * kTN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  int a_reg[kALoads], b_reg[kBLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kALoads; ++j) a_reg[j] = load_a(c, row, k0 + a_k + j * (kThreads / kBM));
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      int idx = t + j * kThreads;
      b_reg[j] = load_b(c, k0 + idx / kBN, n_blk + idx % kBN);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kALoads; ++j) a_s[buf][a_k + j * (kThreads / kBM)][a_row] = a_reg[j];
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      int idx = t + j * kThreads;
      b_s[buf][idx / kBN][idx % kBN] = b_reg[j];
    }
  };

  const int stages = (c.k4 + kBK - 1) / kBK;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) fetch((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int4 a_lo = *reinterpret_cast<const int4*>(&a_s[buf][kk][m0]);
      const int4 a_hi = *reinterpret_cast<const int4*>(&a_s[buf][kk][m0 + 4]);
      const int4 b = *reinterpret_cast<const int4*>(&b_s[buf][kk][n0]);
      const int a[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const int bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
    }
    if (s + 1 < stages) stage(buf ^ 1);
    __syncthreads();
  }

  // epilogue
  float sw[kTN], bias[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int oc = n_blk + n0 + j;
    sw[j] = (kEpi != kAcc && oc < c.cout) ? c.sw[oc] : 0.f;
    bias[j] = (kEpi != kAcc && oc < c.cout) ? c.bias[oc] : 0.f;
  }
  const bool full4 = (c.cout % 4 == 0) && (n_blk + n0 + kTN <= c.cout);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m_blk + m0 + i;
    if (m >= c.m) break;
    const long long o = (long long)m * c.cout + n_blk + n0;
    if (kEpi == kAcc) {
      int32_t* out = static_cast<int32_t*>(c.out) + o;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (n_blk + n0 + j < c.cout) out[j] = acc[i][j];
    } else if (kEpi == kLogits) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(c.out) + o;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (n_blk + n0 + j < c.cout) {
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), sw[j]), bias[j]);
          out[j] = __float2bfloat16_rn(y);
        }
      }
    } else {
      unsigned packed = 0;
      int8_t q[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), sw[j]), bias[j]);
        const float h = __fmul_rn(0.5f, y);
        const float s = __fmul_rn(h, __fadd_rn(tanhf(h), 1.0f));
        const float r = fminf(fmaxf(rintf(__fmul_rn(s, c.inv_s_out)), -127.0f), 127.0f);
        q[j] = (int8_t)(int)r;
        packed |= (unsigned)(uint8_t)q[j] << (8 * j);
      }
      int8_t* out = static_cast<int8_t*>(c.out) + o;
      if (full4) {
        *reinterpret_cast<unsigned*>(out) = packed;
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (n_blk + n0 + j < c.cout) out[j] = q[j];
      }
    }
  }
}

}  // namespace

// Launch on `stream`.  Returns the CUDA error of the launch (0 = launched).
// x: int8 (n, h, w, >= cin) with element strides (sn, sh, sw_px), channel
// stride 1; wp: int32 (k*k*ceil(cin/4), cout) packed weights; sw, bias:
// float32 (cout,) (unused for epilogue 0); out: (n, ho, wo, cout) int32,
// bf16 or int8 for epilogue 0, 1 or 2, contiguous.
extern "C" int conv_s8(const void* x, const void* wp, const void* sw, const void* bias, void* out, int n, int h,
                       int w, int cin, long long sn, long long sh, long long sw_px, int cout, int k, int stride,
                       int vec, int epilogue, float inv_s_out, void* stream) {
  Conv c;
  c.x = static_cast<const int8_t*>(x);
  c.wp = static_cast<const int32_t*>(wp);
  c.sw = static_cast<const float*>(sw);
  c.bias = static_cast<const float*>(bias);
  c.out = out;
  c.sn = sn;
  c.sh = sh;
  c.sw_px = sw_px;
  c.h = h;
  c.w = w;
  c.cin = cin;
  c.k = k;
  c.stride = stride;
  c.pad = k / 2;
  c.ho = (h + 2 * c.pad - k) / stride + 1;
  c.wo = (w + 2 * c.pad - k) / stride + 1;
  c.cout = cout;
  c.cg = (cin + 3) / 4;
  c.k4 = k * k * c.cg;
  c.m = n * c.ho * c.wo;
  c.vec = vec;
  c.inv_s_out = inv_s_out;
  if (c.m == 0 || cout == 0) return 0;
  dim3 grid((c.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kAcc:
      conv_s8_kernel<kAcc><<<grid, kThreads, 0, s>>>(c);
      break;
    case kLogits:
      conv_s8_kernel<kLogits><<<grid, kThreads, 0, s>>>(c);
      break;
    case kSiluQ:
      conv_s8_kernel<kSiluQ><<<grid, kThreads, 0, s>>>(c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
