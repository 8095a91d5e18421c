// Bias + SiLU after each BN-fused convolution of the detector, in place, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package's ConvBN with fused weights
// (wtracker_tpu/models/yolov8.py) adds the bias and applies SiLU after the
// convolution, and XLA fuses both into the convolution's output.  On the card
// cuDNN returns the convolution without its bias; eager PyTorch then adds the
// bias in a broadcast pass and evaluates SiLU as 0.5*y*(tanh(0.5*y) + 1) in
// five more, each reading and writing the whole activation.  This kernel is
// the six passes as one, on the convolution's output:
//     y = float(x) + float(bias[c]);  out = 0.5f*y*(tanhf(0.5f*y) + 1.0f)
// rounded once to the tensor's type (bfloat16 or float32).  The plain version
// is wtracker_tpu_torch/ops/bias_silu.py :: bias_silu_reference.
//
// Bound on the H100: memory.  Each element is read once and written once: 4
// bytes in bfloat16, 8 in float32.  b2.cv1's 360 x 64 x 104 x 104 bfloat16
// output moves 1.0 GB, 0.298 ms at 3.35 TB/s; the kernel takes 0.35 ms,
// within 2 % of the same kernel that only loads and stores (PERF.md): the
// arithmetic, the accurate tanhf's included, hides behind the memory.
//
// Design:
// - 16-byte loads and stores: 8 bfloat16 or 4 float32 values a thread a step,
//   in a grid-stride loop over kBlocksPerSm blocks of 256 threads an SM.  The
//   elements past the last whole vector go one a thread.  The tensor must
//   start 16-byte aligned, as the caching allocator's blocks do.
// - The biases are staged once a block in shared memory as float32 (at most
//   kMaxChannels, which the wrapper mirrors and checks).
// - The channel of element i follows the layout the wrapper observes from the
//   strides: channels-last, c = i % C; NCHW-contiguous, c = (i / HW) % C.  A
//   thread divides once, for its first vector, then steps its channel (and,
//   NCHW, its offset in the channel's plane) element by element and by the
//   loop's stride with adds, compares and one subtraction, so a vector may
//   straddle channels (NCHW at 13 x 13 and 26 x 26: HW = 169 and 676).
// - Accurate tanhf, not tanh.approx, and __fadd_rn / __fmul_rn, which the
//   compiler never contracts: in float32 the kernel repeats the plain
//   version's operations one for one.
// Offsets are 64-bit: an activation of 360 views may pass 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;  // four times what an SM holds at once: 1.5-2 % faster than 8 (PERF.md)
constexpr int kMaxChannels = 12288;  // float32 biases in the default 48 KB of shared memory

enum Layout { kChannelsLast = 0, kChannelsFirst = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float biased_silu(float x, float b) {
  const float h = __fmul_rn(0.5f, __fadd_rn(x, b));
  return __fmul_rn(h, __fadd_rn(tanhf(h), 1.0f));
}

// Where an element lies: its channel c and, channels-first, its offset r in
// the channel's plane.
struct Pos {
  int c;
  int r;
};

template <int kLayout>
__device__ __forceinline__ Pos locate(long long i, int C, int HW) {
  if (kLayout == kChannelsLast) return {static_cast<int>(i % C), 0};
  const long long q = i / HW;
  return {static_cast<int>(q % C), static_cast<int>(i - q * HW)};
}

// p moved on by d elements, given step = locate(d).
template <int kLayout>
__device__ __forceinline__ void advance(Pos& p, Pos step, int C, int HW) {
  if (kLayout == kChannelsFirst) {
    p.r += step.r;
    if (p.r >= HW) {
      p.r -= HW;
      p.c += 1;
    }
  }
  p.c += step.c;  // < 2C
  if (p.c >= C) p.c -= C;
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec, int kLayout>
__global__ void __launch_bounds__(kThreads) bias_silu_kernel(T* __restrict__ x, const T* __restrict__ bias,
                                                             long long n, int C, int HW) {
  extern __shared__ float s_bias[];
  for (int j = threadIdx.x; j < C; j += kThreads) s_bias[j] = to_float(bias[j]);
  __syncthreads();

  const long long nvec = n / kVec;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  Pack<T, kVec>* vx = reinterpret_cast<Pack<T, kVec>*>(x);
  if (first < nvec) {
    const Pos step = locate<kLayout>(stride * kVec, C, HW);
    const Pos one = locate<kLayout>(1, C, HW);
    Pos p = locate<kLayout>(first * kVec, C, HW);
    for (long long v = first; v < nvec; v += stride) {
      Pack<T, kVec> pk = vx[v];
      Pos e = p;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        pk.v[k] = from_float<T>(biased_silu(to_float(pk.v[k]), s_bias[e.c]));
        advance<kLayout>(e, one, C, HW);
      }
      vx[v] = pk;
      advance<kLayout>(p, step, C, HW);
    }
  }
  // the elements past the last whole vector, one a thread (fewer than kVec)
  const long long t = nvec * kVec + first;
  if (t < n) x[t] = from_float<T>(biased_silu(to_float(x[t]), s_bias[locate<kLayout>(t, C, HW).c]));
}

template <typename T, int kLayout>
int launch(void* x, const void* bias, long long n, int C, int HW, int sms, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long wanted = (n / kVec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(wanted < 1 ? 1 : (wanted < sms * kBlocksPerSm ? wanted : sms * kBlocksPerSm));
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  bias_silu_kernel<T, kVec, kLayout>
      <<<blocks, kThreads, smem, stream>>>(static_cast<T*>(x), static_cast<const T*>(bias), n, C, HW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_layout(void* x, const void* bias, long long n, int C, int HW, int channels_first, int sms,
                  cudaStream_t stream) {
  return channels_first ? launch<T, kChannelsFirst>(x, bias, n, C, HW, sms, stream)
                        : launch<T, kChannelsLast>(x, bias, n, C, HW, sms, stream);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).  x is
// a dense (N, C, H, W) tensor of n elements, channels-last
// (channels_first = 0) or NCHW-contiguous (1), rewritten in place; bias holds
// C values of x's type; HW = H * W; sms is the card's SM count.  Needs
// 1 <= C <= kMaxChannels, n >= 1 and x 16-byte aligned.
extern "C" int bias_silu(void* x, const void* bias, long long n, int C, int HW, int channels_first, int bf16,
                         int sms, void* stream) {
  if (C < 1 || C > kMaxChannels || HW < 1 || n < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_layout<__nv_bfloat16>(x, bias, n, C, HW, channels_first, sms, s);
  return launch_layout<float>(x, bias, n, C, HW, channels_first, sms, s);
}
