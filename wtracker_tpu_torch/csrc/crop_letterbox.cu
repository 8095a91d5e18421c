// Fused camera crop -> bilinear resize -> 1/255 normalize, for sm_90a.
//
// Replaces the Pallas TPU kernel wtracker_tpu/ops/pallas_preproc.py ::
// crop_letterbox_views (kernel body _make_kernel).  For each of N views it
// crops cam x cam pixels of frames[frame_idx[i]] at top_lefts[i] = (x, y),
// scales by 1/255 and resizes to imgsz x imgsz with half-pixel-centre
// bilinear weights, the source coordinate clamped to [0, cam - 1] as
// wtracker_tpu/ops/image._interp_matrix does.  Accumulation is float32 with
// one rounding at the store (bfloat16 or float32); the caller broadcasts the
// single channel to three.  The plain PyTorch version is
// wtracker_tpu_torch/ops/preproc.py :: crop_letterbox_reference.
//
// Bound on the H100: memory.  At the main path's shapes (cam 360 -> 416,
// bf16 out) a view reads 360*360 B and writes 416*416*2 B; N = 12 moves
// 1.56 MB + 4.15 MB, about 1.7 us at 3.35 TB/s, and N = 3 about 0.43 us.
// About 10 float operations per output pixel are far below the compute
// bound.  At these sizes the launch itself costs more than the bound.
//
// Design, simple first: a grid of (ceil(imgsz / kTileRows), N) blocks.  Each
// block loads its own view's frame index and crop origin (what scalar
// prefetch did on the TPU) and writes kTileRows output rows; each thread
// computes whole output pixels as a separable 2-tap lerp, rows first and
// then columns, in the order of the Pallas body (a_h @ x, then @ a_w^T).
// The Pallas kernel's tile-aligned DMA window, residual-shift folding and
// chunk padding existed only for Mosaic's layout rules: here the crop is
// read at any offset straight from the unpadded chunk, through L1/L2 (each
// source byte is read by about four neighbouring output pixels).  Offsets
// are 64-bit: a chunk may hold more than 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;
constexpr int kThreads = 256;

struct Tap {
  int lo;
  int hi;
  float w;
};

// Source taps of output coordinate o.  The half-pixel centre
// src = (o + 0.5) * cam / imgsz - 0.5 = num / den is kept as an exact
// fraction: in float32 a coordinate near 360 carries an ulp of 3e-5, which
// the weights would inherit, while the plain version's weights are exact to
// float32 rounding.  src is clamped to [0, cam - 1] and hi is clamped too: at
// the far edge the frame has no slack past the crop.
__device__ __forceinline__ Tap make_tap(int o, int cam, int imgsz) {
  const int den = 2 * imgsz;
  const int num = (2 * o + 1) * cam - imgsz;
  Tap t;
  t.lo = num <= 0 ? 0 : min(num / den, cam - 1);
  t.hi = min(t.lo + 1, cam - 1);
  const bool clamped = num <= 0 || t.lo == cam - 1;
  t.w = clamped ? 0.0f : static_cast<float>(num - t.lo * den) / static_cast<float>(den);
  return t;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) crop_letterbox_kernel(
    const uint8_t* __restrict__ frames, const int32_t* __restrict__ frame_idx,
    const int32_t* __restrict__ top_lefts, T* __restrict__ out, int C, int H, int W,
    int cam, int imgsz) {
  const int view = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  // clamped like jax.lax.dynamic_slice clamps, so no index reads outside the chunk
  const int f = min(max(frame_idx[view], 0), C - 1);
  const int x0 = min(max(top_lefts[2 * view], 0), W - cam);
  const int y0 = min(max(top_lefts[2 * view + 1], 0), H - cam);
  const uint8_t* crop = frames + (static_cast<int64_t>(f) * H + y0) * W + x0;
  T* dst = out + static_cast<int64_t>(view) * imgsz * imgsz;

  const float inv255 = 1.0f / 255.0f;
  const int rows = min(kTileRows, imgsz - row0);
  for (int t = threadIdx.x; t < rows * imgsz; t += kThreads) {
    const int r = row0 + t / imgsz;
    const int c = t - (t / imgsz) * imgsz;
    const Tap ty = make_tap(r, cam, imgsz);
    const Tap tx = make_tap(c, cam, imgsz);
    const uint8_t* src_lo = crop + static_cast<int64_t>(ty.lo) * W;
    const uint8_t* src_hi = crop + static_cast<int64_t>(ty.hi) * W;
    const float a = (1.0f - ty.w) * (static_cast<float>(src_lo[tx.lo]) * inv255) +
                    ty.w * (static_cast<float>(src_hi[tx.lo]) * inv255);
    const float b = (1.0f - ty.w) * (static_cast<float>(src_lo[tx.hi]) * inv255) +
                    ty.w * (static_cast<float>(src_hi[tx.hi]) * inv255);
    store(dst + static_cast<int64_t>(r) * imgsz + c, (1.0f - tx.w) * a + tx.w * b);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; top_lefts is (n, 2) int32 in (x, y) order.
extern "C" int crop_letterbox(const void* frames, const void* frame_idx, const void* top_lefts,
                              void* out, int n, int C, int H, int W, int cam, int imgsz,
                              int out_bf16, void* stream) {
  const dim3 grid((imgsz + kTileRows - 1) / kTileRows, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* fr = static_cast<const uint8_t*>(frames);
  const int32_t* idx = static_cast<const int32_t*>(frame_idx);
  const int32_t* tls = static_cast<const int32_t*>(top_lefts);
  if (out_bf16) {
    crop_letterbox_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        fr, idx, tls, static_cast<__nv_bfloat16*>(out), C, H, W, cam, imgsz);
  } else {
    crop_letterbox_kernel<float><<<grid, kThreads, 0, s>>>(
        fr, idx, tls, static_cast<float*>(out), C, H, W, cam, imgsz);
  }
  return static_cast<int>(cudaGetLastError());
}
