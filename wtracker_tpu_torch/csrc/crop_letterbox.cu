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
// The frame chunk is cold in L2 when the loop calls the kernel (the
// detector runs in between), so what a block pays first is the latency of
// device memory, and then its stores.  Measured on the card (PERF.md), the
// kernel stays well above that bound: after the launch, the instructions of
// the two lerp passes take the largest share of its time, not its memory.
//
// Design:
// - Taps from a table.  The wrapper reads each output coordinate's two
//   source indices and weights out of the plain version's interpolation
//   matrix once per (cam, imgsz, device) and passes the table; the weights
//   are the plain version's bit for bit and the kernel does no division.
//   Views are square, so one table serves rows and columns.
// - One asynchronous load per band.  A block owns one view and R = kBandRows
//   = 4 consecutive output rows; the grid is (ceil(imgsz / R), N).  On the
//   H100, R = 4 was the fastest of 2, 4, 8 and 16 at N = 12 and N = 3
//   (PERF.md); the wrapper mirrors it as BAND_ROWS to size shared memory.
//   A block copies the source rows its band reads, each as the
//   16-byte-aligned superset of its cam bytes, into shared memory with
//   cp.async.cg: every copy is issued before the one wait, so a block waits
//   for device memory once instead of once per pixel.  The row pitch of the chunk (1671 at the
//   deployment) is not a multiple of 16, so each row keeps its own shift
//   into its staged bytes; for the same reason TMA is not used (a tensor map
//   needs 16-byte global strides) and the chunk stays unpadded.  A 16-byte
//   copy that would cross either end of `frames` (a view need not start
//   aligned) is read byte by byte, so nothing outside the tensor is read.
//   The band's row taps join the same copy group, and each thread loads its
//   column taps before the wait, so no global load is left after it.
// - Rows first, columns second, the order of the plain version (a_h @ x,
//   then @ a_w^T): the block lerps each of its R output rows over all cam
//   source columns into shared memory (each source byte is converted once
//   per output row, not once per tap; a thread does all R rows of a column,
//   2R independent loads, so the pass is not one latency chain), then a
//   thread owns 8 consecutive output columns, keeps their 8 column taps in
//   registers across the band's rows, and writes its 8 values as one
//   16-byte store in bf16 (two in f32); an imgsz that is not a multiple of 8
//   stores element by element.  At imgsz 416 a block is 64 threads (52 busy
//   in this pass), so at R = 4 all 1,248 blocks of N = 12 are resident at
//   once; 128-thread blocks that split the rows needed a second wave and
//   were slower.
// - No tensor cores.  The Pallas kernel multiplied dense interpolation
//   matrices on the MXU (about 0.25 GFLOP a view) because the TPU's vector
//   unit gathers poorly; on Hopper the 2-tap form costs about 10 operations
//   an output pixel and the bound is bytes, so wgmma would have nothing to
//   do.
// Offsets are 64-bit: a chunk may hold more than 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandRows = 4;  // output rows of one view a block writes
constexpr int kCols = 8;      // output columns a thread owns: one 16-byte bf16 store
constexpr int kMaxThreads = 256;
constexpr int kDefaultSharedBytes = 48 * 1024;

// An output coordinate's taps, as the wrapper packs them: the two source
// indices and their weights (lo == hi and w_hi == 0 where the coordinate has
// one source pixel: at a clamped edge, or on a source pixel's centre).
struct __align__(16) Tap {
  int lo;
  int hi;
  float w_lo;
  float w_hi;
};

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// float(b) for a byte b, exactly, in two full-rate operations: 2^23 + b has
// b in its low mantissa bits (the conversion instruction runs at a quarter
// of the rate)
__device__ __forceinline__ float byte_to_float(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kCols], int valid, bool vec) {
  if (vec && valid == kCols) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < valid; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a at the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kCols], int valid, bool vec) {
  if (vec && valid == kCols) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
    for (int j = 0; j < valid; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// Shared memory of a block: the band's row taps, its row-lerped output rows
// (R x cam floats), then its staged source rows (band_src_rows x pitch).
__host__ __device__ __forceinline__ int staged_offset(int cam) {
  return (kBandRows * 16 + kBandRows * cam * 4 + 15) / 16 * 16;
}

// Threads of a block: enough to cover an output row, 8 columns each, in
// whole warps, at most kMaxThreads (a wider row loops).
inline int block_threads(int imgsz) {
  return min(kMaxThreads, ((imgsz + kCols - 1) / kCols + 31) / 32 * 32);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) crop_letterbox_kernel(
    const uint8_t* __restrict__ frames, const int32_t* __restrict__ frame_idx,
    const int32_t* __restrict__ top_lefts, const Tap* __restrict__ taps, T* __restrict__ out,
    int C, int H, int W, int cam, int imgsz, int pitch) {
  constexpr int R = kBandRows;
  extern __shared__ __align__(16) uint8_t smem[];
  Tap* row_taps = reinterpret_cast<Tap*>(smem);
  float* mid = reinterpret_cast<float*>(smem + R * 16);
  uint8_t* staged = smem + staged_offset(cam);
  const int view = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, imgsz - row0);
  // clamped like jax.lax.dynamic_slice clamps, so no index reads outside the chunk
  const int f = min(max(frame_idx[view], 0), C - 1);
  const int x0 = min(max(top_lefts[2 * view], 0), W - cam);
  const int y0 = min(max(top_lefts[2 * view + 1], 0), H - cam);
  const int src0 = taps[row0].lo;  // first crop row the band reads
  const int n_src = taps[row0 + rows - 1].hi - src0 + 1;
  const uintptr_t begin = reinterpret_cast<uintptr_t>(frames);
  const uintptr_t end = begin + static_cast<uint64_t>(C) * H * W;
  const uintptr_t first = begin + (static_cast<uint64_t>(f) * H + y0 + src0) * W + x0;

  // 1. one copy group: the band's row taps, and crop rows src0 ..
  //    src0 + n_src - 1, row r's cam bytes at staged + r * pitch + shift(r)
  for (int y = threadIdx.x; y < rows; y += blockDim.x) {
    cp_async16(row_taps + y, reinterpret_cast<uintptr_t>(taps + row0 + y));
  }
  const int chunks = pitch / 16;
  for (int k = threadIdx.x; k < n_src * chunks; k += blockDim.x) {
    const int r = k / chunks;
    const int c = k - r * chunks;
    const uintptr_t row = first + static_cast<uint64_t>(r) * W;
    if (c * 16 >= static_cast<int>(row & 15) + cam) continue;
    const uintptr_t g = (row & ~static_cast<uintptr_t>(15)) + c * 16;
    uint8_t* s = staged + r * pitch + c * 16;
    if (g >= begin && g + 16 <= end) {
      cp_async16(s, g);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (g + b >= begin && g + b < end) s[b] = *reinterpret_cast<const uint8_t*>(g + b);
      }
    }
  }
  // this thread's first 8 output columns and their taps, in flight with the copies
  int c0 = threadIdx.x * kCols;
  Tap tx[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) tx[j] = taps[min(c0 + j, imgsz - 1)];
  cp_async_wait_all();
  __syncthreads();

  // 2. rows: mid[y][x] = w_lo * x[lo_y][x] / 255 + w_hi * x[hi_y][x] / 255,
  //    every row of the band at once (2R independent loads a column)
  const float inv255 = 1.0f / 255.0f;
  int off_lo[R], off_hi[R];
  float w_lo[R], w_hi[R];
#pragma unroll
  for (int y = 0; y < R; ++y) {
    const Tap ty = row_taps[min(y, rows - 1)];
    const int r_lo = ty.lo - src0, r_hi = ty.hi - src0;
    off_lo[y] = r_lo * pitch + static_cast<int>((first + static_cast<uint64_t>(r_lo) * W) & 15);
    off_hi[y] = r_hi * pitch + static_cast<int>((first + static_cast<uint64_t>(r_hi) * W) & 15);
    w_lo[y] = ty.w_lo;
    w_hi[y] = ty.w_hi;
  }
  for (int x = threadIdx.x; x < cam; x += blockDim.x) {
#pragma unroll
    for (int y = 0; y < R; ++y) {
      if (y < rows) {
        mid[y * cam + x] = w_lo[y] * (byte_to_float(staged[off_lo[y] + x]) * inv255) +
                           w_hi[y] * (byte_to_float(staged[off_hi[y] + x]) * inv255);
      }
    }
  }
  __syncthreads();

  // 3. columns: 8 output columns a thread, every row of the band
  const bool vec = imgsz % kCols == 0;
  T* dst = out + static_cast<int64_t>(view) * imgsz * imgsz;
  for (; c0 < imgsz; c0 += blockDim.x * kCols) {
    if (c0 != static_cast<int>(threadIdx.x) * kCols) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) tx[j] = taps[min(c0 + j, imgsz - 1)];
    }
    const int valid = min(kCols, imgsz - c0);
    for (int y = 0; y < rows; ++y) {
      const float* m = mid + y * cam;
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = tx[j].w_lo * m[tx[j].lo] + tx[j].w_hi * m[tx[j].hi];
      store8(dst + static_cast<int64_t>(row0 + y) * imgsz + c0, v, valid, vec);
    }
  }
}

template <typename T>
int launch(const void* frames, const void* frame_idx, const void* top_lefts, const void* taps,
           void* out, int n, int C, int H, int W, int cam, int imgsz, int band_src_rows,
           cudaStream_t stream) {
  const int pitch = (cam + 15 + 15) / 16 * 16;  // cam bytes after a shift of up to 15
  const size_t smem = staged_offset(cam) + static_cast<size_t>(band_src_rows) * pitch;
  const int threads = block_threads(imgsz);
  const dim3 grid((imgsz + kBandRows - 1) / kBandRows, n);
  auto kernel = crop_letterbox_kernel<T>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int32_t*>(frame_idx),
      static_cast<const int32_t*>(top_lefts), static_cast<const Tap*>(taps), static_cast<T*>(out),
      C, H, W, cam, imgsz, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// Pointers are device pointers; top_lefts is (n, 2) int32 in (x, y) order;
// taps is (imgsz, 4) 32-bit words (lo, hi, w_lo, w_hi) from the wrapper;
// band_src_rows is the most source rows any band of kBandRows output rows
// reads.
extern "C" int crop_letterbox(const void* frames, const void* frame_idx, const void* top_lefts,
                              const void* taps, void* out, int n, int C, int H, int W, int cam,
                              int imgsz, int band_src_rows, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch<__nv_bfloat16>(frames, frame_idx, top_lefts, taps, out, n, C, H, W, cam, imgsz,
                                 band_src_rows, s);
  }
  return launch<float>(frames, frame_idx, top_lefts, taps, out, n, C, H, W, cam, imgsz,
                       band_src_rows, s);
}
