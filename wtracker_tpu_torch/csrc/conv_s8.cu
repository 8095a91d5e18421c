// int8 NHWC x int8 HWIO convolution with exact int32 accumulation and a fused
// float32 epilogue, on Hopper's int8 tensor cores (sm_90a).
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
// (zero outside the image), exact in int32 (|acc| < 9*512*127*127 < 2^31, so
// any order of the sums, tensor-core tiles and split-K partial sums included,
// gives the same bits), then one of three epilogues, each value rounded as
// the plain version rounds it (one torch operation at a time, so no fused
// multiply-add):
//   kAcc:    the int32 accumulators;
//   kLogits: bf16(float(acc) * sw[oc] + b[oc]);
//   kSiluQ:  y = float(acc) * sw[oc] + b[oc];  h = 0.5 * y;
//            s = h * (tanh(h) + 1);  int8(clip(rint(s * inv_s_out), +-127)).
// The products and sums use __fmul_rn / __fadd_rn, which the compiler never
// contracts, and tanhf / rintf (round half to even, as torch.round).
//
// What bounds it on the H100 (1,979 int8 TOP/s dense, 3.35 TB/s): a
// YOLOv8s@416 forward is ~144 G int8 operations (2 per multiply-add) at 12
// views.  At N = 12 every convolution is small (M = N*Ho*Wo from 2,028 to
// 519,168 pixels): the bounds sum to ~0.12 ms, set by the bytes
// (activations in and out), and what a kernel reaches there is set by
// filling 132 SMs with tiles and by each block's fixed cost (the ring's
// first fill, the epilogue).  At N = 360 the 3x3 convolutions from 52x52
// down are bound by their operations (2*9*Cin*Cout per pixel against
// Cin + Cout bytes), the 1x1 convolutions and the 104x104 / 208x208 levels
// by their bytes; the bounds sum to ~3.3 ms.  The CUDA cores' __dp4a
// (about 134 TOP/s at most) cannot approach either; wgmma on the tensor
// cores can.
//
// Design:
// - An implicit GEMM, M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin in the
//   order kidx = (kh*k + kw)*Cin + ci, so the Cin channels of one tap of one
//   pixel are contiguous bytes of NHWC: A is K-major as it lies in memory.
//   The wrapper packs the weights once, K-major too: wp[oc][kidx], int8,
//   Cout padded with zero rows to a multiple of 8 and K with zero columns to
//   a multiple of 32 (ops/conv_s8.py :: pack_weights).
// - The product is wgmma.mma_async m64nBNk32 .s32.s8.s8, A and B from shared
//   memory, the int32 sums in registers.  A block is two warpgroups and
//   computes a tile of kTileH x kTileW = 16 x 8 output pixels of one view
//   (kBM = 128 rows, 64 a warpgroup) by BN = 8, 32, 64 or 128 channels.
// - A ring of kStages shared-memory stages, each kBK = 64 bytes of the
//   reduction (two k32 steps), kept kStages - 1 steps ahead, one mbarrier a
//   stage.  One thread starts the stage's TMA copies: the weights as 32-byte
//   x BN boxes of wp, and, where Cin is a multiple of 32 and the input's base
//   and strides are 16-byte aligned (`vec`: every layer of YOLOv8s but b0),
//   the activations as 32-channel x 8 x 16-pixel boxes of the input seen as
//   a (Cin, W, H, N) tensor through its own strides, taken every `stride`
//   pixels and shifted by the tap, so that TMA zero-fills the padding and
//   the ragged edge.  Both land 32-byte swizzled, as wgmma's layout type 3
//   reads them.  Other inputs (b0's Cin = 3, an unaligned channel slice)
//   get a kernel whose threads gather A byte by byte into no-swizzle core
//   matrices instead.
// - Split-K where the tiles fall below half a wave of 132 SMs (the 13x13
//   and 26x26 levels and heads at N = 12): the `split` blocks of a tile form
//   one thread-block cluster along grid z, each sums its share of the K
//   steps, and the partial sums are added through distributed shared
//   memory, each block of the cluster then running the epilogue of its
//   share of the tile's rows.  One launch per convolution, no scratch.  The
//   tile and split choice is ops/conv_s8.py :: plan.
// - The epilogue: the tile's int32 sums go through shared memory, and each
//   thread then runs the epilogue on 16 bytes of output of one pixel (4
//   int32, 8 bf16 or 16 int8 channels) and stores them with one 16-byte
//   store where Cout is a multiple of that width.
// The input may be a channel slice of a wider tensor (C2f's split): the
// wrapper passes the batch, row and pixel strides.  Offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;     // pixels a block computes: two warpgroups of 64 rows
constexpr int kTileW = 8;    // ... as a tile of 16 output rows x 8 output columns
constexpr int kTileH = kBM / kTileW;
constexpr int kBK = 64;      // bytes of the reduction a stage holds: two wgmma k32 steps
constexpr int kKS = 32;      // bytes of one wgmma k step (a TMA box's width)
constexpr int kStages = 4;   // shared-memory stages of the ring
constexpr int kRedPad = 4;   // int32 of padding a row of the reduction tile (bank spread)
constexpr int kMaxSplit = 8;  // blocks of a cluster (the portable limit)

enum Epilogue { kAcc = 0, kLogits = 1, kSiluQ = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* wp;
  const float* sw;
  const float* bias;
  void* out;
  long long sn, sh, spx;  // input strides (elements = bytes) of batch, row, pixel
  int h, w, cin;
  int ho, wo, cout;
  int k, stride, pad;
  int kdim;    // k * k * cin
  int kp;      // kdim padded to a multiple of 32: wp's row length
  int coutp;   // cout padded to a multiple of 8: wp's rows
  int m;       // output pixels: n * ho * wo
  int tiles_x, tiles_y;  // output tiles of kTileW x kTileH a row and a column of one view
  int ksteps;  // stages of kBK bytes over kp
  int split;   // blocks of a cluster, each summing ksteps / split of the steps
  int epilogue;
  float inv_s_out;
};

__host__ __device__ constexpr int smem_bytes(int bn) {
  return kStages * (kBM + bn) * kBK > kBM * (bn + kRedPad) * 4 ? kStages * (kBM + bn) * kBK
                                                                 : kBM * (bn + kRedPad) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory writes of the generic proxy (the byte gather's st.shared)
// made visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptors (start address, LBO, SBO in 16-byte units,
// layout type in bits 62-63), K-major, one wgmma k step (32 bytes) of K:
// - what TMA writes with 32-byte swizzle: rows of 32 bytes, 8-row groups
//   256 bytes apart (SBO), LBO unused (1), layout type 3;
// - what the byte gather writes, no swizzle: 8-row x 16-byte core
//   matrices, the two along K 128 bytes apart (LBO), 8-row groups 256 bytes
//   apart (SBO), layout type 0.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | 1ull << 16 | static_cast<uint64_t>(256 >> 4) << 32 |
         3ull << 62;
}
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// D (64 x N, int32, registers) += A (64 x 32, int8) * B (32 x N, int8)^T
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// A tile of kTileH x kTileW output pixels of one view: tile index `tile`
// (blockIdx.x) into view n, top-left output (oy0, ox0).
struct Tile {
  int n, oy0, ox0;
};

__device__ __forceinline__ Tile decode_tile(const Conv& c, int tile) {
  Tile t;
  const int per_view = c.tiles_x * c.tiles_y;
  t.n = tile / per_view;
  const int rem = tile - t.n * per_view;
  const int ty = rem / c.tiles_x;
  t.oy0 = ty * kTileH;
  t.ox0 = (rem - ty * c.tiles_x) * kTileW;
  return t;
}

// Output pixel of tile row r (r = y * kTileW + x), or -1 outside the image.
__device__ __forceinline__ int tile_pixel(const Conv& c, const Tile& t, int r) {
  const int oy = t.oy0 + r / kTileW;
  const int ox = t.ox0 + r % kTileW;
  return oy < c.ho && ox < c.wo ? (t.n * c.ho + oy) * c.wo + ox : -1;
}

// The byte gather (inputs that cannot be TMA boxes: Cin not a multiple of
// 32, or an input not 16-byte aligned, as b0's Cin = 3): the 16 bytes kidx ..
// kidx + 15 of tile row r's im2col row into shared memory at dst, zero
// outside the image and beyond kdim.
__device__ __forceinline__ void gather_bytes(const Conv& c, const Tile& t, int r, int kidx, uint8_t* dst) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  const int oy = t.oy0 + r / kTileW;
  const int ox = t.ox0 + r % kTileW;
  if (oy < c.ho && ox < c.wo && kidx < c.kdim) {
    const int8_t* base = c.x + (long long)t.n * c.sn;
    int tap = kidx / c.cin;
    int ci = kidx - tap * c.cin;
    int kh = tap / c.k;
    int kw = tap - kh * c.k;
    for (int b = 0; b < 16; ++b) {
      const int iy = oy * c.stride - c.pad + kh;
      const int ix = ox * c.stride - c.pad + kw;
      if (kidx + b < c.kdim && iy >= 0 && iy < c.h && ix >= 0 && ix < c.w)
        v[b >> 2] |= (uint32_t)(uint8_t)base[iy * c.sh + ix * c.spx + ci] << (8 * (b & 3));
      if (++ci == c.cin) {
        ci = 0;
        if (++kw == c.k) {
          kw = 0;
          ++kh;
        }
      }
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <int kBytes>
__device__ __forceinline__ void store_vec(void* dst, const void* src) {
  static_assert(kBytes == 16 || kBytes == 8, "16- or 8-byte stores");
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

// Rows [row_lo, row_hi) of the tile: sum the int32 tiles of the cluster's
// `split` blocks (or this block's alone), run the epilogue on V channels of
// one pixel at a time (16 bytes of output) and store them.
template <int BN, int EPI>
__device__ __forceinline__ void store_rows(const Conv& c, int32_t* red, const Tile& t, int n_blk, int row_lo,
                                           int row_hi) {
  using Out = typename std::conditional<EPI == kAcc, int32_t,
                                        typename std::conditional<EPI == kLogits, __nv_bfloat16, int8_t>::type>::type;
  constexpr int V = 16 / (int)sizeof(Out) < BN ? 16 / (int)sizeof(Out) : BN;
  constexpr int kPerRow = BN / V;
  constexpr int kRS = BN + kRedPad;
  const int items = (row_hi - row_lo) * kPerRow;
  const bool wide = c.cout % V == 0;
  for (int item = threadIdx.x; item < items; item += 2 * kBM) {
    const int r = row_lo + item / kPerRow;
    const int col = (item % kPerRow) * V;
    const int m = tile_pixel(c, t, r);
    const int oc = n_blk + col;
    if (m < 0 || oc >= c.cout) continue;
    int a[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = 0;
    for (int p = 0; p < c.split; ++p) {
      const int32_t* src = c.split > 1 ? cg::this_cluster().map_shared_rank(red, p) : red;
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(src + r * kRS + col + j);
        a[j] += q.x;
        a[j + 1] += q.y;
        a[j + 2] += q.z;
        a[j + 3] += q.w;
      }
    }
    alignas(16) Out o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (EPI == kAcc) {
        o[j] = a[j];
      } else {
        const int ocj = oc + j < c.cout ? oc + j : c.cout - 1;
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(a[j]), c.sw[ocj]), c.bias[ocj]);
        if constexpr (EPI == kLogits) {
          o[j] = __float2bfloat16_rn(y);
        } else {
          const float hh = __fmul_rn(0.5f, y);
          const float s = __fmul_rn(hh, __fadd_rn(tanhf(hh), 1.0f));
          const float q = fminf(fmaxf(rintf(__fmul_rn(s, c.inv_s_out)), -127.0f), 127.0f);
          o[j] = (int8_t)(int)q;
        }
      }
    }
    Out* dst = static_cast<Out*>(c.out) + (long long)m * c.cout + oc;
    if (wide) {
      store_vec<V * (int)sizeof(Out)>(dst, o);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (oc + j < c.cout) dst[j] = o[j];
    }
  }
}

// TMA: the activations as a 4-D tensor (Cin bytes, W, H, N) with the
// input's strides, boxes of 32 channels x 8 x 16 pixels taken every
// `stride` pixels (zero outside the image); the packed weights as a 2-D
// tensor (kp, coutp), boxes of 32 bytes x BN rows.  Both swizzled by 32 bytes.
template <int BN, bool TMA_A>
__global__ void __launch_bounds__(2 * kBM) conv_s8_kernel(const Conv c, const __grid_constant__ CUtensorMap map_a,
                                                          const __grid_constant__ CUtensorMap map_b) {
  constexpr int kThreads = 2 * kBM;  // two warpgroups of 128 threads
  constexpr int kASub = kBM * kKS;    // bytes of one k step of A
  constexpr int kBSub = BN * kKS;     // ... of B
  constexpr int kSubs = kBK / kKS;    // k steps a stage
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];  // a stage's TMA bytes have landed
  uint8_t* a_s = smem;                                   // kStages x kSubs x kASub
  uint8_t* b_s = smem + kStages * kSubs * kASub;         // kStages x kSubs x kBSub
  int32_t* red = reinterpret_cast<int32_t*>(smem);       // kBM x (BN + kRedPad), after the main loop

  const int t = threadIdx.x;
  const Tile tile = decode_tile(c, blockIdx.x);
  const int n_blk = blockIdx.y * BN;
  const int s_begin = (int)((long long)blockIdx.z * c.ksteps / c.split);
  const int nsteps = (int)((long long)(blockIdx.z + 1) * c.ksteps / c.split) - s_begin;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's i-th K step into ring slot `slot`: thread 0 starts its TMA
  // boxes; with the byte gather, every thread writes its share of A
  auto load_stage = [&](int slot, int i) {
    const int k0 = (s_begin + i) * kBK;
    uint8_t* a_dst = a_s + slot * kSubs * kASub;
    uint8_t* b_dst = b_s + slot * kSubs * kBSub;
    if (t == 0) {
      int subs = 0;
      for (int j = 0; j < kSubs; ++j) subs += k0 + j * kKS < c.kp;
      mbar_expect_tx(&full[slot], subs * ((TMA_A ? kASub : 0) + kBSub));
      for (int j = 0; j < kSubs; ++j) {
        const int kidx = k0 + j * kKS;
        if (kidx >= c.kp) break;
        tma_load_2d(b_dst + j * kBSub, &map_b, &full[slot], kidx, n_blk);
        if constexpr (TMA_A) {
          const int tap = kidx / c.cin;
          const int kh = tap / c.k;
          const int kw = tap - kh * c.k;
          tma_load_4d(a_dst + j * kASub, &map_a, &full[slot], kidx - tap * c.cin,
                      tile.ox0 * c.stride - c.pad + kw, tile.oy0 * c.stride - c.pad + kh, tile.n);
        }
      }
    }
    if constexpr (!TMA_A) {
      // a k step's A: 8-row groups of two 16-byte chunks (no swizzle)
      for (int q = t; q < kSubs * kBM * 2; q += kThreads) {
        const int j = q / (kBM * 2);
        const int r = (q / 2) % kBM;
        const int ch = q % 2;
        gather_bytes(c, tile, r, k0 + j * kKS + ch * 16,
                     a_dst + j * kASub + (r >> 3) * 256 + ch * 128 + (r & 7) * 16);
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int wg = t / 128;
  const uint32_t a_base = smem_addr(a_s) + wg * 64 * kKS;  // this warpgroup's 64 rows
  const uint32_t b_base = smem_addr(b_s);

  for (int p = 0; p < kStages - 1 && p < nsteps; ++p) load_stage(p, p);
  for (int it = 0; it < nsteps; ++it) {
    const int slot = it % kStages;
    mbar_wait(&full[slot], (it / kStages) & 1);
    if constexpr (!TMA_A) fence_proxy_async();
    __syncthreads();  // step it's A is written, and step it - 1's wgmma are done with their slot
    const int next = it + kStages - 1;
    if (next < nsteps) load_stage(next % kStages, next);
    const int k0 = (s_begin + it) * kBK;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSubs; ++j) {
      if (k0 + j * kKS < c.kp) {
        const uint32_t a = a_base + (slot * kSubs + j) * kASub;
        const uint32_t b = b_base + (slot * kSubs + j) * kBSub;
        wgmma_s8<BN>(acc, TMA_A ? desc_sw32(a) : desc_plain(a), desc_sw32(b));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  }
  __syncthreads();  // the ring is free: the tile's sums take its place

  // the accumulators into the int32 tile: wgmma's D layout, thread (warp w,
  // lane l) of warpgroup g holds rows 64g + 16w + l/4 (+8), columns
  // 8j + 2(l%4) (+1)
  constexpr int kRS = BN + kRedPad;
  {
    const int lane = t % 32;
    const int r0 = wg * 64 + ((t % 128) / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<int2*>(&red[(r0 + 8 * hi) * kRS + 8 * j + c0]) =
            make_int2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
  }

  int row_lo = 0, row_hi = kBM;
  if (c.split > 1) {
    cg::this_cluster().sync();  // every block's partial tile is written
    const int rank = (int)cg::this_cluster().block_rank();
    row_lo = rank * kBM / c.split;
    row_hi = (rank + 1) * kBM / c.split;
  } else {
    __syncthreads();
  }
  switch (c.epilogue) {
    case kAcc:
      store_rows<BN, kAcc>(c, red, tile, n_blk, row_lo, row_hi);
      break;
    case kLogits:
      store_rows<BN, kLogits>(c, red, tile, n_blk, row_lo, row_hi);
      break;
    default:
      store_rows<BN, kSiluQ>(c, red, tile, n_blk, row_lo, row_hi);
      break;
  }
  if (c.split > 1) cg::this_cluster().sync();  // no block leaves while a peer reads its tile
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (the library links only
// the CUDA runtime)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 32-byte-swizzled uint8 map; dims and strides innermost first
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, const cuuint32_t* elem_strides) {
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool TMA_A>
int launch(const Conv& c, int n, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(BN);
  static bool smem_set = false;  // once a process (one card)
  cudaError_t err;
  if (!smem_set) {
    err = cudaFuncSetAttribute(conv_s8_kernel<BN, TMA_A>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  alignas(64) CUtensorMap map_a = {};
  alignas(64) CUtensorMap map_b = {};
  {
    const cuuint64_t dims[2] = {(cuuint64_t)c.kp, (cuuint64_t)c.coutp};
    const cuuint64_t strides[1] = {(cuuint64_t)c.kp};
    const cuuint32_t box[2] = {kKS, BN};
    const cuuint32_t one[2] = {1, 1};
    if (!encode(&map_b, c.wp, 2, dims, strides, box, one)) return (int)cudaErrorInvalidValue;
  }
  if (TMA_A) {
    const cuuint64_t dims[4] = {(cuuint64_t)c.cin, (cuuint64_t)c.w, (cuuint64_t)c.h, (cuuint64_t)n};
    const cuuint64_t strides[3] = {(cuuint64_t)c.spx, (cuuint64_t)c.sh, (cuuint64_t)c.sn};
    const cuuint32_t box[4] = {kKS, (cuuint32_t)(kTileW * c.stride), (cuuint32_t)(kTileH * c.stride), 1};
    const cuuint32_t elem[4] = {1, (cuuint32_t)c.stride, (cuuint32_t)c.stride, 1};
    if (!encode(&map_a, c.x, 4, dims, strides, box, elem)) return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * c.tiles_x * c.tiles_y, (c.cout + BN - 1) / BN, c.split);
  cfg.blockDim = dim3(2 * kBM);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_s8_kernel<BN, TMA_A>, c, map_a, map_b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool TMA_A>
int launch_bn(const Conv& c, int n, int bn, cudaStream_t stream) {
  switch (bn) {
    case 8:
      return launch<8, TMA_A>(c, n, stream);
    case 32:
      return launch<32, TMA_A>(c, n, stream);
    case 64:
      return launch<64, TMA_A>(c, n, stream);
    case 128:
      return launch<128, TMA_A>(c, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`.  Returns the CUDA error of the launch (0 = launched).
// x: int8 (n, h, w, >= cin) with element strides (sn, sh, sw_px), channel
// stride 1; wp: int8 (ceil8(cout), ceil32(k*k*cin)) packed K-major weights,
// 16-byte aligned; sw, bias: float32 (cout,) (unused for epilogue 0); out:
// (n, ho, wo, cout) int32, bf16 or int8 for epilogue 0, 1 or 2, contiguous.
// vec: x may be read as TMA boxes (cin % 32 == 0, base and strides 16-byte
// aligned).  bn, split: the tile's width and the K split (ops/conv_s8.py ::
// plan).
extern "C" int conv_s8(const void* x, const void* wp, const void* sw, const void* bias, void* out, int n, int h,
                       int w, int cin, long long sn, long long sh, long long sw_px, int cout, int k, int stride,
                       int vec, int epilogue, float inv_s_out, int bn, int split, void* stream) {
  Conv c;
  c.x = static_cast<const int8_t*>(x);
  c.wp = static_cast<const int8_t*>(wp);
  c.sw = static_cast<const float*>(sw);
  c.bias = static_cast<const float*>(bias);
  c.out = out;
  c.sn = sn;
  c.sh = sh;
  c.spx = sw_px;
  c.h = h;
  c.w = w;
  c.cin = cin;
  c.k = k;
  c.stride = stride;
  c.pad = k / 2;
  c.ho = (h + 2 * c.pad - k) / stride + 1;
  c.wo = (w + 2 * c.pad - k) / stride + 1;
  c.cout = cout;
  c.kdim = k * k * cin;
  c.kp = (c.kdim + 31) / 32 * 32;
  c.coutp = (cout + 7) / 8 * 8;
  c.m = n * c.ho * c.wo;
  c.tiles_x = (c.wo + kTileW - 1) / kTileW;
  c.tiles_y = (c.ho + kTileH - 1) / kTileH;
  c.ksteps = (c.kp + kBK - 1) / kBK;
  c.split = split;
  c.epilogue = epilogue;
  c.inv_s_out = inv_s_out;
  if (c.m == 0 || cout == 0) return 0;
  if (epilogue < kAcc || epilogue > kSiluQ || split < 1 || split > kMaxSplit || split > c.ksteps ||
      (vec && cin % 32 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bn<true>(c, n, bn, s) : launch_bn<false>(c, n, bn, s);
}
