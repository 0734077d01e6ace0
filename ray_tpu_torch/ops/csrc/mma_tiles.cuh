// Tile routines of the FMA attention kernels: the flash forward, dQ and
// dK/dV (flash_attention.cu) and ring attention's block kernel
// (ring_attention.cu) in f32 at every head_dim. Every bf16 kernel runs on
// wgmma (attention_fwd_sm90.cuh, attention_bwd_sm90.cuh); the constants,
// the causal rule and the bf16 pair store here are shared with them.
//
// Shapes: head_dim D (a template parameter; each library builds one width,
// kHeadDim below); a block owns a 64-row tile and loops over tiles of
// Tiles<T, D>::kLoop rows of the other operand (64, or 32 where three f32
// tiles of 64 rows would not fit in shared memory: D = 256); 8 warps, each
// computing a 16-row slice of every product in the mma.sync m16n8 register
// layout, as f32 FMAs on values converted to f32 (no tensor cores, no
// TF32). Tiles are staged global -> shared memory with 16-byte loads, rows
// padded by 16 bytes against bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A library is one head width and its bf16 routes, which ops/_build.py
// sets from ops/head_dims.py: RAY_TPU_HEAD_DIM, and RAY_TPU_SM90_FORWARD /
// RAY_TPU_SM90_BACKWARD (1: bf16 runs the wgmma template, 0: these tiles)
#if !defined(RAY_TPU_HEAD_DIM) || !defined(RAY_TPU_SM90_FORWARD) || \
    !defined(RAY_TPU_SM90_BACKWARD)
#error "build with -DRAY_TPU_HEAD_DIM, -DRAY_TPU_SM90_FORWARD and -DRAY_TPU_SM90_BACKWARD (ops/_build.py)"
#endif

namespace {

constexpr int kHeadDim = RAY_TPU_HEAD_DIM;   // this library's width
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(bf16 x) {
  return __bfloat162float(x);
}

// whether a key at global position `key` is visible to a query at `query`
__device__ __forceinline__ bool causal_visible(long long query,
                                               long long key, bool causal) {
  return (!causal || key <= query);
}

// row stride of a shared-memory tile with `cols` columns: 16 bytes of pad
template <typename T>
__host__ __device__ constexpr int tile_ld(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// ----------------------------------------------------------------------
// warp-level tile products. Each warp accumulates a 16 x (8*NT) tile
//   acc += A[16 x K] * B[K x 8*NT]
// in the mma.sync m16n8k16 accumulator layout: lane (g = lane/4,
// t = lane%4) holds C(g, 8n+2t), C(g, 8n+2t+1), C(g+8, 8n+2t),
// C(g+8, 8n+2t+1) in acc[n][0..3].
//   A(i, k) = A_KC ? a[i*lda + k] : a[k*lda + i]
//   B(k, j) = B_KC ? b[j*ldb + k] : b[k*ldb + j]
// (f32 or bf16 operands, converted to f32)
// ----------------------------------------------------------------------

template <int NT, int K, bool A_KC, bool B_KC, typename TA, typename TB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const TA* a,
                                         int lda, const TB* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = as_float(A_KC ? a[g * lda + k] : a[k * lda + g]);
    const float a1 =
        as_float(A_KC ? a[(g + 8) * lda + k] : a[k * lda + g + 8]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = 8 * n + 2 * t;
      const float b0 = as_float(B_KC ? b[j * ldb + k] : b[k * ldb + j]);
      const float b1 =
          as_float(B_KC ? b[(j + 1) * ldb + k] : b[k * ldb + j + 1]);
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// rows [row0, row0 + ROWS) of one (b, h) slice -> shared tile [ROWS][D],
// 16-byte loads; rows at or past S are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_s, int row0,
                                          int S) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int ld = tile_ld<T>(D);
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < S) {
      val = *reinterpret_cast<const int4*>(src + (row0 + r) * stride_s + c);
    }
    *reinterpret_cast<int4*>(dst + r * ld + c) = val;
  }
}

// load_tile of a head width d up to the tile's D (kernel 2 in f32 at
// every width): the 16-byte vectors from column d on read as zeros. A vector that d cuts reads on past d, so
// each row must hold whole vectors (a width that is not a multiple of 16
// bytes' values comes zero-padded to one: ops/ring_attention.py)
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_cols(T* dst, const T* src,
                                               long long stride_s, int row0,
                                               int S, int d) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int ld = tile_ld<T>(D);
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < S && c < d) {
      val = *reinterpret_cast<const int4*>(src + (row0 + r) * stride_s + c);
    }
    *reinterpret_cast<int4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// a warp's 16 x 8NT accumulator tile (rows r0.., columns c0..) times `mul`
// -> global rows row0 + r (those < S) of one (b, h) slice
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* dst, long long stride_s,
                                          const float (&acc)[NT][4], int row0,
                                          int r0, int c0, int S, float mul_lo,
                                          float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    const int lo = row0 + r0 + g, hi = lo + 8;
    if (lo < S) {
      store_pair(dst + lo * stride_s + c, acc[n][0] * mul_lo,
                 acc[n][1] * mul_lo);
    }
    if (hi < S) {
      store_pair(dst + hi * stride_s + c, acc[n][2] * mul_hi,
                 acc[n][3] * mul_hi);
    }
  }
}

// store_acc (f32, unscaled) at a head width d up to the accumulator's
// columns: rows of d values, each value stored alone where its column is
// below d
template <int NT>
__device__ __forceinline__ void store_acc_cols(float* dst, long long stride_s,
                                               const float (&acc)[NT][4],
                                               int row0, int r0, int c0,
                                               int S, int d) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    const int lo = row0 + r0 + g, hi = lo + 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e < d) {
        if (lo < S) dst[lo * stride_s + c + e] = acc[n][e];
        if (hi < S) dst[hi * stride_s + c + e] = acc[n][2 + e];
      }
    }
  }
}

// A block's tiles at head_dim D: its own 64-row tile, the loop's tiles of
// kLoop rows, the P / dS tile [64][kLoop] and the f32 score tile. Each warp
// owns 16 rows (warp & 3), half the loop tile's columns for the scores
// (kScoreNT n-tiles) and half of head_dim for the outputs (kOutNT).
template <typename T, int D>
struct Tiles {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "head_dim 16, 32, 64, 128 or 256");
  // 64 rows, but 32 where f32 at D = 256 would not fit (three 64 x 256 f32
  // tiles alone are 199,680 bytes)
  static constexpr int kLoop = D * (int)sizeof(T) >= 1024 ? 32 : 64;
  static constexpr int ldd = tile_ld<T>(D);         // q/k/v/do tiles
  static constexpr int ldp = tile_ld<T>(kLoop);     // p/ds tiles
  static constexpr int lds = kLoop + 4;             // f32 score tile
  static constexpr int own = kBlockQ * ldd;         // elements
  static constexpr int loop = kLoop * ldd;
  static constexpr int ptile = kBlockQ * ldp;
  static constexpr int kScoreNT = kLoop / 16;
  static constexpr int kOutNT = D / 16;
};

// one forward block's shared memory: q, k, v tiles, the P tile, the f32
// score tile and one f32 per row
template <typename T, int D>
constexpr size_t fwd_smem() {
  using Sh = Tiles<T, D>;
  return (Sh::own + 2 * Sh::loop + Sh::ptile) * sizeof(T) +
         (kBlockQ * Sh::lds + kBlockQ) * sizeof(float);
}

}  // namespace
