// Tile routines of the f32 attention kernels: the flash forward, dQ and
// dK/dV (flash_attention.cu) and ring attention's block kernel
// (ring_attention.cu) in f32. Every bf16 kernel runs on wgmma
// (attention_fwd_sm90.cuh, attention_bwd_sm90.cuh); the constants, the
// causal rule and the bf16 pair store here are shared with them.
//
// Shapes: head_dim kD = 128; a block owns a 64-row tile and loops over
// 64-row tiles of the other operand; 8 warps, each computing a 16-row
// slice of every product in the mma.sync m16n8 register layout, as f32
// FMAs. Tiles are staged global -> shared memory with 16-byte loads, rows
// padded by 16 bytes against bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
// ----------------------------------------------------------------------

template <int NT, int K, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const float* a, int lda,
                                         const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A_KC ? a[g * lda + k] : a[k * lda + g];
    const float a1 = A_KC ? a[(g + 8) * lda + k] : a[k * lda + g + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = 8 * n + 2 * t;
      const float b0 = B_KC ? b[j * ldb + k] : b[k * ldb + j];
      const float b1 = B_KC ? b[(j + 1) * ldb + k] : b[k * ldb + j + 1];
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

// rows [row0, row0 + ROWS) of one (b, h) slice -> shared tile [ROWS][kD],
// 16-byte loads; rows at or past S are zero
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_s, int row0,
                                          int S) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = kD / kVec;
  constexpr int ld = tile_ld<T>(kD);
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

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// a warp's 16 x 128 accumulator tile (rows r0.., columns c0..) times `mul`
// -> global rows row0 + r (those < S) of one (b, h) slice
template <typename T>
__device__ __forceinline__ void store_acc(T* dst, long long stride_s,
                                          const float (&acc)[8][4], int row0,
                                          int r0, int c0, int S, float mul_lo,
                                          float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
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

template <typename T>
struct Shapes {
  static constexpr int ldd = tile_ld<T>(kD);        // q/k/v/do tiles
  static constexpr int ldp = tile_ld<T>(kBlockK);   // p/ds tiles
  static constexpr int lds = kBlockK + 4;           // f32 score tile
  static constexpr int tile = kBlockQ * ldd;        // elements
  static constexpr int ptile = kBlockQ * ldp;
};

// one forward block's shared memory: q, k, v tiles, the P tile, the f32
// score tile and one f32 per row
template <typename T>
constexpr size_t fwd_smem() {
  using Sh = Shapes<T>;
  return (3 * Sh::tile + Sh::ptile) * sizeof(T) +
         (kBlockQ * Sh::lds + kBlockQ) * sizeof(float);
}

}  // namespace
