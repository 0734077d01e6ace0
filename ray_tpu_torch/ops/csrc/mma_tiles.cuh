// Tile routines of the mma.sync attention kernels: the flash backward
// kernels (flash_attention.cu: dQ, dK/dV) and the f32 instances of the
// flash forward and of ring attention's block kernel (flash_attention.cu,
// ring_attention.cu). The bf16 forwards run on attention_fwd_sm90.cuh.
//
// Shapes: head_dim kD = 128; a block owns a 64-row tile and loops over
// 64-row tiles of the other operand; 8 warps, each computing a 16-row
// slice of every product. Tiles are staged global -> shared memory with
// 16-byte loads, rows padded by 16 bytes against bank conflicts.

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
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
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
// ----------------------------------------------------------------------

// four 8x8 bf16 matrices from shared memory (ldmatrix): lanes 8m..8m+7
// give the row addresses of matrix m; lane (g, t) receives, in r[m],
// elements (g, 2t) and (g, 2t+1) of matrix m, or with TRANS (2t, g) and
// (2t+1, g) — the mma.sync fragment layouts
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: every operand tile is fed to mma.sync by ldmatrix. A is always
// k-contiguous; B is read transposed when it is stored k-major.
template <int NT, int K, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb) {
  static_assert(A_KC && NT % 2 == 0, "A k-contiguous, n-tiles in pairs");
  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, lm = lane >> 3;   // row in, and index of, matrix
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    // a0..a3: rows 0-7 / 8-15 x k 0-7, then the same x k 8-15
    uint32_t af[4];
    ldmatrix_x4<false>(af, a + ((lm & 1) * 8 + lr) * lda + k0 + (lm >> 1) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      // b0, b1 of n-tile n, then of n-tile n + 1
      uint32_t bf[4];
      if (B_KC) {
        ldmatrix_x4<false>(
            bf, b + (8 * (n + (lm >> 1)) + lr) * ldb + k0 + (lm & 1) * 8);
      } else {
        ldmatrix_x4<true>(
            bf, b + (k0 + (lm & 1) * 8 + lr) * ldb + 8 * (n + (lm >> 1)));
      }
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

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
