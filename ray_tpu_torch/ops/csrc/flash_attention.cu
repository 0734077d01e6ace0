// Flash attention for Hopper (sm_90a), CUDA C++: forward, backward dQ and
// backward dK/dV, the three kernels of the train step's attention.
//
// Replaces the library Pallas TPU flash attention that
// ray_tpu/ops/flash.py::flash_attention_bhsd (:42) calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//   flash_attention_fwd     -> the forward pallas_call (:758)
//   flash_attention_bwd_dq  -> _flash_attention_bwd_dq's pallas_call (:1456)
//   flash_attention_bwd_dkv -> _flash_attention_bwd_dkv's pallas_call (:1121)
// Same functions as the plain PyTorch versions in
// ray_tpu_torch/ops/flash.py (_flash_fwd_reference, _flash_bwd_dq_reference,
// _flash_bwd_dkv_reference):
//
//   s = (q k^T) * scale (f32), masked to -1e30 where key >= S or, causal,
//   key > query; lse = logsumexp_row(s); p = exp(s - lse); o = p v.
//   Backward, with di = rowsum(o * do) computed by the caller:
//   dp = do v^T; ds = p * (dp - di); dq = ds k * scale;
//   dk = ds^T q * scale; dv = p^T do.
//
// q, k, v, o, do, dq, dk, dv: logical [B, H, S, D] in bf16 or f32 (one
// dtype), any strides over B, H, S shared by all of them, unit stride over
// D; lse and di: [B, H, S] f32 contiguous. D must be 128. S is any length:
// the ragged last tile is masked by bounds, nothing is padded.
//
// Bound: operations. At the train shape (B=16, H=16, S=2047, D=128, causal)
// the forward does two products of 2*B*H*S^2*D/2 flops each (2.7e11), dQ
// three (4.1e11) and dK/dV four (5.5e11), against ~0.3-0.4 GB of operands:
// ~1000 flops per byte, well above the H100's ~295 bf16 flops/byte balance
// point, so the least time is flops / 989 TFLOP/s.
//
// Design. The TPU kernels walk a sequential grid and carry the online
// softmax (forward) or the dK/dV and dQ sums (backward) in VMEM scratch
// across grid steps. Hopper runs blocks unordered on 132 SMs, so each block
// owns one output tile and loops over the other axis itself:
//   forward: block = (b, h, 64-query tile); loop over key tiles up to the
//            diagonal; online softmax (m, l) per row; O in registers.
//   dQ:      block = (b, h, 64-query tile); loop over key tiles up to the
//            diagonal; dQ in registers.
//   dK/dV:   block = (b, h, 64-key tile); loop over query tiles from the
//            diagonal on; dK and dV in registers.
// Every output element is written by exactly one block and summed in a
// fixed order: no atomics, so a launch is deterministic and the forward
// recomputed under activation checkpointing is bit-identical.
// Tiles are staged global -> shared memory with 16-byte loads (rows padded
// by 16 bytes against bank conflicts); 8 warps each compute a 16-row slice
// of every product. bf16 products run on the tensor cores with mma.sync
// m16n8k16 (f32 accumulate); f32 products run as f32 FMAs in the same
// register layout (no TF32). P and dS go through shared memory in the input
// dtype, as the reference casts the probabilities to the compute dtype.
// Operand fragments come from shared memory through ldmatrix (transposed
// where the tile is stored k-major). Later work, not done here: wgmma and
// TMA, warp specialisation, cp.async double buffering, register-resident P
// (no shared-memory round trip).

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

// The tile routines from here to the kernels (tile_ld, ldmatrix_x4,
// mma_bf16, warp_mma, zero, load_tile, store_acc, Shapes) have a copy in
// ring_attention.cu; a fix to one belongs in the other. The copy stays
// until both kernels share one header (ROADMAP.md, Queue A, item 1).

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

// f32 values of row vector `src` (length S, rows >= S read as 0) for the
// tile's rows
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
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

__device__ __forceinline__ bool visible(int query, int key, int S,
                                        bool causal) {
  return query < S && key < S && (!causal || key <= query);
}

template <typename T>
struct Shapes {
  static constexpr int ldd = tile_ld<T>(kD);        // q/k/v/do tiles
  static constexpr int ldp = tile_ld<T>(kBlockK);   // p/ds tiles
  static constexpr int lds = kBlockK + 4;           // f32 score tile
  static constexpr int tile = kBlockQ * ldd;        // elements
  static constexpr int ptile = kBlockQ * ldp;
};

// ----------------------------------------------------------------------
// forward (3a): block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T>
constexpr size_t fwd_smem() {
  using Sh = Shapes<T>;
  return (3 * Sh::tile + Sh::ptile) * sizeof(T) +
         (kBlockQ * Sh::lds + kBlockQ) * sizeof(float);
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int S, long long sb,
                 long long sh, long long ss, float scale) {
  using Sh = Shapes<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + Sh::tile;
  T* vs = ks + Sh::tile;
  T* ps = vs + Sh::tile;
  float* sc_s = reinterpret_cast<float*>(ps + Sh::ptile);
  float* row_s = sc_s + kBlockQ * Sh::lds;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // this warp's 16 rows of every tile
  const int wcs = (warp >> 2) * 32;   // its 32 score columns
  const int wco = (warp >> 2) * 64;   // its 64 output columns
  const int sr = tid >> 2, sj = tid & 3;   // softmax: 4 threads per row

  load_tile<T, kBlockQ>(qs, q + base, ss, q0, S);

  float m_run = kNegInf, l_run = 0.f;   // row sr's stats (all 4 threads)
  float acc[8][4];
  zero(acc);
  const int n_k = (S + kBlockK - 1) / kBlockK;
  const int kt_end = CAUSAL ? min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1) : n_k;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // the last tile's readers are done
    load_tile<T, kBlockK>(ks, k + base, ss, k0, S);
    load_tile<T, kBlockK>(vs, v + base, ss, k0, S);
    __syncthreads();

    float sc[4][4];
    zero(sc);
    warp_mma<4, kD, true, true>(sc, qs + wr * Sh::ldd, Sh::ldd,
                                ks + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1);
        const int c = wcs + 8 * n + 2 * t + (e & 1);
        // rows past S see no key: their m is -1e30, their p 1, and they
        // are never stored
        sc_s[r * Sh::lds + c] = visible(q0 + r, k0 + c, S, CAUSAL)
                                    ? sc[n][e] * scale
                                    : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: row sr, columns sj, sj + 4, ... (bank-conflict free)
    {
      float x[kBlockK / 4];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBlockK / 4; ++i) {
        x[i] = sc_s[sr * Sh::lds + sj + 4 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockK / 4; ++i) {
        const float p = expf(x[i] - m_new);
        sum += p;
        ps[sr * Sh::ldp + sj + 4 * i] = from_float<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sj == 0) row_s[sr] = alpha;
    }
    __syncthreads();

    const float a_lo = row_s[wr + g], a_hi = row_s[wr + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }
    warp_mma<8, kBlockK, true, false>(acc, ps + wr * Sh::ldp, Sh::ldp,
                                      vs + wco, Sh::ldd);
  }

  __syncthreads();   // every warp has read row_s (alpha)
  if (sj == 0) {
    row_s[sr] = l_run;
    if (q0 + sr < S) lse[(long long)bh * S + q0 + sr] = m_run + logf(l_run);
  }
  __syncthreads();
  store_acc(o + base, ss, acc, q0, wr, wco, S, 1.f / row_s[wr + g],
            1.f / row_s[wr + g + 8]);
}

// ----------------------------------------------------------------------
// backward dQ (3c): block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T>
constexpr size_t dq_smem() {
  using Sh = Shapes<T>;
  return (4 * Sh::tile + Sh::ptile) * sizeof(T) + 2 * kBlockQ * sizeof(float);
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int S, long long sb, long long sh, long long ss,
                    float scale) {
  using Sh = Shapes<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + Sh::tile;
  T* ks = dos + Sh::tile;
  T* vs = ks + Sh::tile;
  T* dss = vs + Sh::tile;
  float* lse_s = reinterpret_cast<float*>(dss + Sh::ptile);
  float* di_s = lse_s + kBlockQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;
  const int wcs = (warp >> 2) * 32;
  const int wco = (warp >> 2) * 64;

  load_tile<T, kBlockQ>(qs, q + base, ss, q0, S);
  load_tile<T, kBlockQ>(dos, dout + base, ss, q0, S);
  load_rows(lse_s, lse + (long long)bh * S, q0, S);
  load_rows(di_s, di + (long long)bh * S, q0, S);

  float acc[8][4];
  zero(acc);
  const int n_k = (S + kBlockK - 1) / kBlockK;
  const int kt_end = CAUSAL ? min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1) : n_k;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile<T, kBlockK>(ks, k + base, ss, k0, S);
    load_tile<T, kBlockK>(vs, v + base, ss, k0, S);
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    warp_mma<4, kD, true, true>(sc, qs + wr * Sh::ldd, Sh::ldd,
                                ks + wcs * Sh::ldd, Sh::ldd);
    warp_mma<4, kD, true, true>(dp, dos + wr * Sh::ldd, Sh::ldd,
                                vs + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1);
        const int c = wcs + 8 * n + 2 * t + (e & 1);
        const float p = visible(q0 + r, k0 + c, S, CAUSAL)
                            ? expf(sc[n][e] * scale - lse_s[r])
                            : 0.f;
        dss[r * Sh::ldp + c] = from_float<T>(p * (dp[n][e] - di_s[r]));
      }
    }
    __syncthreads();
    warp_mma<8, kBlockK, true, false>(acc, dss + wr * Sh::ldp, Sh::ldp,
                                      ks + wco, Sh::ldd);
  }
  store_acc(dq + base, ss, acc, q0, wr, wco, S, scale, scale);
}

// ----------------------------------------------------------------------
// backward dK/dV (3b): block = (64-key tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T>
constexpr size_t dkv_smem() {
  using Sh = Shapes<T>;
  return (4 * Sh::tile + 2 * Sh::ptile) * sizeof(T) +
         2 * kBlockQ * sizeof(float);
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, long long sb,
                     long long sh, long long ss, float scale) {
  using Sh = Shapes<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + Sh::tile;
  T* qs = vs + Sh::tile;
  T* dos = qs + Sh::tile;
  T* pts = dos + Sh::tile;    // P^T  [key][query]
  T* dsts = pts + Sh::ptile;  // dS^T [key][query]
  float* lse_s = reinterpret_cast<float*>(dsts + Sh::ptile);
  float* di_s = lse_s + kBlockQ;

  const int kt = blockIdx.x;   // low key tiles see the most queries
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int k0 = kt * kBlockK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // 16 key rows
  const int wcs = (warp >> 2) * 32;   // 32 query columns of P^T
  const int wco = (warp >> 2) * 64;   // 64 head_dim columns of dK, dV

  load_tile<T, kBlockK>(ks, k + base, ss, k0, S);
  load_tile<T, kBlockK>(vs, v + base, ss, k0, S);

  float acc_dk[8][4], acc_dv[8][4];
  zero(acc_dk);
  zero(acc_dv);
  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  const int qt_begin = CAUSAL ? k0 / kBlockQ : 0;

  for (int qt = qt_begin; qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    load_tile<T, kBlockQ>(qs, q + base, ss, q0, S);
    load_tile<T, kBlockQ>(dos, dout + base, ss, q0, S);
    load_rows(lse_s, lse + (long long)bh * S, q0, S);
    load_rows(di_s, di + (long long)bh * S, q0, S);
    __syncthreads();

    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    warp_mma<4, kD, true, true>(st, ks + wr * Sh::ldd, Sh::ldd,
                                qs + wcs * Sh::ldd, Sh::ldd);
    warp_mma<4, kD, true, true>(dpt, vs + wr * Sh::ldd, Sh::ldd,
                                dos + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1);          // key
        const int c = wcs + 8 * n + 2 * t + (e & 1);  // query
        const float p = visible(q0 + c, k0 + r, S, CAUSAL)
                            ? expf(st[n][e] * scale - lse_s[c])
                            : 0.f;
        pts[r * Sh::ldp + c] = from_float<T>(p);
        dsts[r * Sh::ldp + c] = from_float<T>(p * (dpt[n][e] - di_s[c]));
      }
    }
    __syncthreads();
    warp_mma<8, kBlockQ, true, false>(acc_dv, pts + wr * Sh::ldp, Sh::ldp,
                                      dos + wco, Sh::ldd);
    warp_mma<8, kBlockQ, true, false>(acc_dk, dsts + wr * Sh::ldp, Sh::ldp,
                                      qs + wco, Sh::ldd);
  }
  store_acc(dk + base, ss, acc_dk, k0, wr, wco, S, scale, scale);
  store_acc(dv + base, ss, acc_dv, k0, wr, wco, S, 1.f, 1.f);
}

// ----------------------------------------------------------------------
// launches
// ----------------------------------------------------------------------

struct Geometry {
  int B, H, S;
  long long sb, sh, ss;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool CAUSAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const Geometry& g, float scale,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<T>();
  auto kernel = flash_fwd_kernel<T, CAUSAL>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.S + kBlockQ - 1) / kBlockQ, g.B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      g.H, g.S, g.sb, g.sh, g.ss, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, const Geometry& g, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem<T>();
  auto kernel = flash_bwd_dq_kernel<T, CAUSAL>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.S + kBlockQ - 1) / kBlockQ, g.B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), g.H, g.S, g.sb, g.sh, g.ss, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, const Geometry& g, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem<T>();
  auto kernel = flash_bwd_dkv_kernel<T, CAUSAL>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.S + kBlockK - 1) / kBlockK, g.B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), g.H, g.S, g.sb, g.sh, g.ss,
      scale);
  return cudaGetLastError();
}

cudaError_t check(int B, int H, int S, int D, int device) {
  if (B <= 0 || H <= 0 || S <= 0 || D != kD) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// The three entry points. q, k, v, o/do/dq/dk/dv share the strides
// (sb, sh, ss) in elements over (batch, head, seq); head_dim D must be 128;
// lse and di are [B, H, S] f32. causal: 0 or 1. dtype: 0 = float32,
// 1 = bfloat16. Each returns the launch's cudaError_t.

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int S, int D, long long sb,
                                   long long sh, long long ss, int causal,
                                   int dtype, int device, void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_FWD(T, C) launch_fwd<T, C>(q, k, v, o, lse, g, scale, s)
  if (dtype == 0) {
    return (int)(causal ? CALL_FWD(float, true) : CALL_FWD(float, false));
  }
  if (dtype == 1) {
    return (int)(causal ? CALL_FWD(bf16, true) : CALL_FWD(bf16, false));
  }
#undef CALL_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int S, int D,
                                      long long sb, long long sh,
                                      long long ss, int causal, int dtype,
                                      int device, void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_DQ(T, C) \
  launch_dq<T, C>(q, k, v, dout, lse, di, dq, g, scale, s)
  if (dtype == 0) {
    return (int)(causal ? CALL_DQ(float, true) : CALL_DQ(float, false));
  }
  if (dtype == 1) {
    return (int)(causal ? CALL_DQ(bf16, true) : CALL_DQ(bf16, false));
  }
#undef CALL_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int B, int H,
                                       int S, int D, long long sb,
                                       long long sh, long long ss,
                                       int causal, int dtype, int device,
                                       void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_DKV(T, C) \
  launch_dkv<T, C>(q, k, v, dout, lse, di, dk, dv, g, scale, s)
  if (dtype == 0) {
    return (int)(causal ? CALL_DKV(float, true) : CALL_DKV(float, false));
  }
  if (dtype == 1) {
    return (int)(causal ? CALL_DKV(bf16, true) : CALL_DKV(bf16, false));
  }
#undef CALL_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
