// Ring attention's block kernel for Hopper (sm_90a), CUDA C++: one ring
// step's attention of a query block against one KV block, unnormalised.
//
// Replaces ray_tpu/ops/ring_attention.py::_block_kernel (:64), the Pallas
// TPU kernel reached through _block_attention_pallas (:94, pallas_call
// :111). Same function as the plain PyTorch version in
// ray_tpu_torch/ops/ring_attention.py (_block_attention_reference):
//
//   s = (q k^T) * scale (f32), masked to -1e30 where, causal, the key's
//   global position k_offset + j exceeds the query's q_offset + i;
//   m = max_row(s); p = exp(s - m), and p = 0 in a row with no visible key;
//   l = sum_row(p); o = p v, NOT divided by l.
//
// q: logical [B, H, Tq, D]; k, v: [B, Hkv, Tk, D] with Hkv dividing H
// (query head j reads KV head j / (H / Hkv): grouped-query attention
// without repeating K and V). One dtype, bf16 or f32; any strides over
// B, H and the sequence (one set each for q, k, v), unit stride over D;
// D must be 128. Offsets are any host ints; Tq may differ from Tk. Ragged
// tails are masked by bounds, nothing is padded. Outputs o [B, H, Tq, D],
// m and l [B, H, Tq], all f32 and contiguous. A row with no visible key
// gets o = 0, m = -1e30, l = 0: the merge of the ring then scales it away.
//
// Bound: operations. On the ring's path (q [1, 16, 8192, 128], k/v
// [1, 8, 8192, 128], bf16) a block below the diagonal does two products of
// 2*B*H*Tq*Tk*D flops each (5.5e11 together) against ~0.13 GB of operands
// and outputs: ~4000 flops per byte, far above the H100's ~295 bf16 flops
// per byte, so the least time is flops / 989 TFLOP/s. A diagonal block
// does half that; a block whose keys all follow its queries does no
// arithmetic and only writes its outputs.
//
// Design. The TPU kernel runs a grid (batch, head, query tile) and holds
// the whole local KV block in VMEM (:117-119), computing one [Tq, Tk]
// score matrix at once. On Hopper a block has 227 KB of shared memory, so
// the key axis becomes a loop: each block owns one (batch, head, 64-query
// tile) and walks 64-key tiles with a running max, sum and rescaled f32
// accumulator (online softmax), as the flash forward kernel does
// (flash_attention.cu, flash_fwd_kernel). The loop stops after the last key
// tile holding a column some row of the tile can see under the global
// offsets; a tile that sees no key loads nothing and writes the
// fully-masked values. Inside a tile, a row whose visible columns have not
// started yet keeps m = -1e30 and takes p = 0 (the reference's
// `where(m > NEG_INF/2, p, 0)`, :84-85), not exp(0) = 1 per masked column.
// bf16 products run on the tensor cores (mma.sync m16n8k16 fed by
// ldmatrix, f32 accumulate): the bf16 products are exact in f32, so
// scores, m and l match the reference's f32 cast up to summation order.
// P is rounded to bf16 for the P v product, as the flash kernels do; l sums
// the f32 P. f32 inputs take f32 FMAs in the same register layout (no
// TF32). Every output element is written by one block in a fixed order:
// launches are deterministic. Later work, not done here: wgmma and TMA,
// register-resident P, double buffering.
//
// The tile routines below (tile_ld to Shapes) are the flash kernels'
// (flash_attention.cu), repeated rather than shared through a header:
// flash_mutants.py mutates that file's copy in place to show which checks
// reject a broken kernel. A fix to one copy belongs in the other; the
// copy goes when both kernels move onto one header (ROADMAP.md, Queue A,
// item 1).

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
//   A(i, k) = a[i*lda + k]
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

// bf16: every operand tile is fed to mma.sync by ldmatrix; B is read
// transposed when it is stored k-major
template <int NT, int K, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
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

template <int NT, int K, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const float* a, int lda,
                                         const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
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

// a warp's 16 x 128 f32 accumulator tile (rows r0.., columns c0..) -> rows
// row0 + r (those < S) of one contiguous [S, kD] f32 slice
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[8][4],
                                          int row0, int r0, int c0, int S) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    const int lo = row0 + r0 + g, hi = lo + 8;
    if (lo < S) {
      *reinterpret_cast<float2*>(dst + (long long)lo * kD + c) =
          make_float2(acc[n][0], acc[n][1]);
    }
    if (hi < S) {
      *reinterpret_cast<float2*>(dst + (long long)hi * kD + c) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <typename T>
struct Shapes {
  static constexpr int ldd = tile_ld<T>(kD);        // q/k/v tiles
  static constexpr int ldp = tile_ld<T>(kBlockK);   // p tile
  static constexpr int lds = kBlockK + 4;           // f32 score tile
  static constexpr int tile = kBlockQ * ldd;        // elements
  static constexpr int ptile = kBlockQ * ldp;
};

template <typename T>
constexpr size_t block_smem() {
  using Sh = Shapes<T>;
  return (3 * Sh::tile + Sh::ptile) * sizeof(T) +
         (kBlockQ * Sh::lds + kBlockQ) * sizeof(float);
}

// element strides over (batch, head, sequence)
struct Strides {
  long long b, h, s;
};

// ----------------------------------------------------------------------
// kernel 2: block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
ring_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out, int H,
                  int rep, int Tq, int Tk, int q_offset, int k_offset,
                  Strides sq, Strides sk, Strides sv, float scale) {
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
  const int b = bh / H, h = bh % H, hk = h / rep;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // this warp's 16 rows of every tile
  const int wcs = (warp >> 2) * 32;   // its 32 score columns
  const int wco = (warp >> 2) * 64;   // its 64 output columns
  const int sr = tid >> 2, sj = tid & 3;   // softmax: 4 threads per row

  // key tiles up to the last one holding a column that the tile's last
  // row (global position q_offset + rows - 1) can see
  const int n_k = (Tk + kBlockK - 1) / kBlockK;
  int kt_end = n_k;
  if (CAUSAL) {
    const long long last_key =
        (long long)q_offset + min(q0 + kBlockQ, Tq) - 1 - k_offset;
    kt_end = last_key < 0 ? 0
                          : (int)min((long long)n_k, last_key / kBlockK + 1);
  }
  if (kt_end > 0) load_tile<T, kBlockQ>(qs, qb, sq.s, q0, Tq);

  float m_run = kNegInf, l_run = 0.f;   // row sr's stats (all 4 threads)
  float acc[8][4];
  zero(acc);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // the last tile's readers are done
    load_tile<T, kBlockK>(ks, kb, sk.s, k0, Tk);
    load_tile<T, kBlockK>(vs, vb, sv.s, k0, Tk);
    __syncthreads();

    float sc[4][4];
    zero(sc);
    warp_mma<4, kD, true>(sc, qs + wr * Sh::ldd, Sh::ldd, ks + wcs * Sh::ldd,
                          Sh::ldd);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1);
        const int c = wcs + 8 * n + 2 * t + (e & 1);
        const int qi = q0 + r, kj = k0 + c;
        const bool visible =
            qi < Tq && kj < Tk &&
            (!CAUSAL || (long long)q_offset + qi >= (long long)k_offset + kj);
        sc_s[r * Sh::lds + c] = visible ? sc[n][e] * scale : kNegInf;
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
      // a row that has seen no visible key keeps m = -1e30 and adds
      // nothing (its acc and l are 0, so alpha = 1 changes nothing)
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockK / 4; ++i) {
        const float p = live ? expf(x[i] - m_new) : 0.f;
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
    warp_mma<8, kBlockK, false>(acc, ps + wr * Sh::ldp, Sh::ldp, vs + wco,
                                Sh::ldd);
  }

  if (sj == 0 && q0 + sr < Tq) {
    m_out[(long long)bh * Tq + q0 + sr] = m_run;
    l_out[(long long)bh * Tq + q0 + sr] = l_run;
  }
  store_acc(o + (long long)bh * Tq * kD, acc, q0, wr, wco, Tq);
}

// ----------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------

struct Geometry {
  int B, H, rep, Tq, Tk, q_offset, k_offset;
  Strides sq, sk, sv;
};

template <typename T, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* m, void* l, const Geometry& g, float scale,
                   cudaStream_t stream) {
  const size_t smem = block_smem<T>();
  auto kernel = ring_block_kernel<T, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.Tq + kBlockQ - 1) / kBlockQ, g.B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), g.H, g.rep, g.Tq, g.Tk, g.q_offset, g.k_offset,
      g.sq, g.sk, g.sv, scale);
  return cudaGetLastError();
}

}  // namespace

// The entry point. q [B, H, Tq, D], k and v [B, Hkv, Tk, D], each with its
// own element strides over (batch, head, sequence) and unit stride over D;
// D must be 128 and Hkv must divide H. o [B, H, Tq, D], m and l [B, H, Tq]
// are f32 and contiguous. causal: 0 or 1. dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int ring_block_attention(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int H, int Hkv, int Tq, int Tk, int D, int q_offset, int k_offset,
    long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs, int causal,
    int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      D != kD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B,        H,        H / Hkv,
                   Tq,       Tk,       q_offset,
                   k_offset, {sqb, sqh, sqs}, {skb, skh, sks},
                   {svb, svh, svs}};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, C) launch<T, C>(q, k, v, o, m, l, g, scale, s)
  if (dtype == 0) return (int)(causal ? CALL(float, true) : CALL(float, false));
  if (dtype == 1) return (int)(causal ? CALL(bf16, true) : CALL(bf16, false));
#undef CALL
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
