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
// D; lse and di: [B, H, S] f32 contiguous. D must be this library's width
// (kHeadDim: RAY_TPU_HEAD_DIM, 128 or 256, which ops/_build.py sets for
// each width's library). S is any length: the ragged
// last tile is masked by bounds, nothing is padded.
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
//   forward: block = (b, h, query tile); loop over key tiles up to the
//            diagonal; online softmax (m, l) per row; O in registers.
//   dQ:      block = (b, h, query tile); loop over key tiles up to the
//            diagonal; dQ in registers.
//   dK/dV:   block = (b, h, key tile); loop over query tiles from the
//            diagonal on; dK and dV in registers.
// Every output element is written by exactly one block and summed in a
// fixed order: no atomics, so a launch is deterministic and the forward
// recomputed under activation checkpointing is bit-identical.
// bf16 (the _bf16 entries) runs on wgmma + TMA at both widths:
//   - the forward: the template of
//     attention_fwd_sm90.cuh (128-query blocks, 128-key tiles, 64 at
//     D = 256, P in registers) with the epilogue FlashFwdOut below, which
//     writes o / l in bf16 and lse = m + log(l);
//   - the backward: the kernels of attention_bwd_sm90.cuh. At D = 128,
//     128-query dQ blocks over 128-key tiles and 128-key dK/dV blocks over
//     64-query tiles, computed transposed so that P^T and dS^T stay in
//     registers; at D = 256 (namespace d256 there), dQ over 64-key tiles
//     with K and V in slots of their own, and 64-key dK/dV blocks whose two
//     consumer warpgroups own dV and dK, the first handing P^T to the
//     second through shared memory.
// f32 (all three kernels) stages 64-row tiles global -> shared memory with
// 16-byte loads (the loop's tiles 32 rows at D = 256); 8 warps each
// compute a 16-row slice of every product as f32 FMAs (mma_tiles.cuh, no
// TF32). P and dS go through shared memory.

#include "attention_bwd_sm90.cuh"
#include "mma_tiles.cuh"

namespace {

// f32 values of row vector `src` (length S, rows >= S read as 0) for the
// tile's ROWS rows
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int query, int key, int S,
                                        bool causal) {
  return query < S && key < S && causal_visible(query, key, causal);
}

// ----------------------------------------------------------------------
// forward (3a), f32: block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int S, long long sb,
                 long long sh, long long ss, float scale) {
  using Sh = Tiles<T, D>;
  constexpr int kKeys = Sh::kLoop;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + Sh::own;
  T* vs = ks + Sh::loop;
  T* ps = vs + Sh::loop;
  float* sc_s = reinterpret_cast<float*>(ps + Sh::ptile);
  float* row_s = sc_s + kBlockQ * Sh::lds;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // this warp's 16 rows of every tile
  const int wcs = (warp >> 2) * (kKeys / 2);   // its score columns
  const int wco = (warp >> 2) * (D / 2);       // its output columns
  const int sr = tid >> 2, sj = tid & 3;   // softmax: 4 threads per row

  load_tile<T, D, kBlockQ>(qs, q + base, ss, q0, S);

  float m_run = kNegInf, l_run = 0.f;   // row sr's stats (all 4 threads)
  float acc[Sh::kOutNT][4];
  zero(acc);
  const int n_k = (S + kKeys - 1) / kKeys;
  const int kt_end = CAUSAL ? min(n_k, (q0 + kBlockQ - 1) / kKeys + 1) : n_k;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();   // the last tile's readers are done
    load_tile<T, D, kKeys>(ks, k + base, ss, k0, S);
    load_tile<T, D, kKeys>(vs, v + base, ss, k0, S);
    __syncthreads();

    float sc[Sh::kScoreNT][4];
    zero(sc);
    warp_mma<Sh::kScoreNT, D, true, true>(sc, qs + wr * Sh::ldd, Sh::ldd,
                                          ks + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < Sh::kScoreNT; ++n) {
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
      float x[kKeys / 4];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
        x[i] = sc_s[sr * Sh::lds + sj + 4 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
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
    for (int n = 0; n < Sh::kOutNT; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }
    warp_mma<Sh::kOutNT, kKeys, true, false>(acc, ps + wr * Sh::ldp,
                                             Sh::ldp, vs + wco, Sh::ldd);
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
// backward dQ (3c), f32: block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dq_smem() {
  using Sh = Tiles<T, D>;
  return (2 * Sh::own + 2 * Sh::loop + Sh::ptile) * sizeof(T) +
         2 * kBlockQ * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int S, long long sb, long long sh, long long ss,
                    float scale) {
  using Sh = Tiles<T, D>;
  constexpr int kKeys = Sh::kLoop;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + Sh::own;
  T* ks = dos + Sh::own;
  T* vs = ks + Sh::loop;
  T* dss = vs + Sh::loop;
  float* lse_s = reinterpret_cast<float*>(dss + Sh::ptile);
  float* di_s = lse_s + kBlockQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;
  const int wcs = (warp >> 2) * (kKeys / 2);
  const int wco = (warp >> 2) * (D / 2);

  load_tile<T, D, kBlockQ>(qs, q + base, ss, q0, S);
  load_tile<T, D, kBlockQ>(dos, dout + base, ss, q0, S);
  load_rows<kBlockQ>(lse_s, lse + (long long)bh * S, q0, S);
  load_rows<kBlockQ>(di_s, di + (long long)bh * S, q0, S);

  float acc[Sh::kOutNT][4];
  zero(acc);
  const int n_k = (S + kKeys - 1) / kKeys;
  const int kt_end = CAUSAL ? min(n_k, (q0 + kBlockQ - 1) / kKeys + 1) : n_k;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();
    load_tile<T, D, kKeys>(ks, k + base, ss, k0, S);
    load_tile<T, D, kKeys>(vs, v + base, ss, k0, S);
    __syncthreads();

    float sc[Sh::kScoreNT][4], dp[Sh::kScoreNT][4];
    zero(sc);
    zero(dp);
    warp_mma<Sh::kScoreNT, D, true, true>(sc, qs + wr * Sh::ldd, Sh::ldd,
                                          ks + wcs * Sh::ldd, Sh::ldd);
    warp_mma<Sh::kScoreNT, D, true, true>(dp, dos + wr * Sh::ldd, Sh::ldd,
                                          vs + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < Sh::kScoreNT; ++n) {
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
    warp_mma<Sh::kOutNT, kKeys, true, false>(acc, dss + wr * Sh::ldp,
                                             Sh::ldp, ks + wco, Sh::ldd);
  }
  store_acc(dq + base, ss, acc, q0, wr, wco, S, scale, scale);
}

// ----------------------------------------------------------------------
// backward dK/dV (3b), f32: block = (64-key tile, b*H + h)
// ----------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dkv_smem() {
  using Sh = Tiles<T, D>;
  return (2 * Sh::own + 2 * Sh::loop + 2 * Sh::ptile) * sizeof(T) +
         2 * Sh::kLoop * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, long long sb,
                     long long sh, long long ss, float scale) {
  using Sh = Tiles<T, D>;
  constexpr int kQueries = Sh::kLoop;   // queries a loop tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + Sh::own;
  T* qs = vs + Sh::own;
  T* dos = qs + Sh::loop;
  T* pts = dos + Sh::loop;    // P^T  [key][query]
  T* dsts = pts + Sh::ptile;  // dS^T [key][query]
  float* lse_s = reinterpret_cast<float*>(dsts + Sh::ptile);
  float* di_s = lse_s + kQueries;

  const int kt = blockIdx.x;   // low key tiles see the most queries
  const int bh = blockIdx.y;
  const long long base = (bh / H) * sb + (bh % H) * sh;
  const int k0 = kt * kBlockK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // 16 key rows
  const int wcs = (warp >> 2) * (kQueries / 2);   // query columns of P^T
  const int wco = (warp >> 2) * (D / 2);   // head_dim columns of dK, dV

  load_tile<T, D, kBlockK>(ks, k + base, ss, k0, S);
  load_tile<T, D, kBlockK>(vs, v + base, ss, k0, S);

  float acc_dk[Sh::kOutNT][4], acc_dv[Sh::kOutNT][4];
  zero(acc_dk);
  zero(acc_dv);
  const int n_q = (S + kQueries - 1) / kQueries;
  const int qt_begin = CAUSAL ? k0 / kQueries : 0;

  for (int qt = qt_begin; qt < n_q; ++qt) {
    const int q0 = qt * kQueries;
    __syncthreads();
    load_tile<T, D, kQueries>(qs, q + base, ss, q0, S);
    load_tile<T, D, kQueries>(dos, dout + base, ss, q0, S);
    load_rows<kQueries>(lse_s, lse + (long long)bh * S, q0, S);
    load_rows<kQueries>(di_s, di + (long long)bh * S, q0, S);
    __syncthreads();

    float st[Sh::kScoreNT][4], dpt[Sh::kScoreNT][4];
    zero(st);
    zero(dpt);
    warp_mma<Sh::kScoreNT, D, true, true>(st, ks + wr * Sh::ldd, Sh::ldd,
                                          qs + wcs * Sh::ldd, Sh::ldd);
    warp_mma<Sh::kScoreNT, D, true, true>(dpt, vs + wr * Sh::ldd, Sh::ldd,
                                          dos + wcs * Sh::ldd, Sh::ldd);
#pragma unroll
    for (int n = 0; n < Sh::kScoreNT; ++n) {
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
    warp_mma<Sh::kOutNT, kQueries, true, false>(
        acc_dv, pts + wr * Sh::ldp, Sh::ldp, dos + wco, Sh::ldd);
    warp_mma<Sh::kOutNT, kQueries, true, false>(
        acc_dk, dsts + wr * Sh::ldp, Sh::ldp, qs + wco, Sh::ldd);
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

// bf16 runs the sm90 kernels at every width flash takes: the forward's
// template, and the backward's kernels for head_dim 128 and 256
static_assert(RAY_TPU_SM90_FORWARD && kHeadDim % 64 == 0,
              "flash's bf16 forward is the sm90 template");
static_assert(RAY_TPU_SM90_BACKWARD && (kHeadDim == 128 || kHeadDim == 256),
              "flash's bf16 backward is the sm90 kernels at 128 and 256");

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
  const size_t smem = fwd_smem<T, kHeadDim>();
  auto kernel = flash_fwd_kernel<T, kHeadDim, CAUSAL>;
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
  const size_t smem = dq_smem<T, kHeadDim>();
  auto kernel = flash_bwd_dq_kernel<T, kHeadDim, CAUSAL>;
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
  const size_t smem = dkv_smem<T, kHeadDim>();
  auto kernel = flash_bwd_dkv_kernel<T, kHeadDim, CAUSAL>;
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
  if (B <= 0 || H <= 0 || S <= 0 || D != kHeadDim) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

// forward (3a), bf16: the epilogue of the sm90 template. o / l in bf16 at
// element strides (sb, sh, ss); lse [B, H, S] f32 contiguous.
struct FlashFwdOut {
  bf16* o;
  float* lse;
  int H, S;
  long long sb, sh, ss;

  __device__ __forceinline__ float out_scale(float l) const {
    return 1.f / l;
  }
  __device__ __forceinline__ void row_stats(int b, int h, int row, float m,
                                            float l) const {
    lse[((long long)b * H + h) * S + row] = m + logf(l);
  }
  __device__ __forceinline__ void store(int b, int h, int row, int col,
                                        float x0, float x1) const {
    store_pair(o + b * sb + h * sh + row * ss + col, x0, x1);
  }
};

}  // namespace

// The entry points. q, k, v, o/do/dq/dk/dv share the strides
// (sb, sh, ss) over (batch, head, seq); head_dim D must be this library's
// (kHeadDim); lse and di are [B, H, S] f32 contiguous. causal: 0 or 1. The
// f32 entries take the strides in elements and a dtype code that must be
// 0 (float32); the _bf16 entries take them in BYTES (each a positive
// multiple of 16, bases 16-byte aligned: what TMA takes) and run the
// sm90 kernels. Each returns a cudaError_t, the _bf16 entries also
// sm90::kEncodeError + the encoder's CUresult when a TMA map is refused.

// the forward in f32 (dtype 0); bf16 takes flash_attention_fwd_bf16
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int S, int D, long long sb,
                                   long long sh, long long ss, int causal,
                                   int dtype, int device, void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(causal ? launch_fwd<float, true>(q, k, v, o, lse, g, scale, s)
                      : launch_fwd<float, false>(q, k, v, o, lse, g, scale,
                                                 s));
}

// the forward in bf16, on the sm90 template
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int S, int D,
                                        long long sb, long long sh,
                                        long long ss, int causal, int device,
                                        void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  const sm90::Problem pr{H, 1, S, S, 0, 0, 1.0f / sqrtf((float)D)};
  const int elt = (int)sizeof(bf16);
  const FlashFwdOut epi{static_cast<bf16*>(o), static_cast<float*>(lse),
                        H, S, sb / elt, sh / elt, ss / elt};
  const long long st[3] = {sb, sh, ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? sm90::launch<true, kHeadDim>(q, k, v, B, st, st, st, pr,
                                               epi, s)
                : sm90::launch<false, kHeadDim>(q, k, v, B, st, st, st, pr,
                                                epi, s);
}

// backward dQ in f32 (dtype 0); bf16 takes flash_attention_bwd_dq_bf16
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int S, int D,
                                      long long sb, long long sh,
                                      long long ss, int causal, int dtype,
                                      int device, void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(causal ? launch_dq<float, true>(q, k, v, dout, lse, di, dq, g,
                                               scale, s)
                      : launch_dq<float, false>(q, k, v, dout, lse, di, dq,
                                                g, scale, s));
}

// the bf16 backward's problem: element strides for the outputs' stores
static sm90::BwdProblem bwd_problem(int H, int S, int D, const void* lse,
                                    const void* di, void* out0, void* out1,
                                    long long sb, long long sh,
                                    long long ss) {
  const int elt = (int)sizeof(bf16);
  return sm90::BwdProblem{H, S, 1.0f / sqrtf((float)D),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(di),
                          static_cast<bf16*>(out0), static_cast<bf16*>(out1),
                          sb / elt, sh / elt, ss / elt};
}

// backward dQ in bf16
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* di,
                                           void* dq, int B, int H, int S,
                                           int D, long long sb, long long sh,
                                           long long ss, int causal,
                                           int device, void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::BwdProblem pr =
      bwd_problem(H, S, D, lse, di, dq, nullptr, sb, sh, ss);
  const long long st[3] = {sb, sh, ss};
  return causal
             ? sm90::launch_bwd<kHeadDim, false, true>(q, k, v, dout, B, st,
                                                       pr, s)
             : sm90::launch_bwd<kHeadDim, false, false>(q, k, v, dout, B, st,
                                                        pr, s);
}

// backward dK/dV in f32 (dtype 0); bf16 takes flash_attention_bwd_dkv_bf16
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, S, sb, sh, ss};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(causal ? launch_dkv<float, true>(q, k, v, dout, lse, di, dk,
                                                dv, g, scale, s)
                      : launch_dkv<float, false>(q, k, v, dout, lse, di, dk,
                                                 dv, g, scale, s));
}

// backward dK/dV in bf16
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* di,
                                            void* dk, void* dv, int B, int H,
                                            int S, int D, long long sb,
                                            long long sh, long long ss,
                                            int causal, int device,
                                            void* stream) {
  cudaError_t err = check(B, H, S, D, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::BwdProblem pr =
      bwd_problem(H, S, D, lse, di, dk, dv, sb, sh, ss);
  const long long st[3] = {sb, sh, ss};
  return causal
             ? sm90::launch_bwd<kHeadDim, true, true>(q, k, v, dout, B, st,
                                                      pr, s)
             : sm90::launch_bwd<kHeadDim, true, false>(q, k, v, dout, B, st,
                                                       pr, s);
}

extern "C" const char* error_string(int code) {
  const char* tma = sm90::encode_error_string(code);
  return tma ? tma : cudaGetErrorString(static_cast<cudaError_t>(code));
}
