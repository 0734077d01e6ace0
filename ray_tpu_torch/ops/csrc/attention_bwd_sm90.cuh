// Flash attention backward for Hopper (sm_90a), bf16: the dQ kernel (3c)
// and the dK/dV kernel (3b), on the primitives of attention_fwd_sm90.cuh
// (mbarriers, TMA, wgmma, the swizzled descriptors). flash_attention.cu
// instantiates both; f32 keeps its FMA kernels (wgmma has no f32).
//
// The function, for one (batch, head), with lse from the forward and
// di = rowsum(o * do) from the caller:
//   s = (q k^T) * scale, visible where key < S and, causal, key <= query;
//   p = exp(s - lse_row), 0 where not visible; dp = do v^T;
//   ds = p * (dp - di_row); dq = ds k * scale; dk = ds^T q * scale;
//   dv = p^T do. P and dS are rounded to bf16 for their products, as the
// reference casts them to the compute dtype.
//
// Bound: operations (dQ three products, dK/dV four, of 2*D flops per
// visible pair; ~1000 flops per byte at the train shape, above the
// H100's ~295).
//
// Design. Both kernels: 3 warpgroups. Warpgroups 0 and 1 consume, 64
// rows of the block's tile each, with every product on wgmma and f32
// accumulators in registers; warpgroup 2 produces under setmaxnreg: one
// thread issues TMA loads into a ring of kStages (2) stages with a full
// and an empty mbarrier each (3 stages measured slower for dK/dV). Tiles
// are two 64-column boxes (128-byte swizzle) of the 4-D [B, H, S, D] view,
// zeros past the end. p = 2^(s * scale * log2 e - lse * log2 e) in one
// ex2.approx. Only tiles that the diagonal or the end of the sequence
// cuts are masked, and rows and columns past S are masked by bounds there.
// Each output tile is written by one block, in a fixed order: no atomics,
// a launch is deterministic. Blocks run in groups of 16 (batch, head)
// pairs, the longest causal loops first.
//   dQ (3c): block = (b, h, 128-query tile). Q and dO load once; the ring
//     carries 128-key K/V tiles (the forward's boxes and maps) up to the
//     diagonal. Per tile: S = Q K^T and dP = dO V^T (m64n128, both
//     operands from shared memory, K-major), P and dS in registers, then
//     dQ += dS K (dS from registers, K MN-major as V is in the forward's
//     P V). Each thread reads its two rows' lse and di once.
//   dK/dV (3b): block = (b, h, 128-key tile). K and V load once; the ring
//     carries tiles of 64 queries (Q and dO, 64-row boxes) from the
//     diagonal on. Each consumer computes transposed, keys as the M
//     dimension: S^T = K Q^T and dP^T = V dO^T (m64n64), P^T and dS^T in
//     registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     the register A operand and dO, Q MN-major: neither goes through
//     shared memory. A tile's lse and di are per query (per column here):
//     they are f32 rows [B, H, S] whose head rows need not be 16-byte
//     aligned (S = 2047), so TMA cannot read them; a warp of the producer
//     copies each tile's 64 values into the stage with plain loads and
//     arrives on the stage's full barrier beside the TMA thread.

#pragma once

#include "attention_fwd_sm90.cuh"

namespace {
namespace sm90 {

constexpr int kBwdQueries = 64;                      // dK/dV: queries per tile
constexpr int kSmallBoxBytes = kBwdQueries * kHalf * 2;   // one 64 x 64 box
// the producer warp that copies lse and di (dK/dV); its 32 lanes arrive
// on each full barrier beside the TMA thread
constexpr int kRowWarp = 1;

// One backward launch: shapes, the f32 rows, the bf16 outputs (dq, or dk
// and dv) at element strides (sb, sh, ss).
struct BwdProblem {
  int H, S;
  float scale;
  const float* lse;
  const float* di;
  bf16* out0;
  bf16* out1;
  long long sb, sh, ss;
};

struct alignas(1024) DqSmem {
  bf16 q[2][kRows * kHalf];
  bf16 dout[2][kRows * kHalf];
  bf16 k[kStages][2][kKeys * kHalf];
  bf16 v[kStages][2][kKeys * kHalf];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct alignas(1024) DkvSmem {
  bf16 k[2][kKeys * kHalf];
  bf16 v[2][kKeys * kHalf];
  bf16 q[kStages][2][kBwdQueries * kHalf];
  bf16 dout[kStages][2][kBwdQueries * kHalf];
  float lse[kStages][kBwdQueries];   // times log2 e
  float di[kStages][kBwdQueries];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// the block's shared memory, 1024-byte aligned (the swizzle atom)
template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<T*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// (b*H + h, first row of the tile) of block `blk` of a launch over n_t
// tiles per (batch, head) and n_bh pairs: groups of kHeadGroup pairs,
// tiles in the given order inside a group, all pairs of the group at each
// tile
__device__ __forceinline__ void block_tile(int blk, int n_t, int n_bh,
                                           bool high_first, int& bh,
                                           int& tile) {
  const int group = blk / (kHeadGroup * n_t);
  const int first = group * kHeadGroup;
  const int width = min(kHeadGroup, n_bh - first);
  const int r = blk - first * n_t;
  bh = first + r % width;
  tile = high_first ? n_t - 1 - r / width : r / width;
}

// bf16 stores of a warpgroup's 64 x 128 accumulator times mul: rows
// row_lo, row_hi (those < S) of the thread, columns 8n + 2t
__device__ __forceinline__ void store_rows(bf16* out, long long ss,
                                           const float (&acc)[64], int row_lo,
                                           int row_hi, int t, int S,
                                           float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    if (row < S) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        store_pair(out + row * ss + 8 * n + 2 * t, acc[4 * n + 2 * half] * mul,
                   acc[4 * n + 2 * half + 1] * mul);
      }
    }
  }
}

// ----------------------------------------------------------------------
// dQ (3c): block = (b, h, 128-query tile)
// ----------------------------------------------------------------------

template <bool CAUSAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const BwdProblem pr) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);

  // highest query tiles (the longest causal loops) first
  const int n_q = (pr.S + kRows - 1) / kRows;
  int bh, qt;
  block_tile(blockIdx.x, n_q, gridDim.x / n_q, true, bh, qt);
  const int q0 = qt * kRows;
  const int b = bh / pr.H, h = bh % pr.H;
  const int n_k = (pr.S + kKeys - 1) / kKeys;
  const int kt_end =
      CAUSAL ? min(n_k, (min(q0 + kRows, pr.S) - 1) / kKeys + 1) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.q_full, 4 * kBoxBytes);
      tma_load(sm.q[0], &q_map, &sm.q_full, 0, q0, h, b);
      tma_load(sm.q[1], &q_map, &sm.q_full, kHalf, q0, h, b);
      tma_load(sm.dout[0], &do_map, &sm.q_full, 0, q0, h, b);
      tma_load(sm.dout[1], &do_map, &sm.q_full, kHalf, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * kKeys;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        uint64_t* full = &sm.full[stage];
        mbar_expect_tx(full, 4 * kBoxBytes);
        tma_load(sm.k[stage][0], &k_map, full, 0, k0, h, b);
        tma_load(sm.k[stage][1], &k_map, full, kHalf, k0, h, b);
        tma_load(sm.v[stage][0], &v_map, full, 0, k0, h, b);
        tma_load(sm.v[stage][1], &v_map, full, kHalf, k0, h, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_wg = q0 + wg * 64;
    const int row_lo = r_wg + warp * 16 + g, row_hi = row_lo + 8;
    const int wg_last = r_wg + 63;
    const float c = pr.scale * kLog2e;
    // this thread's rows' lse (times log2 e) and di; 0 past the end
    const float* lse = pr.lse + (long long)bh * pr.S;
    const float* di = pr.di + (long long)bh * pr.S;
    const float l_lo = row_lo < pr.S ? lse[row_lo] * kLog2e : 0.f;
    const float l_hi = row_hi < pr.S ? lse[row_hi] * kLog2e : 0.f;
    const float d_lo = row_lo < pr.S ? di[row_lo] : 0.f;
    const float d_hi = row_hi < pr.S ? di[row_hi] : 0.f;
    // accumulator element i: row g + 8 * ((i / 2) % 2) of the warp's 16,
    // column 8 * (i / 4) + 2 * t + i % 2
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    const bf16* qa0 = sm.q[0] + wg * 64 * kHalf;
    const bf16* da0 = sm.dout[0] + wg * 64 * kHalf;
    mbar_wait(&sm.q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * kKeys;
      mbar_wait(&sm.full[stage], phase);
      // a tile whose keys all follow this warpgroup's rows adds nothing
      if (!CAUSAL || k0 <= wg_last) {
        float s[64], dp[64];
        wgmma_fence();
        score_tile<2>(s, qa0, kRows * kHalf, sm.k[stage][0], kKeys * kHalf);
        score_tile<2>(dp, da0, kRows * kHalf, sm.v[stage][0],
                      kKeys * kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);
        pin(dp);
        // mask only a tile that the end of the keys or the diagonal cuts
        const bool cut =
            k0 + kKeys > pr.S || (CAUSAL && k0 + kKeys - 1 > r_wg);
        if (cut) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = (i & 2) ? row_hi : row_lo;
            if (!(col < pr.S && causal_visible(row, col, CAUSAL))) {
              s[i] = kNegInf;
            }
          }
        }
        // dS as the A operand: keys 16kk..16kk+15 are n-tiles 2kk, 2kk+1
        uint32_t da[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool hi = i & 1;
          const float lr = hi ? l_hi : l_lo, dr = hi ? d_hi : d_lo;
          const float p0 = fast_exp2(fmaf(s[2 * i], c, -lr));
          const float p1 = fast_exp2(fmaf(s[2 * i + 1], c, -lr));
          da[i] = pack_p(p0 * (dp[2 * i] - dr), p1 * (dp[2 * i + 1] - dr));
        }
        wgmma_fence();
        value_tile(dq, da, sm.k[stage][0], kBoxBytes);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(da);
      }
      release(&sm.empty[stage], lane);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    const long long base = b * pr.sb + h * pr.sh;
    store_rows(pr.out0 + base, pr.ss, dq, row_lo, row_hi, t, pr.S, pr.scale);
  }
}

// ----------------------------------------------------------------------
// dK/dV (3b): block = (b, h, 128-key tile)
// ----------------------------------------------------------------------

template <bool CAUSAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const BwdProblem pr) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);

  // lowest key tiles (the most queries to see) first
  const int n_kt = (pr.S + kKeys - 1) / kKeys;
  int bh, kt;
  block_tile(blockIdx.x, n_kt, gridDim.x / n_kt, false, bh, kt);
  const int k0 = kt * kKeys;
  const int b = bh / pr.H, h = bh % pr.H;
  const int n_q = (pr.S + kBwdQueries - 1) / kBwdQueries;
  const int qt_begin = CAUSAL ? k0 / kBwdQueries : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);   // the TMA thread, the row warp
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pwarp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.kv_full, 4 * kBoxBytes);
      tma_load(sm.k[0], &k_map, &sm.kv_full, 0, k0, h, b);
      tma_load(sm.k[1], &k_map, &sm.kv_full, kHalf, k0, h, b);
      tma_load(sm.v[0], &v_map, &sm.kv_full, 0, k0, h, b);
      tma_load(sm.v[1], &v_map, &sm.kv_full, kHalf, k0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_q; ++qt) {
        const int q0 = qt * kBwdQueries;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        uint64_t* full = &sm.full[stage];
        mbar_expect_tx(full, 4 * kSmallBoxBytes);
        tma_load(sm.q[stage][0], &q_map, full, 0, q0, h, b);
        tma_load(sm.q[stage][1], &q_map, full, kHalf, q0, h, b);
        tma_load(sm.dout[stage][0], &do_map, full, 0, q0, h, b);
        tma_load(sm.dout[stage][1], &do_map, full, kHalf, q0, h, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (pwarp == kRowWarp) {
      const float* lse = pr.lse + (long long)bh * pr.S;
      const float* di = pr.di + (long long)bh * pr.S;
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_q; ++qt) {
        const int q0 = qt * kBwdQueries;
        mbar_wait(&sm.empty[stage], phase ^ 1);
#pragma unroll
        for (int j = lane; j < kBwdQueries; j += 32) {
          const int q = q0 + j;
          sm.lse[stage][j] = q < pr.S ? lse[q] * kLog2e : 0.f;
          sm.di[stage][j] = q < pr.S ? di[q] : 0.f;
        }
        mbar_arrive(&sm.full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int key_wg = k0 + wg * 64;   // this warpgroup's first key
    const int key_lo = key_wg + warp * 16 + g, key_hi = key_lo + 8;
    const float c = pr.scale * kLog2e;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    const bf16* ka0 = sm.k[0] + wg * 64 * kHalf;
    const bf16* va0 = sm.v[0] + wg * 64 * kHalf;
    mbar_wait(&sm.kv_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt_begin; qt < n_q; ++qt) {
      const int q0 = qt * kBwdQueries;
      mbar_wait(&sm.full[stage], phase);
      // a tile whose queries all precede this warpgroup's keys adds nothing
      if (!CAUSAL || q0 + kBwdQueries - 1 >= key_wg) {
        // S^T and dP^T: rows are keys, columns queries
        float st[32], dpt[32];
        wgmma_fence();
        score_tile<2>(st, ka0, kKeys * kHalf, sm.q[stage][0],
                      kBwdQueries * kHalf);
        score_tile<2>(dpt, va0, kKeys * kHalf, sm.dout[stage][0],
                      kBwdQueries * kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        pin(st);
        pin(dpt);
        const bool cut = q0 + kBwdQueries > pr.S ||
                         (CAUSAL && q0 < key_wg + 63);
        if (cut) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = (i & 2) ? key_hi : key_lo;
            if (!(col < pr.S && causal_visible(col, row, CAUSAL))) {
              st[i] = kNegInf;
            }
          }
        }
        const float* lse = sm.lse[stage];
        const float* di = sm.di[stage];
        // P^T (f32 in st) and as the A operand of dV += P^T dO: queries
        // 16kk..16kk+15 are n-tiles 2kk, 2kk+1
        uint32_t pa[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l =
              *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
          st[4 * n] = fast_exp2(fmaf(st[4 * n], c, -l.x));
          st[4 * n + 1] = fast_exp2(fmaf(st[4 * n + 1], c, -l.y));
          st[4 * n + 2] = fast_exp2(fmaf(st[4 * n + 2], c, -l.x));
          st[4 * n + 3] = fast_exp2(fmaf(st[4 * n + 3], c, -l.y));
          pa[2 * n] = pack_p(st[4 * n], st[4 * n + 1]);
          pa[2 * n + 1] = pack_p(st[4 * n + 2], st[4 * n + 3]);
        }
        wgmma_fence();
        value_tile(dv, pa, sm.dout[stage][0], kSmallBoxBytes);
        wgmma_commit();
        // dS^T while dV's product runs
        uint32_t dsa[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 d =
              *reinterpret_cast<const float2*>(di + 8 * n + 2 * t);
          dsa[2 * n] = pack_p(st[4 * n] * (dpt[4 * n] - d.x),
                              st[4 * n + 1] * (dpt[4 * n + 1] - d.y));
          dsa[2 * n + 1] = pack_p(st[4 * n + 2] * (dpt[4 * n + 2] - d.x),
                                  st[4 * n + 3] * (dpt[4 * n + 3] - d.y));
        }
        wgmma_fence();
        value_tile(dk, dsa, sm.q[stage][0], kSmallBoxBytes);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dv);
        pin(dk);
        pin(pa);
        pin(dsa);
      }
      release(&sm.empty[stage], lane);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    const long long base = b * pr.sb + h * pr.sh;
    store_rows(pr.out0 + base, pr.ss, dk, key_lo, key_hi, t, pr.S, pr.scale);
    store_rows(pr.out1 + base, pr.ss, dv, key_lo, key_hi, t, pr.S, 1.f);
  }
}

// ----------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------

// maps for q, k, v, do [B, H, S, 128] (one set of byte strides), then one
// launch of B * H * tiles blocks. DKV: the dK/dV kernel (Q and dO in
// 64-row boxes, 128-key blocks), else dQ (all boxes 128 rows).
template <bool DKV, bool CAUSAL>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               int B, const long long (&st)[3], const BwdProblem& pr,
               cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  const int qrows = DKV ? kBwdQueries : kRows;
  int rc = encode_map(&q_map, q, B, pr.H, pr.S, st[0], st[1], st[2], qrows);
  if (rc == 0) {
    rc = encode_map(&do_map, dout, B, pr.H, pr.S, st[0], st[1], st[2], qrows);
  }
  if (rc == 0) {
    rc = encode_map(&k_map, k, B, pr.H, pr.S, st[0], st[1], st[2], kKeys);
  }
  if (rc == 0) {
    rc = encode_map(&v_map, v, B, pr.H, pr.S, st[0], st[1], st[2], kKeys);
  }
  if (rc != 0) return rc;
  auto kernel = DKV ? attention_bwd_dkv_kernel<CAUSAL>
                    : attention_bwd_dq_kernel<CAUSAL>;
  const size_t smem = (DKV ? sizeof(DkvSmem) : sizeof(DqSmem)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = DKV ? kKeys : kRows;
  const long long blocks = (long long)B * pr.H * ((pr.S + tile - 1) / tile);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, pr);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace
