// Flash attention backward for Hopper (sm_90a), bf16: the dQ kernel (3c)
// and the dK/dV kernel (3b), on the primitives of attention_fwd_sm90.cuh
// (mbarriers, TMA, wgmma, the swizzled descriptors), in two designs: one
// for head_dim 128 and one for 256 (namespace d256), whose rows take
// twice the registers and shared memory. flash_attention.cu instantiates
// its width's pair (launch_bwd); f32 keeps its FMA kernels (wgmma has no
// f32).
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
// Design at 128. Both kernels: 3 warpgroups. Warpgroups 0 and 1 consume, 64
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
//
// Design at 256 (namespace d256): the same warpgroups, producer, boxes,
// masks, block order and fixed-order stores, with tiles cut to the
// budgets (240 registers a consumer thread, 227 KB of shared memory):
//   dQ (3c): dQ of 64 rows x 256 columns is 128 registers a thread, so
//     K/V tiles of 64 keys (S and dP m64n64, 32 registers each; dS 16).
//     Q and dO take 128 KB, so two stages of K and V (128 KB) do not fit:
//     K and V tiles pass in turn through a ring of three 32 KB slots (224
//     KB in all); V's slot frees once dP is done, K's after dQ += dS K.
//   dK/dV (3b): dK and dV of 64 keys x 256 columns would take 256
//     registers a thread, so a block holds 64 keys and warpgroup 0 owns
//     dV, warpgroup 1 dK (128 registers each). Per 64-query tile
//     warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1
//     dP^T = V dO^T, dS^T and dK += dS^T Q. P^T goes from 0 to 1 through
//     shared memory (f32, 16 KB, two mbarriers of 128 arrivals), so each
//     product runs once and dS^T is formed from P^T in f32, as at 128.
//     Measured first with each warpgroup owning a column half of both and
//     swapping P^T and dS^T: 17% slower (PERF.md, section 6).

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
// head_dim 256: the same two kernels redesigned for the register and
// shared memory budgets of a 256-wide row (the kernels above take 128)
// ----------------------------------------------------------------------

namespace d256 {

constexpr int kBoxes = 4;     // 64-column boxes a row
constexpr int kKeys = 64;     // dQ: keys a K or V tile; dK/dV: keys a block
constexpr int kSlots = 3;     // dQ's ring: K and V tiles each in a slot
constexpr int kTileBytes = kBoxes * kSmallBoxBytes;   // one 64-row tile

// dQ: Q and dO of the 128-query block (64 KB each) and three 32 KB slots
// through which K and V tiles pass in turn (tile kt's K is load 2kt, its
// V load 2kt + 1): two 64-key stages of K and V would need 256 KB
struct alignas(1024) DqSmem {
  bf16 q[kBoxes][kRows * kHalf];
  bf16 dout[kBoxes][kRows * kHalf];
  bf16 kv[kSlots][kBoxes][kKeys * kHalf];
  uint64_t q_full;
  uint64_t full[kSlots];
  uint64_t empty[kSlots];
};

// dK/dV: K and V of the 64-key block, kStages stages of a 64-query Q and
// dO tile, lse and di per stage, and P^T handed from warpgroup 0 to 1: f32
// in the accumulator layout at [value][thread], so a thread reads what
// the thread of its index in the other warpgroup wrote; pt_full and
// pt_empty count the 128 threads of the writer and of the reader
struct alignas(1024) DkvSmem {
  bf16 k[kBoxes][kKeys * kHalf];
  bf16 v[kBoxes][kKeys * kHalf];
  bf16 q[kStages][kBoxes][kBwdQueries * kHalf];
  bf16 dout[kStages][kBoxes][kBwdQueries * kHalf];
  float pt[32][128];
  float lse[kStages][kBwdQueries];   // times log2 e
  float di[kStages][kBwdQueries];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t pt_full;
  uint64_t pt_empty;
};

// the dynamic shared memory a block asks for: the struct and its alignment
constexpr int kMaxSmem = 232448;   // 227 KB, a block's most on sm_90
static_assert(sizeof(DqSmem) + 1024 <= kMaxSmem, "dQ shared memory");
static_assert(sizeof(DkvSmem) + 1024 <= kMaxSmem, "dK/dV shared memory");

// (slot, phase) of load i of the dQ ring
__device__ __forceinline__ void ring_slot(int i, int& slot, uint32_t& phase) {
  slot = i % kSlots;
  phase = (i / kSlots) & 1;
}

// dQ (3c) at 256: block = (b, h, 128-query tile); warpgroup wg owns 64 of
// its rows and all 256 columns of their dQ (two m64n128 accumulators, 128
// registers a thread); per 64-key tile S = Q K^T and dP = dO V^T (m64n64,
// 32 registers each), dS (16), then dQ += dS K over two column halves.
// V's slot is released once dP is read, K's after dQ's product.
template <bool CAUSAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const BwdProblem pr) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);

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
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.q_full, 2 * kBoxes * kBoxBytes);
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
        tma_load(sm.q[j], &q_map, &sm.q_full, j * kHalf, q0, h, b);
        tma_load(sm.dout[j], &do_map, &sm.q_full, j * kHalf, q0, h, b);
      }
      for (int i = 0; i < 2 * kt_end; ++i) {
        int slot;
        uint32_t phase;
        ring_slot(i, slot, phase);
        mbar_wait(&sm.empty[slot], phase ^ 1);
        uint64_t* full = &sm.full[slot];
        const CUtensorMap* map = (i & 1) ? &v_map : &k_map;
        mbar_expect_tx(full, kTileBytes);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          tma_load(sm.kv[slot][j], map, full, j * kHalf, (i / 2) * kKeys, h,
                   b);
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
    const float* lse = pr.lse + (long long)bh * pr.S;
    const float* di = pr.di + (long long)bh * pr.S;
    const float lse_lo = row_lo < pr.S ? lse[row_lo] * kLog2e : 0.f;
    const float lse_hi = row_hi < pr.S ? lse[row_hi] * kLog2e : 0.f;
    const float di_lo = row_lo < pr.S ? di[row_lo] : 0.f;
    const float di_hi = row_hi < pr.S ? di[row_hi] : 0.f;
    // dq[ch]: columns 128 ch .. 128 ch + 127, the accumulator layout of
    // m64n128 (element i: row g + 8 * ((i / 2) % 2) of the warp's 16,
    // column 8 * (i / 4) + 2 * t + i % 2)
    float dq[2][64];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int i = 0; i < 64; ++i) dq[ch][i] = 0.f;
    }
    const bf16* qa = sm.q[0] + wg * 64 * kHalf;
    const bf16* doa = sm.dout[0] + wg * 64 * kHalf;
    mbar_wait(&sm.q_full, 0);

    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * kKeys;
      int ks, vs;
      uint32_t kph, vph;
      ring_slot(2 * kt, ks, kph);
      ring_slot(2 * kt + 1, vs, vph);
      mbar_wait(&sm.full[ks], kph);
      if (!CAUSAL || k0 <= wg_last) {
        float s[32], dp[32];
        wgmma_fence();
        score_tile<kBoxes>(s, qa, kRows * kHalf, sm.kv[ks][0], kKeys * kHalf);
        wgmma_commit();
        // V's tile may still be landing while S runs
        mbar_wait(&sm.full[vs], vph);
        score_tile<kBoxes>(dp, doa, kRows * kHalf, sm.kv[vs][0],
                           kKeys * kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);
        pin(dp);
        release(&sm.empty[vs], lane);
        const bool cut =
            k0 + kKeys > pr.S || (CAUSAL && k0 + kKeys - 1 > r_wg);
        if (cut) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int query = (i & 2) ? row_hi : row_lo;
            if (!(key < pr.S && causal_visible(query, key, CAUSAL))) {
              s[i] = kNegInf;
            }
          }
        }
        // dS as the A operand, keys 16kk..16kk+15 in dsa[4kk..4kk+3]
        uint32_t dsa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float l = (i & 1) ? lse_hi : lse_lo;
          const float d = (i & 1) ? di_hi : di_lo;
          const float p0 = fast_exp2(fmaf(s[2 * i], c, -l));
          const float p1 = fast_exp2(fmaf(s[2 * i + 1], c, -l));
          dsa[i] = pack_p(p0 * (dp[2 * i] - d), p1 * (dp[2 * i + 1] - d));
        }
        wgmma_fence();
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          value_tile(dq[ch], dsa, sm.kv[ks][2 * ch], kSmallBoxBytes);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq[0]);
        pin(dq[1]);
        pin(dsa);
      } else {
        mbar_wait(&sm.full[vs], vph);
        release(&sm.empty[vs], lane);
      }
      release(&sm.empty[ks], lane);
    }
    const long long base = b * pr.sb + h * pr.sh;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      store_rows(pr.out0 + base + 128 * ch, pr.ss, dq[ch], row_lo, row_hi, t,
                 pr.S, pr.scale);
    }
  }
}

// dK/dV (3b) at 256: block = (b, h, 64-key tile). dK and dV of 64 keys
// over 256 columns would take 256 accumulator registers a thread, so each
// consumer warpgroup owns one of them, over all 256 columns (two m64n128
// accumulators, 128 registers). Per 64-query tile warpgroup 0 computes
// S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T =
// P^T (dP^T - di) and dK += dS^T Q, P^T and dS^T as the register A
// operand. Warpgroup 0 hands P^T to warpgroup 1 through shared memory;
// otherwise the two run free, each on half of the tile's flops.
template <bool CAUSAL>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const BwdProblem pr) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);

  const int n_kt = (pr.S + kKeys - 1) / kKeys;
  int bh, kt;
  block_tile(blockIdx.x, n_kt, gridDim.x / n_kt, false, bh, kt);
  const int k0 = kt * kKeys;
  const int b = bh / pr.H, h = bh % pr.H;
  const int n_q = (pr.S + kBwdQueries - 1) / kBwdQueries;
  // causal: the first tile holds the block's first key as a query, so
  // every tile from it on has a visible pair
  const int qt_begin = CAUSAL ? k0 / kBwdQueries : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    mbar_init(&sm.pt_full, 128);
    mbar_init(&sm.pt_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pwarp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
        tma_load(sm.k[j], &k_map, &sm.kv_full, j * kHalf, k0, h, b);
        tma_load(sm.v[j], &v_map, &sm.kv_full, j * kHalf, k0, h, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_q; ++qt) {
        const int q0 = qt * kBwdQueries;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        uint64_t* full = &sm.full[stage];
        mbar_expect_tx(full, 2 * kTileBytes);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          tma_load(sm.q[stage][j], &q_map, full, j * kHalf, q0, h, b);
          tma_load(sm.dout[stage][j], &do_map, full, j * kHalf, q0, h, b);
        }
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
    const int w = threadIdx.x % 128;   // the thread's column of pt
    const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
    const float c = pr.scale * kLog2e;
    // dV (warpgroup 0) or dK (1): acc[ch] holds columns 128 ch + 8 * (i /
    // 4) + 2 * t + i % 2
    float acc[2][64];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[ch][i] = 0.f;
    }
    // S^T = K Q^T (warpgroup 0), dP^T = V dO^T (1); then dV += P^T dO (0),
    // dK += dS^T Q (1)
    const bf16* rows_a = wg == 0 ? sm.k[0] : sm.v[0];
    mbar_wait(&sm.kv_full, 0);

    int stage = 0;
    uint32_t phase = 0, pt_phase = 0;
    for (int qt = qt_begin; qt < n_q; ++qt) {
      const int q0 = qt * kBwdQueries;
      mbar_wait(&sm.full[stage], phase);
      // rows are keys, columns queries
      float x[32];
      wgmma_fence();
      score_tile<kBoxes>(x, rows_a, kKeys * kHalf,
                         wg == 0 ? sm.q[stage][0] : sm.dout[stage][0],
                         kBwdQueries * kHalf);
      wgmma_commit();
      wgmma_wait<0>();
      pin(x);
      // P^T (0) or dS^T (1) as the A operand: queries 16kk..16kk+15 in
      // a[4kk..4kk+3]
      uint32_t a[16];
      if (wg == 0) {
        const bool cut = q0 + kBwdQueries > pr.S ||
                         (CAUSAL && q0 < k0 + kKeys - 1);
        if (cut) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int query = q0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int key = (i & 2) ? key_hi : key_lo;
            if (!(query < pr.S && causal_visible(query, key, CAUSAL))) {
              x[i] = kNegInf;
            }
          }
        }
        const float* lse_t = sm.lse[stage];
        // warpgroup 1 has read the last tile's P^T
        mbar_wait(&sm.pt_empty, pt_phase ^ 1);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(
              lse_t + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[4 * n + e] =
                fast_exp2(fmaf(x[4 * n + e], c, (e & 1) ? -l2.y : -l2.x));
            sm.pt[4 * n + e][w] = x[4 * n + e];
          }
          a[2 * n] = pack_p(x[4 * n], x[4 * n + 1]);
          a[2 * n + 1] = pack_p(x[4 * n + 2], x[4 * n + 3]);
        }
        mbar_arrive(&sm.pt_full);
      } else {
        const float* di_t = sm.di[stage];
        mbar_wait(&sm.pt_full, pt_phase);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              di_t + 8 * n + 2 * t);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = sm.pt[4 * n + e][w];
            ds[e] = pe * (x[4 * n + e] - ((e & 1) ? d2.y : d2.x));
          }
          a[2 * n] = pack_p(ds[0], ds[1]);
          a[2 * n + 1] = pack_p(ds[2], ds[3]);
        }
        mbar_arrive(&sm.pt_empty);
      }
      pt_phase ^= 1;
      // B: dO (warpgroup 0) or Q (1), column half ch in boxes 2ch, 2ch + 1
      const bf16* b_tile = wg == 0 ? sm.dout[stage][0] : sm.q[stage][0];
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        value_tile(acc[ch], a, b_tile + 2 * ch * kBwdQueries * kHalf,
                   kSmallBoxBytes);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);
      pin(a);
      release(&sm.empty[stage], lane);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // warpgroup 0 stores dV, 1 stores dK (times scale)
    bf16* out = (wg == 0 ? pr.out1 : pr.out0) + b * pr.sb + h * pr.sh;
    const float mul = wg == 0 ? 1.f : pr.scale;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      store_rows(out + 128 * ch, pr.ss, acc[ch], key_lo, key_hi, t, pr.S,
                 mul);
    }
  }
}

}  // namespace d256

// ----------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------

// maps for q, k, v, do [B, H, S, D] (one set of byte strides), then one
// launch of B * H * tiles blocks of the kernel for head_dim D (128 or
// 256). DKV: the dK/dV kernel (Q and dO in 64-row boxes; blocks of 128
// keys, 64 at 256), else dQ (Q and dO in 128-row boxes; K and V tiles of
// 128 keys, 64 at 256).
template <int D, bool DKV, bool CAUSAL>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               int B, const long long (&st)[3], const BwdProblem& pr,
               cudaStream_t stream) {
  static_assert(D == 128 || D == 256, "the sm90 backward: head_dim 128, 256");
  constexpr bool kWide = D == 256;
  constexpr int qrows = DKV ? kBwdQueries : kRows;
  constexpr int krows = kWide ? d256::kKeys : kKeys;
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = encode_map(&q_map, q, B, pr.H, pr.S, st[0], st[1], st[2], qrows, D);
  if (rc == 0) {
    rc = encode_map(&do_map, dout, B, pr.H, pr.S, st[0], st[1], st[2], qrows,
                    D);
  }
  if (rc == 0) {
    rc = encode_map(&k_map, k, B, pr.H, pr.S, st[0], st[1], st[2], krows, D);
  }
  if (rc == 0) {
    rc = encode_map(&v_map, v, B, pr.H, pr.S, st[0], st[1], st[2], krows, D);
  }
  if (rc != 0) return rc;
  const int tile = DKV ? krows : kRows;
  const long long blocks = (long long)B * pr.H * ((pr.S + tile - 1) / tile);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto kernel, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
        q_map, k_map, v_map, do_map, pr);
    return (int)cudaGetLastError();
  };
  if constexpr (kWide) {
    return DKV ? run(d256::attention_bwd_dkv_kernel<CAUSAL>,
                     sizeof(d256::DkvSmem) + 1024)
               : run(d256::attention_bwd_dq_kernel<CAUSAL>,
                     sizeof(d256::DqSmem) + 1024);
  } else {
    return DKV ? run(attention_bwd_dkv_kernel<CAUSAL>, sizeof(DkvSmem) + 1024)
               : run(attention_bwd_dq_kernel<CAUSAL>, sizeof(DqSmem) + 1024);
  }
}

}  // namespace sm90
}  // namespace
