// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: ray_tpu/ops/paged_attention.py::_decode_kernel (a Pallas TPU
// kernel, called through paged_attention()). Same function as the plain
// PyTorch version ray_tpu_torch/ops/paged_attention.py::
// paged_attention_reference: one decode token per sequence attends over
// that sequence's paged K/V cache.
//
//   q [B, H, D], k_pages/v_pages [P, KV, page, D] (bf16 or f32, one dtype),
//   page_table [B, MP] int32, seq_lens [B] int32  ->  out [B, H, D] f32.
//   Query head j reads KV head j / G (G = H / KV). Positions >= seq_len are
//   masked (and positions past the table, >= MP * page); seq_len == 0 gives
//   zeros (acc / max(l, 1e-30) with l = 0).
//
// Bound: bytes. A call must read the K and V rows of every valid token
// (sum(seq_len) x KV x D x 2 tensors x dtype bytes) plus q, the page table
// and the lengths, and write the f32 output. It does one multiply-add (2
// flops) per K or V element for each query head of the group: with G = 2
// and bf16 that is 2 flops per byte read, far below the H100's ~295
// flops/byte balance point. The least time is therefore bytes / 3.35 TB/s,
// and tensor cores buy nothing: a wgmma tile of 64 query rows would be 97%
// padding at G = 2. All the arithmetic is f32 FMA in registers.
//
// Design (flash-decoding). The TPU kernel walks a sequential (sequence,
// page) grid with its online-softmax state in VMEM. Here the grid is
// S x KV x B blocks of 128 threads: block (s, kvh, b) owns the logical
// pages [s * pps, (s + 1) * pps) of sequence b for KV head kvh and the G
// query heads that read it. The wrapper picks pps (pages per split) and
// S = ceil(MP / pps) from the shapes alone, never from seq_lens (which is
// on the device), so the launch is the same for every length and can be
// captured in a CUDA graph.
//   - Copies: a (physical page, KV head) tile of K or V is one contiguous,
//     16-byte-aligned run of page * D elements (4 KiB in bf16 at page 16),
//     so it is one cp.async.bulk on the bulk-copy engine, completing on its
//     own mbarrier; no tensor map. Lane p of warp 0 reads page p's table
//     entry (while the length loads) and issues its K and V copies, all up
//     front, while the other warps load q: scores start when the first K
//     tile lands while the rest are in flight. Many small blocks per SM
//     keep more copies in flight. At most 32 pages per split (one lane
//     each).
//   - Scores: D / 8 lanes per token (16 at D = 128), each holding 8
//     elements of the G query rows in f32 (q pre-scaled by log2(e) /
//     sqrt(D)), one 16-byte shared-memory read of K per lane (two in f32),
//     FMAs, a shuffle reduction over the token's lanes; 128 / (D / 8) tokens
//     per pass of the block (8 at D = 128).
//   - Softmax over the split's tokens, exact (all scores are in shared
//     memory): one warp per query row, max, p = exp2(s - m), l = sum p.
//   - P V: one output column per thread at D = 128, G accumulators, V
//     read from shared memory as each V tile lands. At D = 256 a thread
//     owns two columns, 128 apart; at D < 128, 128 / D neighbouring lanes
//     share a column, each summing every (128 / D)-th token, and a shuffle
//     adds their sums.
//   - S == 1: the block writes acc / max(l, 1e-30). S > 1: it writes the
//     unnormalised f32 partial o [B, H, S, D] and m, l [B, H, S] (m in log2
//     units) to a workspace the wrapper allocates, and a second kernel,
//     paged_decode_merge_kernel, combines each (b, head)'s splits in the
//     fixed order s = 0 .. S - 1. A split past its sequence's end writes
//     the empty partial m = -1e30, l = 0, o = 0, which adds nothing. No
//     atomics: two launches give the same bits.
// The split kernel is instantiated per dtype and group size G = 1 .. 8, so
// the G query rows take 8 * G registers a thread, at one head_dim
// (RAY_TPU_HEAD_DIM, which ops/_build.py sets: each width is its own
// library, built in its own nvcc). The block stays 128 threads at every width: the lanes per token
// and the columns per thread follow from D (Cols below). Shared memory
// grows with D (K and V tiles of page x D each), so the wrapper's
// split_plan caps pages per split by a block's bytes at this D and dtype.
//
// Any head_dim d from 1 to the library's width D (its class: the wrapper
// sends d to the library of the smallest built width at or above it). At
// d == D the kernels above run. At d < D an instance of their own (PAD, in
// the kernels named *_padded) runs the class's lanes and columns with the
// columns at or past d masked: q and K read as zeros there, P V skips
// them, only d columns are stored, and q's scale is log2(e) / sqrt(d).
// Shared memory holds the tiles at their true width (page x d contiguous
// values, as the cache holds them), so a tile comes in by cp.async.bulk
// where it is whole 16-byte units (page x d x elt a multiple of 16: every
// page offset is then 16-byte aligned too); else the block's threads copy
// it value by value after the length is known. The rows are read 8 values
// at a time by one vector load where a row is whole 16-byte units, else
// value by value. The cache is never copied or padded.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef RAY_TPU_HEAD_DIM
#error "build with -DRAY_TPU_HEAD_DIM (ops/_build.py)"
#endif
constexpr int kHeadDim = RAY_TPU_HEAD_DIM;   // this library's width
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxPagesPerSplit = 32;    // one lane of warp 0 per page
constexpr float kNegInf = -1e30f;

// How a 128-thread block covers head_dim D
template <int D>
struct Cols {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "head_dim 16, 32, 64, 128 or 256");
  // scores: D / 8 lanes x 8 elements = one K row; a token's lanes are
  // neighbours inside one warp
  static constexpr int kLanesPerToken = D / 8;
  static constexpr int kTokensPerPass = kThreads / kLanesPerToken;
  // P V: output columns a thread owns (128 apart), and threads sharing
  // one column (neighbouring lanes, each every kShare-th token)
  static constexpr int kPerThread = D > kThreads ? D / kThreads : 1;
  static constexpr int kShare = D < kThreads ? kThreads / D : 1;
};

// Shared memory of a split block: K tiles [pps][page][D], V tiles
// [pps][page][D], probabilities [G][pps * page] f32, 2 * pps mbarriers (one
// per K tile, then one per V tile), the G query rows' m and l, and the
// sequence's length. Tiles
// are multiples of 32 bytes (page x D x elt with D >= 16), so each starts
// 16-byte aligned and is a whole number of 16-byte units, as
// cp.async.bulk requires.
// At a padded width the tiles are page x d and need not end 16-byte
// aligned: the probabilities then start at the next multiple of 16.
struct Layout {
  size_t v, probs, bars, rows, total;
};

template <int D, bool PAD = false>
__host__ __device__ inline Layout split_layout(int pps, int page, int G,
                                               int elt, int d = D) {
  const size_t tile = (size_t)page * (PAD ? d : D) * elt;
  Layout L;
  L.v = (size_t)pps * tile;
  L.probs = PAD ? (2 * (size_t)pps * tile + 15) / 16 * 16
                : 2 * (size_t)pps * tile;
  L.bars = L.probs + ((size_t)G * pps * page * sizeof(float) + 7) / 8 * 8;
  L.rows = L.bars + 2 * (size_t)pps * sizeof(uint64_t);
  L.total = L.rows + (2 * (size_t)G + 1) * sizeof(float);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of copies on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until phase 0 has completed (each barrier is used once)
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

// `bytes` contiguous bytes global -> shared on the bulk-copy engine,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements -> f32 (16-byte aligned: one 16-byte read in bf16,
// two in f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// the first n of 8 consecutive elements -> f32, zeros after them (n <= 0:
// all zeros, nothing read): one vector load where all 8 are there and the
// row is whole 16-byte units (vec), else value by value
template <typename T>
__device__ __forceinline__ void load8_cols(const T* p, float (&f)[8], int n,
                                           bool vec) {
  if (vec && n >= 8) {
    load8(p, f);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = j < n ? to_float(p[j]) : 0.f;
}

// The split kernel's bounds: 128 threads; at the widths other than 128
// also at least one block an SM, which lets ptxas give the group-5
// instances the registers that keep them from spilling (without it they
// spilled 4-12 bytes at 64-80 registers; at 128 none spills either way)
#if RAY_TPU_HEAD_DIM == 128
#define PAGED_SPLIT_BOUNDS __launch_bounds__(kThreads)
#else
#define PAGED_SPLIT_BOUNDS __launch_bounds__(kThreads, 1)
#endif

// The split kernel's body at the class width D; PAD: the true width d < D
// (the columns at or past d masked), else d == D. Its pointers are the
// kernels' own __restrict__ parameters
template <typename T, int D, int G, bool PAD>
__device__ __forceinline__ void split_body(
    const T* q, const T* k_pages, const T* v_pages, const int* page_table,
    const int* seq_lens, float* out, float* work, int H, int KV, int page,
    int MP, int pps, float q_scale, int d) {
  using C = Cols<D>;
  // the row stride and the columns stored: D, or the true width
  const int dd = PAD ? d : D;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the query head of group row g
  auto head = [&](int g) { return kvh * G + g; };

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = split_layout<D, PAD>(pps, page, G, sizeof(T), dd);
  const int tile = page * dd;
  // a tile of whole 16-byte units comes in by one bulk copy (its page
  // offsets are then 16-byte aligned too); a row of them by vector loads
  const bool bulk = !PAD || tile * sizeof(T) % 16 == 0;
  const bool vec = !PAD || dd * sizeof(T) % 16 == 0;
  T* k_tiles = reinterpret_cast<T*>(smem);
  T* v_tiles = reinterpret_cast<T*>(smem + L.v);
  float* probs = reinterpret_cast<float*>(smem + L.probs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* row_m = reinterpret_cast<float*>(smem + L.rows);
  float* row_l = row_m + G;

  // partials: o [B, H, S, D], then m [B, H, S], then l [B, H, S]
  const size_t n_rows = (size_t)gridDim.z * H * S;
  float* part_o = work;
  float* part_m = work + n_rows * dd;
  float* part_l = part_m + n_rows;

  const int first = s * pps;            // first logical page of the split
  const int start = first * page;       // its first token
  const int n_table = min(pps, MP - first);
  // the pages to load for a length
  auto pages_for = [&](int len) {
    return len <= start ? 0 : min(n_table, (len - start + page - 1) / page);
  };
  int* len_s = reinterpret_cast<int*>(row_l + G);
  if (warp == 0) {
    // warp 0: lane p reads page p's table entry while the length loads,
    // then issues page p's K tile (barrier p) and V tile (n_pages + p)
    const int phys = lane < n_table
                         ? page_table[(size_t)b * MP + first + lane]
                         : 0;
    const int len = seq_lens[b];
    const int n_pages = pages_for(len);
    if (lane == 0) {
      *len_s = len;
      if (bulk) {
        for (int i = 0; i < 2 * n_pages; ++i) mbar_init(&bars[i]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
    }
    __syncwarp();
    if (bulk && lane < n_pages) {
      const size_t off = ((size_t)phys * KV + kvh) * (size_t)tile;
      const uint32_t bytes = (uint32_t)(tile * sizeof(T));
      mbar_expect_tx(&bars[lane], bytes);
      bulk_load(k_tiles + (size_t)lane * tile, k_pages + off, bytes,
                &bars[lane]);
      mbar_expect_tx(&bars[n_pages + lane], bytes);
      bulk_load(v_tiles + (size_t)lane * tile, v_pages + off, bytes,
                &bars[n_pages + lane]);
    }
  }
  // this lane's 8 elements of the group's query rows, scaled so that
  // exp2(q . k) = exp(q . k / sqrt(D))
  const int chunk = tid % C::kLanesPerToken;
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (PAD) {
      load8_cols(q + ((size_t)b * H + head(g)) * dd + chunk * 8, qr[g],
                 dd - chunk * 8, vec);
    } else {
      load8(q + ((size_t)b * H + head(g)) * D + chunk * 8, qr[g]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) qr[g][j] *= q_scale;
  }

  __syncthreads();  // the length is in shared memory, the barriers set up
  const int len = *len_s;
  if (len <= start) {
    // nothing to attend: the empty partial (S > 1), zeros (S == 1)
    for (int g = 0; g < G; ++g) {
      const size_t row = (size_t)b * H + head(g);
      if (S == 1) {
#pragma unroll
        for (int c = 0; c < C::kPerThread; ++c) {
          if constexpr (PAD) {
            if (tid + c * kThreads < dd) {
              out[row * dd + tid + c * kThreads] = 0.f;
            }
          } else if (D >= kThreads || tid < D) {
            out[row * D + tid + c * kThreads] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C::kPerThread; ++c) {
          if constexpr (PAD) {
            if (tid + c * kThreads < dd) {
              part_o[(row * S + s) * dd + tid + c * kThreads] = 0.f;
            }
          } else if (D >= kThreads || tid < D) {
            part_o[(row * S + s) * D + tid + c * kThreads] = 0.f;
          }
        }
        if (tid == 0) {
          part_m[row * S + s] = kNegInf;
          part_l[row * S + s] = 0.f;
        }
      }
    }
    return;
  }
  // the pages loaded, and the tokens attended: the tail mask
  const int n_pages = pages_for(len);
  const int n_tok = min(len - start, n_pages * page);
  const int n_max = pps * page;         // stride of a probability row
  if (!bulk) {
    // the tiles value by value: page x d values are not whole 16-byte
    // units, so neither a bulk copy nor an aligned vector takes them
    for (int i = 0; i < n_pages; ++i) {
      const size_t off =
          ((size_t)page_table[(size_t)b * MP + first + i] * KV + kvh) *
          (size_t)tile;
      for (int e = tid; e < tile; e += kThreads) {
        k_tiles[(size_t)i * tile + e] = k_pages[off + e];
        v_tiles[(size_t)i * tile + e] = v_pages[off + e];
      }
    }
    __syncthreads();
  }

  // scores, page by page as the K tiles land: probs[g][t] = q_g . k_t
  for (int i = 0; i < n_pages; ++i) {
    if (bulk) mbar_wait0(&bars[i]);
    const int valid = min(n_tok - i * page, page);
    const T* kt = k_tiles + (size_t)i * tile;
    for (int t0 = 0; t0 < valid; t0 += C::kTokensPerPass) {
      const int t = t0 + tid / C::kLanesPerToken;
      const bool live = t < valid;
      float kf[8];
      if (live) {
        if constexpr (PAD) {
          load8_cols(kt + (size_t)t * dd + chunk * 8, kf, dd - chunk * 8,
                     vec);
        } else {
          load8(kt + (size_t)t * D + chunk * 8, kf);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(qr[g][j], kf[j], acc);
#pragma unroll
        for (int o = C::kLanesPerToken / 2; o > 0; o >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        }
        if (live && chunk == 0) probs[g * n_max + i * page + t] = acc;
      }
    }
  }
  __syncthreads();

  // softmax over the split's tokens, one warp per query row
  for (int g = warp; g < G; g += kWarps) {
    float* pg = probs + g * n_max;
    float m = kNegInf;
    for (int t = lane; t < n_tok; t += 32) m = fmaxf(m, pg[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    float l = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float p = exp2f(pg[t] - m);
      pg[t] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      row_m[g] = m;
      row_l[g] = l;
    }
  }
  __syncthreads();

  // P V, page by page as the V tiles land: columns col + 128 c of this
  // thread, over tokens part, part + kShare, ... (at D = 128: column tid,
  // every token)
  constexpr int kPer = C::kPerThread, kShare = C::kShare;
  const int col = tid / kShare, part = tid % kShare;
  float acc[G][kPer];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[g][c] = 0.f;
  }
  for (int i = 0; i < n_pages; ++i) {
    if (bulk) mbar_wait0(&bars[n_pages + i]);
    const int valid = min(n_tok - i * page, page);
    const T* vt = v_tiles + (size_t)i * tile + col;
    const float* pi = probs + i * page;
#pragma unroll 4
    for (int t = part; t < valid; t += kShare) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        if constexpr (PAD) {
          if (col + c * kThreads >= dd) continue;   // a masked column
        }
        const float v = to_float(vt[(size_t)t * dd + c * kThreads]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g][c] = fmaf(pi[g * n_max + t], v, acc[g][c]);
        }
      }
    }
  }
  if (kShare > 1) {
    // the column's kShare neighbouring lanes add their tokens' sums
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = kShare / 2; o > 0; o >>= 1) {
        acc[g][0] += __shfl_xor_sync(0xffffffffu, acc[g][0], o);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t row = (size_t)b * H + head(g);
    if (S == 1) {
      if (part == 0) {
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          if constexpr (PAD) {
            if (col + c * kThreads >= dd) continue;
          }
          out[row * dd + col + c * kThreads] =
              acc[g][c] / fmaxf(row_l[g], 1e-30f);
        }
      }
    } else {
      if (part == 0) {
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          if constexpr (PAD) {
            if (col + c * kThreads >= dd) continue;
          }
          part_o[(row * S + s) * dd + col + c * kThreads] = acc[g][c];
        }
      }
      if (tid == 0) {
        part_m[row * S + s] = row_m[g];
        part_l[row * S + s] = row_l[g];
      }
    }
  }
}

template <typename T, int D, int G>
__global__ void PAGED_SPLIT_BOUNDS
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ seq_lens,
                          float* __restrict__ out,
                          float* __restrict__ work, int H, int KV, int page,
                          int MP, int pps, float q_scale) {
  split_body<T, D, G, false>(q, k_pages, v_pages, page_table, seq_lens, out,
                             work, H, KV, page, MP, pps, q_scale, D);
}

// the same at a true width d below the class D
template <typename T, int D, int G>
__global__ void PAGED_SPLIT_BOUNDS
paged_decode_split_kernel_padded(const T* __restrict__ q,
                                 const T* __restrict__ k_pages,
                                 const T* __restrict__ v_pages,
                                 const int* __restrict__ page_table,
                                 const int* __restrict__ seq_lens,
                                 float* __restrict__ out,
                                 float* __restrict__ work, int H, int KV,
                                 int page, int MP, int pps, float q_scale,
                                 int d) {
  split_body<T, D, G, true>(q, k_pages, v_pages, page_table, seq_lens, out,
                            work, H, KV, page, MP, pps, q_scale, d);
}

// One block per (b, head), one column per thread (min(D, 128) threads;
// at D = 256 a thread takes columns d and d + 128): the splits' partials
// combined in the fixed order s = 0 .. S - 1 (online: each step rescales
// the sum by exp2(m - m_new) and the partial by exp2(m_s - m_new)). An
// empty split (m = -1e30, l = 0, o = 0) adds nothing; a row with no token
// at all gives 0 / 1e-30 = 0. PAD: the partials and the output rows are
// dd < D wide, the threads past it idle.
template <int D, bool PAD>
__device__ __forceinline__ void merge_body(const float* work, float* out,
                                           int n_rows, int S, int dd) {
  const size_t row = blockIdx.x;
  const float* part_o = work + row * S * dd;
  const float* part_m = work + (size_t)n_rows * S * dd + row * S;
  const float* part_l = part_m + (size_t)n_rows * S;
#pragma unroll
  for (int c = 0; c < Cols<D>::kPerThread; ++c) {
    const int d = threadIdx.x + c * kThreads;
    if constexpr (PAD) {
      if (d >= dd) continue;
    }
    // a running max; the loads do not depend on it, so they issue together
    float m = kNegInf, l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float ms = part_m[s], ls = part_l[s];
      const float os = part_o[(size_t)s * dd + d];
      const float m_new = fmaxf(m, ms);
      const float alpha = exp2f(m - m_new), w = exp2f(ms - m_new);
      acc = acc * alpha + w * os;
      l = l * alpha + w * ls;
      m = m_new;
    }
    out[row * dd + d] = acc / fmaxf(l, 1e-30f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ work,
                          float* __restrict__ out, int n_rows, int S) {
  merge_body<D, false>(work, out, n_rows, S, D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel_padded(const float* __restrict__ work,
                                 float* __restrict__ out, int n_rows, int S,
                                 int d) {
  merge_body<D, true>(work, out, n_rows, S, d);
}

// one launch of `kernel` with `smem` bytes of dynamic shared memory
template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the split kernel's instance for group G = H / KV (1 .. kMaxGroup) at
// head_dim D (PAD: at the true width d < D), then the merge
template <typename T, int D, bool PAD, int G = 1>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* seq_lens, void* out,
                   void* work, int B, int H, int KV, int page, int MP,
                   int pps, int d, cudaStream_t stream) {
  if constexpr (G < kMaxGroup) {
    if (H / KV != G) {
      return launch<T, D, PAD, G + 1>(q, k_pages, v_pages, page_table,
                                      seq_lens, out, work, B, H, KV, page,
                                      MP, pps, d, stream);
    }
  }
  const int S = (MP + pps - 1) / pps;
  const size_t smem = split_layout<D, PAD>(pps, page, G, sizeof(T), d).total;
  // exp2(q . k * q_scale) = exp(q . k / sqrt(d)) at the true width
  const float q_scale = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid(S, KV, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  cudaError_t err;
  if constexpr (PAD) {
    err = run(paged_decode_split_kernel_padded<T, D, G>, grid, kThreads,
              smem, stream, qp, kp, vp, table, lens, o, w, H, KV, page, MP,
              pps, q_scale, d);
  } else {
    err = run(paged_decode_split_kernel<T, D, G>, grid, kThreads, smem,
              stream, qp, kp, vp, table, lens, o, w, H, KV, page, MP, pps,
              q_scale);
  }
  if (err != cudaSuccess || S == 1) return err;
  const int threads = D < kThreads ? D : kThreads;
  const float* parts = w;
  if constexpr (PAD) {
    return run(paged_decode_merge_kernel_padded<D>, dim3(B * H), threads, 0,
               stream, parts, o, B * H, S, d);
  }
  return run(paged_decode_merge_kernel<D>, dim3(B * H), threads, 0, stream,
             parts, o, B * H, S);
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k_pages,
                         const void* v_pages, const void* page_table,
                         const void* seq_lens, void* out, void* work, int B,
                         int H, int KV, int D, int page, int MP, int pps,
                         cudaStream_t stream) {
  if (D == kHeadDim) {
    return launch<T, kHeadDim, false>(q, k_pages, v_pages, page_table,
                                      seq_lens, out, work, B, H, KV, page,
                                      MP, pps, D, stream);
  }
  return launch<T, kHeadDim, true>(q, k_pages, v_pages, page_table, seq_lens,
                                   out, work, B, H, KV, page, MP, pps, D,
                                   stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim D: 1 to this library's width
// (kHeadDim, D's class). pps: pages per split; S = ceil(MP / pps) splits.
// work: f32 workspace of B * H * S * (D + 2) values when S > 1 (unused when
// S == 1). Launches the split kernel and, when S > 1, the merge kernel on
// `stream`. Returns the first failed launch's cudaError_t, else 0.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out,
                                      void* work, int B, int H, int KV,
                                      int D, int page, int MP, int pps,
                                      int dtype, int device, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || KV > 65535 || H % KV != 0 ||
      H / KV > kMaxGroup || page <= 0 || MP <= 0 || pps <= 0 || pps > MP ||
      pps > kMaxPagesPerSplit || D < 1 || D > kHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_width<float>(q, k_pages, v_pages, page_table,
                                    seq_lens, out, work, B, H, KV, D, page,
                                    MP, pps, s);
  }
  if (dtype == 1) {
    return (int)launch_width<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                            seq_lens, out, work, B, H, KV, D,
                                            page, MP, pps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
