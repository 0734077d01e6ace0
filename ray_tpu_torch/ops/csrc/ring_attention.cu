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
// without repeating K and V). Any strides over B, H and the sequence (one
// set each for q, k, v), unit stride over D; D from 1 to this library's
// width (kHeadDim: RAY_TPU_HEAD_DIM, 16, 32, 64, 128 or 256, which
// ops/_build.py sets for each width's library; the wrapper sends a width
// to the library of its class, the smallest at or above it). Offsets are
// any host ints; Tq may differ from Tk. Ragged tails are masked by bounds,
// nothing is padded. Outputs o [B, H, Tq, D], m and l [B, H, Tq], all f32
// and contiguous. A row with no visible key gets o = 0, m = -1e30, l = 0:
// the merge of the ring then scales it away.
//
// A width D below the class runs the class's kernels unchanged: in bf16
// the TMA maps describe the tensors at D columns, so the boxes' columns
// past D arrive as zeros (they add 0 to q k, and P v writes 0 there), and
// the epilogue RingBlockCols stores D columns. In f32 the one FMA kernel
// of the class takes the width at run time at every D: it loads whole
// 16-byte vectors below D and zeros past it, and stores D columns.
// The scale is 1 / sqrt(D) of the true D either way. TMA's strides must be
// multiples of 16 bytes and the f32 loads read whole 16-byte vectors, so
// a width that is not a multiple of 16 bytes' values (8 in bf16, 4 in
// f32) comes from the wrapper zero-padded to a multiple of 8 columns,
// still with the true D.
//
// Bound: operations on a long shard, launch and latency on a short one.
// On the 32k ring's path (q [1, 16, 8192, 128], k/v [1, 8, 8192, 128],
// bf16) a block below the diagonal does two products of 2*B*H*Tq*Tk*D
// flops each (5.5e11 together) against ~0.13 GB of operands and outputs:
// ~4000 flops per byte, far above the H100's ~295 bf16 flops per byte, so
// the least time is flops / 989 TFLOP/s. A diagonal block does half that;
// a block whose keys all follow its queries does no arithmetic and only
// writes its outputs. The smaller models' shards (512 or 2048 tokens of 4
// or 8 heads) bound at 0.08-8.7 us: there the card must be filled, and at
// head_dim 16-64 the exponential (one ex2 a score) outweighs the products.
//
// Design. The TPU kernel runs a grid (batch, head, query tile) and holds
// the whole local KV block in VMEM (:117-119), computing one [Tq, Tk]
// score matrix at once. On Hopper a block has 227 KB of shared memory, so
// the key axis becomes a loop over key tiles with a running max, sum and
// rescaled f32 accumulator (online softmax). The loop stops after the last
// key tile holding a column some row of the block can see under the global
// offsets; a block that sees no key loads nothing and writes the
// fully-masked values. Inside a tile, a row whose visible columns have not
// started yet keeps m = -1e30 and takes p = 0 (the reference's
// `where(m > NEG_INF/2, p, 0)`, :84-85), not exp(0) = 1 per masked column.
// Two entry points, chosen by the wrapper from the dtype:
//   - bf16, every width: ring_block_attention_bf16, the wgmma + TMA kernels
//     of attention_fwd_sm90.cuh with the epilogue RingBlockOut below, as
//     the wrapper's launch plan (ops/ring_attention.py::block_plan) says:
//     splits = 0, the 128-query template (3 warpgroups, 128-key tiles, 64
//     at D = 256; at D = 64, 128, 256 where B * H * 128-query tiles fill
//     the card: 1024 blocks on the 32k ring), or splits = n >= 1, the split
//     kernel (64-query blocks of one consumer warpgroup, the key tiles of a
//     query tile split over a cluster of n blocks and merged in split order
//     through distributed shared memory). The bf16 products are exact in
//     f32, so scores, m and l match the reference's f32 cast up to
//     summation order; P is rounded to bf16 for the P v product, l sums the
//     f32 P.
//   - f32: ring_block_attention, ring_block_kernel below: 64-query blocks,
//     64-key tiles (32 at D = 256), f32 FMAs in the mma.sync register
//     layout of mma_tiles.cuh (no TF32: wgmma has no f32).
// Every output element is written by one block in a fixed order: launches
// are deterministic.

#include "attention_fwd_sm90.cuh"
#include "mma_tiles.cuh"

namespace {

// element strides over (batch, head, sequence)
struct Strides {
  long long b, h, s;
};

// ----------------------------------------------------------------------
// kernel 2 in f32 on FMA tiles: block = (64-query tile, b*H + h)
// ----------------------------------------------------------------------

// d: the tensors' head width, D or below it (the columns past it masked)
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
ring_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out, int H,
                  int rep, int Tq, int Tk, int q_offset, int k_offset,
                  Strides sq, Strides sk, Strides sv, float scale, int d) {
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
  const int b = bh / H, h = bh % H, hk = h / rep;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;     // this warp's 16 rows of every tile
  const int wcs = (warp >> 2) * (kKeys / 2);   // its score columns
  const int wco = (warp >> 2) * (D / 2);       // its output columns
  const int sr = tid >> 2, sj = tid & 3;   // softmax: 4 threads per row

  // key tiles up to the last one holding a column that the tile's last
  // row (global position q_offset + rows - 1) can see
  const int n_k = (Tk + kKeys - 1) / kKeys;
  int kt_end = n_k;
  if (CAUSAL) {
    const long long last_key =
        (long long)q_offset + min(q0 + kBlockQ, Tq) - 1 - k_offset;
    kt_end = last_key < 0 ? 0
                          : (int)min((long long)n_k, last_key / kKeys + 1);
  }
  if (kt_end > 0) load_tile_cols<T, D, kBlockQ>(qs, qb, sq.s, q0, Tq, d);

  float m_run = kNegInf, l_run = 0.f;   // row sr's stats (all 4 threads)
  float acc[Sh::kOutNT][4];
  zero(acc);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();   // the last tile's readers are done
    load_tile_cols<T, D, kKeys>(ks, kb, sk.s, k0, Tk, d);
    load_tile_cols<T, D, kKeys>(vs, vb, sv.s, k0, Tk, d);
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
      // a row that has seen no visible key keeps m = -1e30 and adds
      // nothing (its acc and l are 0, so alpha = 1 changes nothing)
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
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
    for (int n = 0; n < Sh::kOutNT; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }
    warp_mma<Sh::kOutNT, kKeys, true, false>(acc, ps + wr * Sh::ldp,
                                             Sh::ldp, vs + wco, Sh::ldd);
  }

  if (sj == 0 && q0 + sr < Tq) {
    m_out[(long long)bh * Tq + q0 + sr] = m_run;
    l_out[(long long)bh * Tq + q0 + sr] = l_run;
  }
  store_acc_cols(o + (long long)bh * Tq * d, d, acc, q0, wr, wco, Tq, d);
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
                   void* m, void* l, const Geometry& g, float scale, int d,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem<T, kHeadDim>();
  auto kernel = ring_block_kernel<T, kHeadDim, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.Tq + kBlockQ - 1) / kBlockQ, g.B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), g.H, g.rep, g.Tq, g.Tk, g.q_offset, g.k_offset,
      g.sq, g.sk, g.sv, scale, d);
  return cudaGetLastError();
}

// kernel 2, bf16: the epilogue of the sm90 template. o [B, H, Tq, D],
// m and l [B, H, Tq], f32 and contiguous; o unnormalised.
template <int D>
struct RingBlockOut {
  float* o;
  float* m;
  float* l;
  int H, Tq;

  __device__ __forceinline__ float out_scale(float) const { return 1.f; }
  __device__ __forceinline__ long long row_index(int b, int h,
                                                 int row) const {
    return ((long long)b * H + h) * Tq + row;
  }
  __device__ __forceinline__ void row_stats(int b, int h, int row,
                                            float m_row, float l_row) const {
    m[row_index(b, h, row)] = m_row;
    l[row_index(b, h, row)] = l_row;
  }
  __device__ __forceinline__ void store(int b, int h, int row, int col,
                                        float x0, float x1) const {
    store_pair(o + row_index(b, h, row) * D + col, x0, x1);
  }
};

// RingBlockOut at a head width d below the kernel's: o [B, H, Tq, d], each
// value stored alone where its column is below d (the columns past it
// hold P v's zeros)
struct RingBlockCols {
  float* o;
  float* m;
  float* l;
  int H, Tq, d;

  __device__ __forceinline__ float out_scale(float) const { return 1.f; }
  __device__ __forceinline__ long long row_index(int b, int h,
                                                 int row) const {
    return ((long long)b * H + h) * Tq + row;
  }
  __device__ __forceinline__ void row_stats(int b, int h, int row,
                                            float m_row, float l_row) const {
    m[row_index(b, h, row)] = m_row;
    l[row_index(b, h, row)] = l_row;
  }
  __device__ __forceinline__ void store(int b, int h, int row, int col,
                                        float x0, float x1) const {
    float* p = o + row_index(b, h, row) * d + col;
    if (col < d) p[0] = x0;
    if (col + 1 < d) p[1] = x1;
  }
};

// every width runs bf16 on the wgmma + TMA kernels
static_assert(RAY_TPU_SM90_FORWARD,
              "kernel 2 runs bf16 on the sm90 forward at every head_dim");

// the bf16 launch the plan names: splits = 0, the 128-query template
// (head_dim a multiple of 64), else the split kernel; D the kernels'
// width, cols the tensors' (D, or below it with the epilogue
// RingBlockCols)
template <int D, class Epilogue>
int launch_bf16(const void* q, const void* k, const void* v, int B,
                const long long (&sq)[3], const long long (&sk)[3],
                const long long (&sv)[3], const sm90::Problem& pr,
                const Epilogue& epi, bool causal, int splits, cudaStream_t s,
                int cols) {
  if (splits == 0) {
    if constexpr (D % 64 == 0) {
      return causal ? sm90::launch<true, D>(q, k, v, B, sq, sk, sv, pr, epi,
                                            s, cols)
                    : sm90::launch<false, D>(q, k, v, B, sq, sk, sv, pr, epi,
                                             s, cols);
    }
    return (int)cudaErrorInvalidValue;
  }
  return causal ? sm90::launch_split<true, D>(q, k, v, B, sq, sk, sv, pr,
                                              epi, splits, s, cols)
                : sm90::launch_split<false, D>(q, k, v, B, sq, sk, sv, pr,
                                               epi, splits, s, cols);
}

bool bad_geometry(int B, int H, int Hkv, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 ||
         Tk <= 0 || D < 1 || D > kHeadDim;
}

}  // namespace

// The entry points. q [B, H, Tq, D], k and v [B, Hkv, Tk, D], unit stride
// over D; D from 1 to this library's width (kHeadDim) and Hkv must divide
// H. o [B, H, Tq, D], m and l
// [B, H, Tq] are f32 and contiguous. causal: 0 or 1. Each returns the
// launch's cudaError_t (or, for the bf16 one, sm90::kEncodeError + the
// encoder's CUresult when a TMA map is refused).

// f32 inputs; (batch, head, seq) strides of q, k and v in elements
extern "C" int ring_block_attention(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int H, int Hkv, int Tq, int Tk, int D, int q_offset, int k_offset,
    long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs, int causal,
    int device, void* stream) {
  if (bad_geometry(B, H, Hkv, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B,        H,        H / Hkv,
                   Tq,       Tk,       q_offset,
                   k_offset, {sqb, sqh, sqs}, {skb, skh, sks},
                   {svb, svh, svs}};
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(causal ? launch<float, true>(q, k, v, o, m, l, g, scale, D, s)
                      : launch<float, false>(q, k, v, o, m, l, g, scale, D,
                                             s));
}

// bf16 inputs; (batch, head, seq) strides of q, k and v in BYTES, each a
// positive multiple of 16, and 16-byte aligned bases (what TMA takes).
// Below the library's width, the maps read D columns (TMA fills the rest
// of each box with zeros) and RingBlockCols stores D.
// splits: the launch plan's (ops/ring_attention.py::block_plan): 0 for the
// 128-query template (head_dim a multiple of 64), 1 to sm90::kMaxSplits
// for the split kernel
extern "C" int ring_block_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int H, int Hkv, int Tq, int Tk, int D, int q_offset, int k_offset,
    long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs, int causal,
    int splits, int device, void* stream) {
  if (bad_geometry(B, H, Hkv, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const sm90::Problem pr{H,        H / Hkv,  Tq,
                         Tk,       q_offset, k_offset,
                         1.0f / sqrtf((float)D)};
  const long long sq[3] = {sqb, sqh, sqs}, sk[3] = {skb, skh, sks},
                  sv[3] = {svb, svh, svs};
  float* out[3] = {static_cast<float*>(o), static_cast<float*>(m),
                   static_cast<float*>(l)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == kHeadDim) {
    const RingBlockOut<kHeadDim> epi{out[0], out[1], out[2], H, Tq};
    return launch_bf16<kHeadDim>(q, k, v, B, sq, sk, sv, pr, epi,
                                 causal != 0, splits, s, D);
  }
  const RingBlockCols epi{out[0], out[1], out[2], H, Tq, D};
  return launch_bf16<kHeadDim>(q, k, v, B, sq, sk, sv, pr, epi, causal != 0,
                               splits, s, D);
}

extern "C" const char* error_string(int code) {
  const char* tma = sm90::encode_error_string(code);
  return tma ? tma : cudaGetErrorString(static_cast<cudaError_t>(code));
}
