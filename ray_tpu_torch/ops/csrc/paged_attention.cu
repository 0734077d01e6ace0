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
//   masked; seq_len == 0 gives zeros (acc / max(l, 1e-30) with l = 0).
//
// Bound: bytes. A call must read the K and V rows of every valid token
// (sum(seq_len) x KV x D x 2 tensors x dtype bytes) plus q, the page table
// and the lengths, and write the f32 output. It does one multiply-add (2
// flops) per K or V element for each query head of the group: with G = 2
// and bf16 that is 2 flops per byte read, far below the H100's ~295
// flops/byte balance point. The least time is therefore bytes / 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential (batch, page) grid and carries
// the online-softmax state across grid steps in VMEM scratch. Hopper runs
// blocks in parallel and in no order, so here one thread block owns one
// (sequence, KV head) and loops over the sequence's logical pages itself,
// reading page_table[b, p] (there is no scalar prefetch). Each page's K and
// V tiles (page x D: 16 x 128 bf16 = 4 KiB each) are staged into shared
// memory with coalesced 16-byte loads. The G query heads that share the KV
// head score each token with one warp per token (lanes split D, butterfly
// shuffle reduction). The online softmax (m, l, acc) runs in f32 registers,
// one thread per output column. The tail of the last page is masked by
// seq_len. The kernel allocates nothing and launches on the caller's stream.
//
// Later work, not done here: split-K over pages (B x KV blocks is only 256
// blocks for 132 SMs at the serving shape, and fewer for short batches),
// and cp.async/TMA double-buffering so the next page's tiles load while the
// current page's math runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, float* __restrict__ out,
                    int H, int KV, int page, int MP, float scale) {
  static_assert(D % 32 == 0, "head_dim must split evenly over a warp");
  constexpr int kPerLane = D / 32;                           // score phase
  constexpr int kPerThread = (D + kThreads - 1) / kThreads;  // output cols
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_tile = reinterpret_cast<T*>(smem);                    // [page][D]
  T* v_tile = k_tile + page * D;                             // [page][D]
  float* scores = reinterpret_cast<float*>(v_tile + page * D);  // [G][page]

  // this lane's D-slice of the group's query rows, in f32
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  float qr[kMaxGroup][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      qr[g][j] = g < G ? to_float(qb[g * D + lane * kPerLane + j]) : 0.f;
    }
  }

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kPerThread];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[g][j] = 0.f;
  }

  const int len = seq_lens[b];
  const int n_pages = len <= 0 ? 0 : min((len + page - 1) / page, MP);
  const int tile_vecs = page * D * (int)sizeof(T) / 16;

  for (int p = 0; p < n_pages; ++p) {
    const int phys = page_table[(size_t)b * MP + p];
    const int valid = min(len - p * page, page);
    const size_t off = ((size_t)phys * KV + kvh) * (size_t)page * D;
    const int4* ksrc = reinterpret_cast<const int4*>(k_pages + off);
    const int4* vsrc = reinterpret_cast<const int4*>(v_pages + off);
    int4* kdst = reinterpret_cast<int4*>(k_tile);
    int4* vdst = reinterpret_cast<int4*>(v_tile);
    for (int i = tid; i < tile_vecs; i += kThreads) {
      kdst[i] = ksrc[i];
      vdst[i] = vsrc[i];
    }
    __syncthreads();

    // scores[g][t] = (q_g . k_t) * scale, one warp per token
    for (int t = warp; t < valid; t += kWarps) {
      const T* kt = k_tile + t * D + lane * kPerLane;
      float kf[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) kf[j] = to_float(kt[j]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) s += qr[g][j] * kf[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
          }
          if (lane == 0) scores[g * page + t] = s * scale;
        }
      }
    }
    __syncthreads();

    // online softmax over this page's valid tokens; every thread keeps the
    // same (m, l) and its own output columns of acc
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float* sg = scores + g * page;
        float m_cur = kNegInf;
        for (int t = 0; t < valid; ++t) m_cur = fmaxf(m_cur, sg[t]);
        const float m_new = fmaxf(m[g], m_cur);
        const float alpha = expf(m[g] - m_new);
        float l_page = 0.f;
        float pv[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) pv[j] = 0.f;
        for (int t = 0; t < valid; ++t) {
          const float pr = expf(sg[t] - m_new);
          l_page += pr;
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            const int d = tid + j * kThreads;
            if (d < D) pv[j] += pr * to_float(v_tile[t * D + d]);
          }
        }
        l[g] = l[g] * alpha + l_page;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) acc[g][j] = acc[g][j] * alpha + pv[j];
        m[g] = m_new;
      }
    }
    __syncthreads();  // the next page overwrites the tiles and scores
  }

  float* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float denom = fmaxf(l[g], 1e-30f);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int d = tid + j * kThreads;
        if (d < D) ob[g * D + d] = acc[g][j] / denom;
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* seq_lens, void* out,
                   int B, int H, int KV, int page, int MP,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      2 * (size_t)page * D * sizeof(T) + (size_t)G * page * sizeof(float);
  const float scale = 1.0f / sqrtf((float)D);
  paged_decode_kernel<T, D><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<float*>(out), H, KV,
      page, MP, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim D must be 128 (the serving
// model's). Returns the launch's cudaError_t.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out, int B,
                                      int H, int KV, int D, int page, int MP,
                                      int dtype, int device, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || page <= 0 ||
      MP <= 0 || D != 128) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float, 128>(q, k_pages, v_pages, page_table, seq_lens,
                                   out, B, H, KV, page, MP, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, 128>(q, k_pages, v_pages, page_table,
                                           seq_lens, out, B, H, KV, page, MP,
                                           s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
