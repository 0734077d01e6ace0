// Attention forward for Hopper (sm_90a): one kernel template for the bf16
// path of ring attention's block kernel (kernel 2, ring_attention.cu) and
// of the flash forward (kernel 3a, flash_attention.cu), and below it the
// split kernel, kernel 2's launch on short shards and narrow heads. Each
// file instantiates them with its own epilogue; their f32 paths keep the
// FMA kernels of mma_tiles.cuh (wgmma has no f32, only TF32). The flash
// backward (attention_bwd_sm90.cuh) is built on its primitives.
//
// The function, for one (batch, head) and the global offsets of the first
// query and key (both 0 for the flash forward):
//   s = (q k^T) * scale, visible where key < Tk and, causal,
//   q_offset + i >= k_offset + j; m = max_row(s) over visible keys;
//   p = exp(s - m), 0 in a row with no visible key (m stays -1e30);
//   l = sum_row(p); o = p v, P rounded to bf16 for the product.
// The epilogue receives, per row, m (natural-log units), l and the
// unnormalised f32 o.
//
// Bound: operations (two products of 2*D flops per visible pair, ~1000-4000
// flops per byte at the main paths' shapes, above the H100's ~295).
//
// Head_dim D is a template parameter: 64, 128 or 256 (a box is 64
// columns, 128 bytes; the split kernel takes narrower rows too).
// Fwd<D> below sets the tiles: D / 64 boxes a row of Q, K and V; 128-key
// tiles, or 64 at D = 256, where O is 64 x 256 f32 (128 registers a
// thread) and 128 keys of S would leave too few registers, and two
// 128-key stages of K and V would not fit in shared memory; P V as
// m64nNk16 with N = min(D, 128), twice at D = 256. The description below
// is D = 128's.
//
// Design (a block per (b, h, 128-query tile); 3 warpgroups):
//   - warpgroups 0 and 1 consume: each owns 64 query rows and runs both
//     products on wgmma m64n128k16 with f32 accumulators in registers.
//     S = Q K^T reads Q and K from shared memory (K-major); O += P V takes
//     P from registers (the S accumulator converted to bf16: for 16-bit
//     types the m64nNk16 accumulator layout is the A-fragment layout) and V
//     from shared memory (MN-major, transposed).
//   - warpgroup 2 produces: one thread issues TMA loads, Q once and K/V
//     tiles of 128 keys into a ring of kStages stages with a full and an
//     empty mbarrier each. setmaxnreg hands its registers to the consumers.
//   - every tile is two 64-column boxes (128 bytes, the widest box that
//     128-byte swizzling takes) of the 4-D [B, H, T, D] view, swizzled as
//     wgmma's descriptors expect; rows past the tensor's end arrive as
//     zeros and are masked by bounds.
//   - softmax in registers: each row's max and sum live in the 4 threads of
//     a quad; p = 2^((s - m) * scale * log2 e) in one ex2.approx, with m
//     kept in the units of the raw products, so m * scale is the
//     reference's m exactly. l is summed per thread and reduced over the
//     quad at the end.
//   - only tiles the diagonal (or the end of the keys) cuts are masked; the
//     key loop stops after the last tile any row of the block can see, and
//     a block that sees no key loads nothing.
//   - blocks run in groups of 16 (batch, head) pairs, longest causal rows
//     first inside a group, so a group's K and V stay in L2.
//   - per tile, each consumer runs S = Q K^T, its softmax, then O += P V,
//     waiting on each product; the two consumer warpgroups overlap each
//     other. Deferring P V behind the next tile's S, with or without the
//     warpgroups taking turns to issue, measured slower (PERF.md, section 6).
//   - no atomics and no split over keys: a launch is deterministic. A
//     block per SM, B * H * ceil(Tq / 128) blocks: the card is full from
//     132 on (the 32k ring's 1024 at 128; the flash forward's 4096 at
//     the train shape).

#pragma once

#include <cuda.h>

#include <atomic>

#include "mma_tiles.cuh"

namespace {
namespace sm90 {

constexpr int kRows = 128;     // query rows per block: two warpgroups of 64
constexpr int kKeys = 128;     // keys per K/V tile (the backward's, and
                               // the forward's at D <= 128)
constexpr int kHalf = 64;      // head_dim columns per 128-byte box
constexpr int kStages = 2;
constexpr int kHeadGroup = 16; // (batch, head) pairs per group of blocks
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kBlockThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBoxBytes = kKeys * kHalf * 2;   // one 128 x 64 bf16 box
// cuTensorMapEncodeTiled's refusal, returned as 1000 + its CUresult
constexpr int kEncodeError = 1000;

// the forward's tiles at head_dim D
template <int D>
struct Fwd {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  static constexpr int kBoxes = D / kHalf;          // boxes a row
  static constexpr int kKeys = D > 128 ? 64 : 128;  // keys a K/V tile
  static constexpr int kS = kKeys / 2;   // S accumulators a thread
  static constexpr int kN = D < 128 ? D : 128;   // columns a P V product
  static constexpr int kChunks = D / kN;         // P V products a tile
  static constexpr int kO = kN / 2;      // O accumulators a product
  static constexpr int kKeyBoxBytes = kKeys * kHalf * 2;
};

template <int D>
struct alignas(1024) FwdSmem {
  bf16 q[Fwd<D>::kBoxes][kRows * kHalf];
  bf16 k[kStages][Fwd<D>::kBoxes][Fwd<D>::kKeys * kHalf];
  bf16 v[kStages][Fwd<D>::kBoxes][Fwd<D>::kKeys * kHalf];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
// the dynamic shared memory base is rounded up to 1024 bytes (the swizzle
// atom) inside the kernel
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;
}

// ----------------------------------------------------------------------
// barriers, TMA, wgmma
// ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map at coordinates (d, t, h, b) -> shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(t), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle. K-major tiles (Q, K): 8-row groups 1024 bytes apart,
// the leading offset unused. MN-major (V): the leading offset steps to the
// next 64 head_dim columns (the second box), the stride offset to the next
// 8 keys.
__device__ __forceinline__ uint64_t smem_desc(const void* p,
                                              uint32_t leading_bytes,
                                              uint32_t stride_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(leading_bytes >> 4) << 16 |
         static_cast<uint64_t>(stride_bytes >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an asynchronous
// product's registers (accumulator or A operand) across its wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B, A [64 x 16] and B [16 x 128] from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A B, A [64 x 16] and B [16 x 64] from shared memory (the
// backward's products over head_dim with 64 columns)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B, A [64 x 16] from registers (bf16 pairs in the accumulator
// layout of m64nNk16), B [16 x 128] from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B, A [64 x 16] from registers, B [16 x 64] from shared memory,
// MN-major (P V at head_dim 64)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B, A [64 x 16] from registers, B [16 x 32] from shared memory,
// MN-major (P V at head_dim 32)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B, A [64 x 16] from registers, B [16 x 16] from shared memory,
// MN-major (P V at head_dim 16)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// bf16 pair of probabilities, lower column in the low half
__device__ __forceinline__ uint32_t pack_p(float p0, float p1) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// S = Q K^T for one warpgroup's 64 rows and a tile of N / 2 keys (N = 64:
// 128 keys; N = 32: 64), head_dim in NB 64-column boxes (box j of Q at
// qa + j * q_box, of K at kb + j * k_box elements), 16 columns per wgmma
// (32 bytes into each swizzled 128-byte row)
template <int NB, int N>
__device__ __forceinline__ void score_tile(float (&s)[N], const bf16* qa,
                                           int q_box, const bf16* kb,
                                           int k_box) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(s, smem_desc(qa + j * q_box + kk * 16, 16, 1024),
               smem_desc(kb + j * k_box + kk * 16, 16, 1024), j | kk);
    }
  }
}

// O += P V: 16 keys per wgmma (two 8-key groups of 1024 bytes), NA / 4
// wgmmas of N = 2 * NO columns; N = 128 spans two head_dim boxes of V,
// box_bytes apart (the size of one box: kBoxBytes for 128-row boxes)
template <int NA, int NO>
__device__ __forceinline__ void value_tile(float (&o)[NO],
                                           const uint32_t (&pa)[NA],
                                           const bf16* vb,
                                           uint32_t box_bytes) {
#pragma unroll
  for (int kk = 0; kk < NA / 4; ++kk) {
    wgmma_rs(o, pa + 4 * kk, smem_desc(vb + kk * 16 * kHalf, box_bytes, 1024));
  }
}

// 2^x in one special-function instruction (subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one tile's scores s (raw products; -1e30 where
// masked) for the thread's two rows: updates the running maxima and this
// thread's share of the sums, turns s into p and returns the factors that
// rescale the rows' o. c = scale * log2(e). N / 4 n-tiles of 8 keys.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& alpha_lo,
                                             float& alpha_hi, float c) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  alpha_lo = fast_exp2((m_lo - mx_lo) * c);
  alpha_hi = fast_exp2((m_hi - mx_hi) * c);
  m_lo = mx_lo;
  m_hi = mx_hi;
  // a row that has seen no visible key keeps m = -1e30 and adds nothing
  // (its o and l are 0, so alpha = 1 changes nothing)
  const bool live_lo = m_lo > 0.5f * kNegInf;
  const bool live_hi = m_hi > 0.5f * kNegInf;
  // such a row subtracts 0: its scores, all masked, give p = 0
  const float mu_lo = live_lo ? m_lo : 0.f, mu_hi = live_hi ? m_hi : 0.f;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    s[4 * n] = fast_exp2((s[4 * n] - mu_lo) * c);
    s[4 * n + 1] = fast_exp2((s[4 * n + 1] - mu_lo) * c);
    s[4 * n + 2] = fast_exp2((s[4 * n + 2] - mu_hi) * c);
    s[4 * n + 3] = fast_exp2((s[4 * n + 3] - mu_hi) * c);
    sum_lo += s[4 * n] + s[4 * n + 1];
    sum_hi += s[4 * n + 2] + s[4 * n + 3];
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
}

// this warp is done with a stage: one arrival on its empty barrier
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ----------------------------------------------------------------------
// the kernel
// ----------------------------------------------------------------------

// One launch's shapes. Query head h reads KV head h / rep (grouped-query
// attention, K and V unrepeated); offsets are the global positions of the
// first query and key.
struct Problem {
  int H, rep, Tq, Tk;
  long long q_offset, k_offset;
  float scale;
};

// Epilogue: out_scale(l) multiplies a row's o before store(); row_stats()
// is called once per stored row with m in natural-log units (-1e30 for a
// row that saw no key) and l; store() gets two adjacent columns of a row.
template <bool CAUSAL, int D, class Epilogue>
__global__ void __launch_bounds__(kBlockThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const Problem pr, const Epilogue epi) {
  using F = Fwd<D>;
  constexpr int kKeys = F::kKeys;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // Block order: heads in groups of kHeadGroup; inside a group the query
  // tiles go longest rows first, all heads of the group at each tile. The
  // group's K and V (1 MB per head at the train shape) stay in L2 while
  // its tiles run, and the longest causal rows start first.
  const int n_q = (pr.Tq + kRows - 1) / kRows;
  const int n_bh = gridDim.x / n_q;
  const int group = blockIdx.x / (kHeadGroup * n_q);
  const int first = group * kHeadGroup;
  const int width = min(kHeadGroup, n_bh - first);
  const int r = blockIdx.x - first * n_q;
  const int bh = first + r % width;
  const int q0 = (n_q - 1 - r / width) * kRows;
  const int b = bh / pr.H, h = bh % pr.H;
  const int hk = h / pr.rep;
  // key tiles up to the last one holding a key that the block's last row
  // can see
  const int n_k = (pr.Tk + kKeys - 1) / kKeys;
  int kt_end = n_k;
  if (CAUSAL) {
    const long long last_key =
        pr.q_offset + min(q0 + kRows, pr.Tq) - 1 - pr.k_offset;
    kt_end = last_key < 0 ? 0
                          : (int)min((long long)n_k, last_key / kKeys + 1);
  }
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
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128 && kt_end > 0) {
      mbar_expect_tx(&sm.q_full, F::kBoxes * kBoxBytes);
#pragma unroll
      for (int j = 0; j < F::kBoxes; ++j) {
        tma_load(sm.q[j], &q_map, &sm.q_full, j * kHalf, q0, h, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * kKeys;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full[stage], 2 * F::kBoxes * F::kKeyBoxBytes);
        uint64_t* full = &sm.full[stage];
#pragma unroll
        for (int j = 0; j < F::kBoxes; ++j) {
          tma_load(sm.k[stage][j], &k_map, full, j * kHalf, k0, hk, b);
        }
#pragma unroll
        for (int j = 0; j < F::kBoxes; ++j) {
          tma_load(sm.v[stage][j], &v_map, full, j * kHalf, k0, hk, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows r_wg .. r_wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_wg = q0 + wg * 64;
    const int row_lo = r_wg + warp * 16 + g, row_hi = row_lo + 8;
    // global positions of the warpgroup's first and last stored rows
    const long long wg_first = pr.q_offset + r_wg;
    const long long wg_last = pr.q_offset + min(r_wg + 63, pr.Tq - 1);
    const float c = pr.scale * kLog2e;
    // accumulator element i of product c: row g + 8 * ((i / 2) % 2) of
    // the warp's 16, column c * kN + 8 * (i / 4) + 2 * t + i % 2
    float o[F::kChunks][F::kO];
#pragma unroll
    for (int c = 0; c < F::kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < F::kO; ++i) o[c][i] = 0.f;
    }
    // row maxima of the raw products q k (scale applied on output), and
    // this thread's share of the row sums
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    const bf16* qa = sm.q[0] + wg * 64 * kHalf;
    if (kt_end > 0) mbar_wait(&sm.q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * kKeys;
      const long long key_first = pr.k_offset + k0;
      mbar_wait(&sm.full[stage], phase);
      // a tile whose keys all follow this warpgroup's rows adds nothing
      if (!CAUSAL || key_first <= wg_last) {
        float s[F::kS];
        wgmma_fence();
        score_tile<F::kBoxes>(s, qa, kRows * kHalf, sm.k[stage][0],
                              kKeys * kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);
        // mask only a tile that the end of the keys or the diagonal cuts
        const bool cut = k0 + kKeys > pr.Tk ||
                         (CAUSAL && key_first + kKeys - 1 > wg_first);
        if (cut) {
#pragma unroll
          for (int i = 0; i < F::kS; ++i) {
            const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = (i & 2) ? row_hi : row_lo;
            if (!(col < pr.Tk &&
                  causal_visible(pr.q_offset + row, pr.k_offset + col,
                                 CAUSAL))) {
              s[i] = kNegInf;
            }
          }
        }
        float alpha_lo, alpha_hi;
        softmax_tile(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, c);
#pragma unroll
        for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
          for (int n = 0; n < F::kO / 4; ++n) {
            o[ch][4 * n] *= alpha_lo;
            o[ch][4 * n + 1] *= alpha_lo;
            o[ch][4 * n + 2] *= alpha_hi;
            o[ch][4 * n + 3] *= alpha_hi;
          }
        }
        // P as the A operand: keys 16kk..16kk+15 are accumulator n-tiles
        // 2kk and 2kk+1
        uint32_t pa[F::kS / 2];
#pragma unroll
        for (int i = 0; i < F::kS / 2; ++i) {
          pa[i] = pack_p(s[2 * i], s[2 * i + 1]);
        }
        wgmma_fence();
        // product ch: V's columns ch * kN .., boxes 2 ch and 2 ch + 1
#pragma unroll
        for (int ch = 0; ch < F::kChunks; ++ch) {
          value_tile(o[ch], pa, sm.v[stage][2 * ch], F::kKeyBoxBytes);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ch = 0; ch < F::kChunks; ++ch) pin(o[ch]);
        pin(pa);
      }
      release(&sm.empty[stage], lane);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: the quad's row sums, then each stored row
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      const float m_raw = half ? m_hi : m_lo;
      const float l = half ? l_hi : l_lo;
      if (row < pr.Tq) {
        if (t == 0) {
          epi.row_stats(b, h, row,
                        m_raw > 0.5f * kNegInf ? m_raw * pr.scale : kNegInf,
                        l);
        }
        const float mul = epi.out_scale(l);
#pragma unroll
        for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
          for (int n = 0; n < F::kO / 4; ++n) {
            epi.store(b, h, row, ch * F::kN + 8 * n + 2 * t,
                      o[ch][4 * n + 2 * half] * mul,
                      o[ch][4 * n + 2 * half + 1] * mul);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------------
// the split kernel: kernel 2 on short shards and narrow heads
// ----------------------------------------------------------------------
//
// The kernel above gives a 512-token shard of 8 heads 32 blocks of 128
// queries, one an SM, each walking every key tile alone. This one cuts the
// same function finer, for kernel 2 at every width (the launch plan,
// ops/ring_attention.py::block_plan, picks it where the kernel above
// would not fill the card, and its split count from the shapes):
//   - a block is 64 query rows: one consumer warpgroup and one producer
//     warp (160 threads, no setmaxnreg), two blocks an SM up to D = 64;
//   - the key tiles a query tile sees, [0, kt_end), are split evenly over
//     the `splits` blocks of one thread-block cluster (at most 8): block s
//     takes [s kt_end / splits, (s + 1) kt_end / splits);
//   - each block leaves its unnormalised o, m and l in its own shared
//     memory (over its K/V stages, done by then); after a cluster barrier
//     block s merges rows [64 s / splits, 64 (s + 1) / splits) of the
//     tile, reading every block's share through distributed shared memory
//     in split order (o = sum_j w_j o_j, l = sum_j w_j l_j, w_j =
//     2^((m_j - m) c)), and a second barrier keeps each block's memory
//     until the last read. No atomics, no workspace, one fixed order of
//     sums: a launch is deterministic. With splits = 1 the block stores
//     from registers. A merge costs ~0.5 us of barriers and reads, so a
//     split pays only where it saves whole key tiles (PERF.md, section 6);
//   - head widths 16 to 256: a box is min(D, 64) columns, its row 32, 64
//     or 128 bytes under the swizzle of that width (TMA's 32-, 64- or
//     128-byte mode and wgmma's layout type 3, 2 or 1), 8 rows of it the
//     stride byte offset. S = Q K^T is D / 16 m64nNk16 steps; P V is
//     m64nDk16 (n16, n32, n64; two n128 at 256). Key tiles of 128 keys
//     (64 at 256, where O takes 128 registers a thread), in 4 stages at
//     16 and 32 (a tile is 4-8 KB) and 2 above (two blocks an SM at 64).
//   - per tile S, its softmax, then P V, waiting on each product, as the
//     kernel above does; the softmax takes its row maxima as trees and each
//     exponent as one FMA (split_softmax). On the card P V behind the next
//     tile's S, two consumer warpgroups taking turns to issue, 64-key
//     tiles, three blocks an SM and a quarter of the exponentials on the
//     FMA pipe each read slower (PERF.md, section 6): a tile is bound by
//     its chain of dependent steps more than by any one unit.

constexpr int kSplitRows = 64;              // query rows a block
constexpr int kSplitThreads = 128 + 32;     // consumer warpgroup, producer
constexpr int kMaxSplits = 8;               // the portable cluster size

template <int D>
struct Split {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "head_dim 16, 32, 64, 128 or 256");
  static constexpr int kCols = D < kHalf ? D : kHalf;   // columns a box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRowBytes = 2 * kCols;           // 32, 64 or 128
  // wgmma's layout type of that swizzle, and 8 swizzled rows' bytes (the
  // stride byte offset of K-major and MN-major tiles alike)
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  static constexpr int kKeys = D > 128 ? 64 : 128;      // keys a tile
  static constexpr int kStages = D <= 32 ? 4 : 2;
  static constexpr int kS = kKeys / 2;                  // S accumulators
  static constexpr int kN = D < 128 ? D : 128;   // columns a P V product
  static constexpr int kChunks = D / kN;         // P V products a tile
  static constexpr int kO = kN / 2;              // O accumulators a product
  static constexpr int kQBox = kSplitRows * kCols;   // elements a Q box
  static constexpr int kKeyBox = kKeys * kCols;      // elements a K/V box
  // row stride of a block's o in shared memory: 8 floats of pad put the 8
  // rows of a store's quads in different banks
  static constexpr int kLd = D + 8;
};

template <int D>
struct alignas(1024) SplitSmem {
  using F = Split<D>;
  bf16 q[F::kBoxes][F::kQBox];
  union {
    struct {
      bf16 k[F::kStages][F::kBoxes][F::kKeyBox];
      bf16 v[F::kStages][F::kBoxes][F::kKeyBox];
    } kv;
    // after the key loop, the block's share (read by the whole cluster)
    // and the merge weights of the rows it merges
    struct {
      float o[kSplitRows][F::kLd];
      float m[kSplitRows];
      float l[kSplitRows];
      float w[kSplitRows][kMaxSplits];
    } part;
  };
  uint64_t q_full;
  uint64_t full[F::kStages];
  uint64_t empty[F::kStages];
};

// wgmma's shared-memory descriptor of a tile swizzled as LAYOUT (1: 128
// bytes, 2: 64, 3: 32); offsets as smem_desc's
template <int LAYOUT>
__device__ __forceinline__ uint64_t swizzled_desc(const void* p,
                                                  uint32_t leading_bytes,
                                                  uint32_t stride_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(leading_bytes >> 4) << 16 |
         static_cast<uint64_t>(stride_bytes >> 4) << 32 |
         static_cast<uint64_t>(LAYOUT) << 62;
}

// S = Q K^T, the block's 64 rows against a tile: D / 16 steps of 16
// head_dim columns (32 bytes into each swizzled row; a 32-byte row is one)
template <int D>
__device__ __forceinline__ void split_scores(float (&s)[Split<D>::kS],
                                             const bf16* q, const bf16* k) {
  using F = Split<D>;
#pragma unroll
  for (int j = 0; j < F::kBoxes; ++j) {
#pragma unroll
    for (int kk = 0; kk < F::kCols / 16; ++kk) {
      wgmma_ss(s,
               swizzled_desc<F::kLayout>(q + j * F::kQBox + kk * 16, 16,
                                         F::kGroupBytes),
               swizzled_desc<F::kLayout>(k + j * F::kKeyBox + kk * 16, 16,
                                         F::kGroupBytes),
               j | kk);
    }
  }
}

// O += P V for the kN columns of V from box v on: 16 keys a wgmma, two
// 8-key groups of swizzled rows; the leading byte offset steps to the next
// box (128-wide products)
template <int D>
__device__ __forceinline__ void split_values(float (&o)[Split<D>::kO],
                                             const uint32_t (&pa)[Split<D>::kS / 2],
                                             const bf16* v) {
  using F = Split<D>;
#pragma unroll
  for (int kk = 0; kk < F::kKeys / 16; ++kk) {
    wgmma_rs(o, pa + 4 * kk,
             swizzled_desc<F::kLayout>(v + kk * 16 * F::kCols,
                                       F::kKeyBox * 2, F::kGroupBytes));
  }
}

// the largest of t[0 .. W), into t[0]: a pairwise tree (a chain of
// log2 W, not W)
template <int W>
__device__ __forceinline__ void max_tree(float* t) {
  if constexpr (W > 1) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) t[i] = fmaxf(t[i], t[i + W / 2]);
    max_tree<W / 2>(t);
  }
}

// softmax_tile's function for the split kernel: the row maxima as trees
// and each exponent one FMA, 2^(s c - m c) (on the card the kernel's time
// at 16-64 is 2.5-3% below softmax_tile's, PERF.md section 6; the
// template keeps softmax_tile)
template <int N>
__device__ __forceinline__ void split_softmax(float (&s)[N], float& m_lo,
                                              float& m_hi, float& l_lo,
                                              float& l_hi, float& alpha_lo,
                                              float& alpha_hi, float c) {
  float t_lo[N / 4], t_hi[N / 4];
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    t_lo[n] = fmaxf(s[4 * n], s[4 * n + 1]);
    t_hi[n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
  }
  max_tree<N / 4>(t_lo);
  max_tree<N / 4>(t_hi);
  float mx_lo = fmaxf(m_lo, t_lo[0]), mx_hi = fmaxf(m_hi, t_hi[0]);
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  alpha_lo = fast_exp2((m_lo - mx_lo) * c);
  alpha_hi = fast_exp2((m_hi - mx_hi) * c);
  m_lo = mx_lo;
  m_hi = mx_hi;
  // a row that has seen no visible key keeps m = -1e30 and adds nothing:
  // its scores, all masked, give p = 0
  const float mc_lo = m_lo > 0.5f * kNegInf ? m_lo * c : 0.f;
  const float mc_hi = m_hi > 0.5f * kNegInf ? m_hi * c : 0.f;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    s[4 * n] = fast_exp2(fmaf(s[4 * n], c, -mc_lo));
    s[4 * n + 1] = fast_exp2(fmaf(s[4 * n + 1], c, -mc_lo));
    s[4 * n + 2] = fast_exp2(fmaf(s[4 * n + 2], c, -mc_hi));
    s[4 * n + 3] = fast_exp2(fmaf(s[4 * n + 3], c, -mc_hi));
    sum_lo += s[4 * n] + s[4 * n + 1];
    sum_hi += s[4 * n + 2] + s[4 * n + 3];
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
}

// every thread of every block of the cluster arrives, then waits: each
// block's shared-memory writes before it are visible to the others after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a shared-memory variable of this block as the same variable in block
// `rank` of the cluster, a generic pointer into distributed shared memory:
// plain loads read it, several in flight at once
template <class T>
__device__ __forceinline__ const T* cluster_ptr(const T* p, int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

// the consumer warpgroup's own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// One launch: B * H * (64-query tiles) * splits blocks, in clusters of
// `splits` (one a query tile). Problem and epilogue as the kernel above's.
template <bool CAUSAL, int D, class Epilogue>
__global__ void __launch_bounds__(kSplitThreads, D <= 64 ? 2 : 1)
attention_fwd_split_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const Problem pr, const Epilogue epi,
                           const int splits) {
  using F = Split<D>;
  constexpr int kKeys = F::kKeys;
  extern __shared__ unsigned char smem_raw[];
  SplitSmem<D>& sm = *reinterpret_cast<SplitSmem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // a cluster is one (batch, head, query tile); query tiles go longest
  // causal rows first, every (batch, head) at each tile
  const int split = blockIdx.x % splits;   // the block's rank in its cluster
  const int cluster = blockIdx.x / splits;
  const int n_q = (pr.Tq + kSplitRows - 1) / kSplitRows;
  const int n_bh = gridDim.x / (splits * n_q);
  const int bh = cluster % n_bh;
  const int q0 = (n_q - 1 - cluster / n_bh) * kSplitRows;
  const int b = bh / pr.H, h = bh % pr.H, hk = h / pr.rep;
  // the key tiles up to the last one holding a key the tile's last row
  // sees, [0, kt_end), and this block's even share of them, [kt0, kt1)
  const int n_k = (pr.Tk + kKeys - 1) / kKeys;
  int kt_end = n_k;
  if (CAUSAL) {
    const long long last_key =
        pr.q_offset + min(q0 + kSplitRows, pr.Tq) - 1 - pr.k_offset;
    kt_end = last_key < 0 ? 0
                          : (int)min((long long)n_k, last_key / kKeys + 1);
  }
  const int kt0 = split * kt_end / splits;
  const int kt1 = (split + 1) * kt_end / splits;
  const int n = kt1 - kt0;   // the block's tiles, i = 0 .. n - 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float c = pr.scale * kLog2e;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one thread issues every load, tile i into stage
    // i % kStages
    if (lane == 0 && n > 0) {
      mbar_expect_tx(&sm.q_full, F::kBoxes * F::kQBox * 2);
#pragma unroll
      for (int j = 0; j < F::kBoxes; ++j) {
        tma_load(sm.q[j], &q_map, &sm.q_full, j * F::kCols, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int stage = i % F::kStages;
        mbar_wait(&sm.empty[stage], ((i / F::kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[stage], 2 * F::kBoxes * F::kKeyBox * 2);
        uint64_t* full = &sm.full[stage];
        const int k0 = (kt0 + i) * kKeys;
#pragma unroll
        for (int j = 0; j < F::kBoxes; ++j) {
          tma_load(sm.kv.k[stage][j], &k_map, full, j * F::kCols, k0, hk, b);
        }
#pragma unroll
        for (int j = 0; j < F::kBoxes; ++j) {
          tma_load(sm.kv.v[stage][j], &v_map, full, j * F::kCols, k0, hk, b);
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: the warpgroup owns the tile's 64 rows
    const int g = lane / 4, t = lane % 4;
    const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
    // the global position of the tile's first row
    const long long first = pr.q_offset + q0;
    // accumulator element i of product ch: row g + 8 * ((i / 2) % 2) of
    // the warp's 16, column ch * kN + 8 * (i / 4) + 2 * t + i % 2
    float o[F::kChunks][F::kO];
#pragma unroll
    for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
      for (int e = 0; e < F::kO; ++e) o[ch][e] = 0.f;
    }
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    if (n > 0) mbar_wait(&sm.q_full, 0);
    // every tile before kt_end holds a key that the tile's last row sees
    for (int i = 0; i < n; ++i) {
      const int stage = i % F::kStages;
      const int k0 = (kt0 + i) * kKeys;
      mbar_wait(&sm.full[stage], (i / F::kStages) & 1);
      float s[F::kS];
      wgmma_fence();
      split_scores<D>(s, sm.q[0], sm.kv.k[stage][0]);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      // mask only a tile that the end of the keys or the diagonal cuts
      const bool cut = k0 + kKeys > pr.Tk ||
                       (CAUSAL && pr.k_offset + k0 + kKeys - 1 > first);
      if (cut) {
#pragma unroll
        for (int e = 0; e < F::kS; ++e) {
          const int col = k0 + 8 * (e / 4) + 2 * t + (e & 1);
          const int row = (e & 2) ? row_hi : row_lo;
          if (!(col < pr.Tk &&
                causal_visible(pr.q_offset + row, pr.k_offset + col,
                               CAUSAL))) {
            s[e] = kNegInf;
          }
        }
      }
      float alpha_lo, alpha_hi;
      split_softmax(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, c);
#pragma unroll
      for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
        for (int e = 0; e < F::kO / 4; ++e) {
          o[ch][4 * e] *= alpha_lo;
          o[ch][4 * e + 1] *= alpha_lo;
          o[ch][4 * e + 2] *= alpha_hi;
          o[ch][4 * e + 3] *= alpha_hi;
        }
      }
      uint32_t pa[F::kS / 2];
#pragma unroll
      for (int e = 0; e < F::kS / 2; ++e) {
        pa[e] = pack_p(s[2 * e], s[2 * e + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < F::kChunks; ++ch) {
        split_values<D>(o[ch], pa, sm.kv.v[stage][ch * (F::kN / F::kCols)]);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < F::kChunks; ++ch) pin(o[ch]);
      pin(pa);
      release(&sm.empty[stage], lane);
    }

    // the quad's row sums; then the rows from registers (one split), or
    // this block's share into its shared memory (the K/V stages are done)
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_hi : row_lo;
      const float m_raw = half ? m_hi : m_lo;
      const float l = half ? l_hi : l_lo;
      if (splits == 1) {
        if (row < pr.Tq) {
          if (t == 0) {
            epi.row_stats(b, h, row,
                          m_raw > 0.5f * kNegInf ? m_raw * pr.scale
                                                 : kNegInf,
                          l);
          }
#pragma unroll
          for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
            for (int e = 0; e < F::kO / 4; ++e) {
              epi.store(b, h, row, ch * F::kN + 8 * e + 2 * t,
                        o[ch][4 * e + 2 * half], o[ch][4 * e + 2 * half + 1]);
            }
          }
        }
      } else {
        const int r = row - q0;
        if (t == 0) {
          sm.part.m[r] = m_raw;
          sm.part.l[r] = l;
        }
#pragma unroll
        for (int ch = 0; ch < F::kChunks; ++ch) {
#pragma unroll
          for (int e = 0; e < F::kO / 4; ++e) {
            *reinterpret_cast<float2*>(
                &sm.part.o[r][ch * F::kN + 8 * e + 2 * t]) =
                make_float2(o[ch][4 * e + 2 * half],
                            o[ch][4 * e + 2 * half + 1]);
          }
        }
      }
    }
  }
  if (splits == 1) return;

  // the merge: this block's rows of the tile from every block's share, in
  // split order
  cluster_sync();
  if (warp < 4) {
    const int r0 = split * kSplitRows / splits;
    const int r1 = (split + 1) * kSplitRows / splits;
    const int tid = threadIdx.x;
    if (tid < r1 - r0) {
      const int r = r0 + tid;
      // every split's m and l of the row (a missing split: no key)
      float mj[kMaxSplits], lj[kMaxSplits];
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        mj[j] = j < splits ? *cluster_ptr(&sm.part.m[r], j) : kNegInf;
        lj[j] = j < splits ? *cluster_ptr(&sm.part.l[r], j) : 0.f;
      }
      float m = kNegInf;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) m = fmaxf(m, mj[j]);
      // a split that saw no key of the row weighs 0 (its o and l are 0)
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        const float w =
            mj[j] > 0.5f * kNegInf ? fast_exp2((mj[j] - m) * c) : 0.f;
        sm.part.w[r][j] = w;
        l += w * lj[j];
      }
      if (q0 + r < pr.Tq) {
        epi.row_stats(b, h, q0 + r,
                      m > 0.5f * kNegInf ? m * pr.scale : kNegInf, l);
      }
    }
    consumers_sync();
    constexpr int kVec = D / 4;   // float4s a row
    for (int i = tid; i < (r1 - r0) * kVec; i += 128) {
      const int r = r0 + i / kVec, col = (i % kVec) * 4;
      const float4* share =
          reinterpret_cast<const float4*>(&sm.part.o[r][col]);
      float4 x[kMaxSplits];
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j < splits) x[j] = *cluster_ptr(share, j);
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j < splits) {
          const float w = sm.part.w[r][j];
          acc.x += w * x[j].x;
          acc.y += w * x[j].y;
          acc.z += w * x[j].z;
          acc.w += w * x[j].w;
        }
      }
      if (q0 + r < pr.Tq) {
        epi.store(b, h, q0 + r, col, acc.x, acc.y);
        epi.store(b, h, q0 + r, col + 2, acc.z, acc.w);
      }
    }
  }
  // no block leaves while another may still read its share
  cluster_sync();
}

// ----------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The TMA map of a bf16 [B, H, T, D] tensor with byte strides (sb, sh,
// st) over (batch, head, sequence) and unit stride over head_dim, read in
// boxes of box_rows rows x box_cols columns (16, 32 or 64), swizzled as
// wide as a box's row (32, 64 or 128 bytes), zeros past the end: past T,
// and past D where the kernel's tiles are wider than the tensor (a head
// width below its class, whose padded columns then add 0 to q k and
// receive 0 from P v).
// Returns 0, a cudaError_t, or kEncodeError + the encoder's CUresult.
inline int encode_map(CUtensorMap* map, const void* base, int B, int H,
                      int T, long long sb, long long sh, long long st,
                      int box_rows, int D, int box_cols = kHalf) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st, (cuuint64_t)sh,
                                 (cuuint64_t)sb};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

inline const char* encode_error_string(int code) {
  return code >= kEncodeError
             ? "cuTensorMapEncodeTiled refused a TMA map (the code less 1000 "
               "is its CUresult)"
             : nullptr;
}

// cudaFuncSetAttribute of a kernel's dynamic shared memory, once a kernel
// and device: `done` (the caller's static, one per kernel instance) holds a
// bit per device already set
inline cudaError_t reserve_smem(const void* kernel, size_t bytes,
                                std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// maps for q [B, H, Tq, cols] and k, v [B, H / rep, Tk, cols] (cols: the
// tensors' head_dim, D or below it), then one launch of B * H * (128-query
// tiles) blocks of the D-wide kernel
template <bool CAUSAL, int D, class Epilogue>
int launch(const void* q, const void* k, const void* v, int B,
           const long long (&sq)[3], const long long (&sk)[3],
           const long long (&sv)[3], const Problem& pr, const Epilogue& epi,
           cudaStream_t stream, int cols = D) {
  CUtensorMap q_map, k_map, v_map;
  const int Hkv = pr.H / pr.rep;
  constexpr int keys = Fwd<D>::kKeys;
  int rc = encode_map(&q_map, q, B, pr.H, pr.Tq, sq[0], sq[1], sq[2], kRows,
                      cols);
  if (rc == 0) {
    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], keys,
                    cols);
  }
  if (rc == 0) {
    rc = encode_map(&v_map, v, B, Hkv, pr.Tk, sv[0], sv[1], sv[2], keys,
                    cols);
  }
  if (rc != 0) return rc;
  auto kernel = attention_fwd_kernel<CAUSAL, D, Epilogue>;
  constexpr size_t smem = fwd_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * pr.H * ((pr.Tq + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      q_map, k_map, v_map, pr, epi);
  return (int)cudaGetLastError();
}

// maps for q (64-row boxes) and k, v (Split<D>::kKeys-row boxes) of
// tensors cols wide (D or below it), boxes min(D, 64) columns wide, then
// one launch of the split kernel: B * H * (64-query tiles) * splits blocks
// in clusters of `splits` (1 to kMaxSplits)
template <bool CAUSAL, int D, class Epilogue>
int launch_split(const void* q, const void* k, const void* v, int B,
                 const long long (&sq)[3], const long long (&sk)[3],
                 const long long (&sv)[3], const Problem& pr,
                 const Epilogue& epi, int splits, cudaStream_t stream,
                 int cols = D) {
  using F = Split<D>;
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  const int Hkv = pr.H / pr.rep;
  int rc = encode_map(&q_map, q, B, pr.H, pr.Tq, sq[0], sq[1], sq[2],
                      kSplitRows, cols, F::kCols);
  if (rc == 0) {
    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], F::kKeys,
                    cols, F::kCols);
  }
  if (rc == 0) {
    rc = encode_map(&v_map, v, B, Hkv, pr.Tk, sv[0], sv[1], sv[2], F::kKeys,
                    cols, F::kCols);
  }
  if (rc != 0) return rc;
  auto kernel = attention_fwd_split_kernel<CAUSAL, D, Epilogue>;
  constexpr size_t smem = sizeof(SplitSmem<D>) + 1024;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * pr.H *
                           ((pr.Tq + kSplitRows - 1) / kSplitRows) * splits;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kSplitThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, q_map, k_map, v_map, pr, epi,
                           splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace
