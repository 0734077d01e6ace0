// Shuffle-exchange kernels: seeded pseudo-random-permutation (PRP)
// index generation fused with column gathers.
//
// Role of the reference's C++ exchange internals (ray:
// src/ray/object_manager + python/ray/data/_internal/execution push
// shuffle): the hot per-row work of a distributed shuffle. Here the
// permutation is DERIVED, not materialized: a 4-round Feistel network
// over the smallest even-bit power-of-two domain covering n,
// cycle-walked back into [0, n). Any slice of the permutation can be
// computed independently, so mappers and reducers generate exactly the
// rows they need with no shared state. Fusing sigma(t) into the gather
// loop removes the index-array pass entirely; the loop is then bound
// by gather load latency, which stays cache-local because callers only
// ever gather within one block's footprint.

#include <cstdint>
#include <cstring>

namespace {

struct Prp {
  uint32_t half, mask, shift;
  uint32_t keys[4];
  uint64_t n;
};

inline void prp_init(Prp &p, uint64_t n, const uint32_t *keys) {
  int k = 4;
  while ((1ull << k) < n) ++k;
  k += k & 1;
  p.half = static_cast<uint32_t>(k / 2);
  p.mask = (1u << (k / 2)) - 1u;
  int sh = k / 2 - 3;
  if (sh < 1) sh = 1;
  p.shift = static_cast<uint32_t>(sh);
  p.n = n;
  for (int i = 0; i < 4; ++i) p.keys[i] = keys[i];
}

inline uint64_t prp_apply(const Prp &p, uint64_t x) {
  do {  // cycle-walk: re-encrypt until the value lands inside [0, n)
    uint32_t L = static_cast<uint32_t>(x >> p.half);
    uint32_t R = static_cast<uint32_t>(x & p.mask);
    for (int r = 0; r < 4; ++r) {
      uint32_t F = (((R * 0x9E3779B1u) + p.keys[r]) >> p.shift) & p.mask;
      uint32_t nL = R;
      R = L ^ F;
      L = nL;
    }
    x = (static_cast<uint64_t>(L) << p.half) | R;
  } while (x >= p.n);
  return x;
}

template <typename T>
void gather(const T *src, T *dst, uint64_t lo, uint64_t hi, uint64_t n,
            const uint32_t *keys) {
  Prp p;
  prp_init(p, n, keys);
  for (uint64_t t = lo; t < hi; ++t) *dst++ = src[prp_apply(p, t)];
}

}  // namespace

extern "C" {

// dst[t - lo] = src[sigma(t)] for fixed-width elements (1/2/4/8 bytes)
void prp_gather(const void *src, void *dst, uint32_t elem, uint64_t lo,
                uint64_t hi, uint64_t n, const uint32_t *keys) {
  switch (elem) {
    case 1: gather(static_cast<const uint8_t *>(src),
                   static_cast<uint8_t *>(dst), lo, hi, n, keys); return;
    case 2: gather(static_cast<const uint16_t *>(src),
                   static_cast<uint16_t *>(dst), lo, hi, n, keys); return;
    case 4: gather(static_cast<const uint32_t *>(src),
                   static_cast<uint32_t *>(dst), lo, hi, n, keys); return;
    case 8: gather(static_cast<const uint64_t *>(src),
                   static_cast<uint64_t *>(dst), lo, hi, n, keys); return;
    default: {  // arbitrary width
      Prp p;
      prp_init(p, n, keys);
      const char *s = static_cast<const char *>(src);
      char *d = static_cast<char *>(dst);
      for (uint64_t t = lo; t < hi; ++t) {
        std::memcpy(d, s + prp_apply(p, t) * elem, elem);
        d += elem;
      }
    }
  }
}

// indices only — for columns the caller must gather via Arrow take
// (strings, nulls); still saves the vectorized-Feistel temp traffic
void prp_indices(int64_t *dst, uint64_t lo, uint64_t hi, uint64_t n,
                 const uint32_t *keys) {
  Prp p;
  prp_init(p, n, keys);
  for (uint64_t t = lo; t < hi; ++t)
    *dst++ = static_cast<int64_t>(prp_apply(p, t));
}

}  // extern "C"
