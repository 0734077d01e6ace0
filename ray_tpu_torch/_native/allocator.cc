// Arena free-list allocator — the native core of the shm object store.
//
// Reference role: plasma's dlmalloc-based shared-memory allocator
// (ray: src/ray/object_manager/plasma/ — PlasmaAllocator over dlmalloc).
// Here: an offset allocator for one mmap arena (the store hands out
// offsets, never pointers), first-fit over an ordered free map with
// O(log n) coalescing on free. Exposed as a C ABI for ctypes; its plain
// version is shm_store.PyFreeList, with identical first-fit semantics
// (parity-tested). Host code, built with g++ at first use by
// ray_tpu_torch/_native/__init__.py into ray_tpu_torch/_build/.

#include <cstdint>
#include <map>
#include <mutex>

namespace {

struct Arena {
  // free blocks: offset -> size, ordered by offset (coalescing needs
  // neighbor lookup; first-fit walks in offset order like the Python
  // fallback so both pick identical blocks)
  std::map<uint64_t, uint64_t> free_blocks;
  uint64_t align;
  uint64_t total;
  std::mutex mu;

  uint64_t round(uint64_t n) const {
    if (n < align) n = align;
    return (n + align - 1) & ~(align - 1);
  }
};

}  // namespace

extern "C" {

void* arena_create(uint64_t size, uint64_t align) {
  auto* a = new Arena();
  a->align = align ? align : 64;
  a->total = size;
  a->free_blocks.emplace(0, size);
  return a;
}

void arena_destroy(void* handle) { delete static_cast<Arena*>(handle); }

// Returns the allocated offset, or -1 when no hole fits (caller decides
// eviction/spill policy — the allocator only does arithmetic).
int64_t arena_alloc(void* handle, uint64_t nbytes) {
  auto* a = static_cast<Arena*>(handle);
  nbytes = a->round(nbytes);
  std::lock_guard<std::mutex> g(a->mu);
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= nbytes) {
      uint64_t off = it->first;
      uint64_t sz = it->second;
      a->free_blocks.erase(it);
      if (sz > nbytes) {
        a->free_blocks.emplace(off + nbytes, sz - nbytes);
      }
      return static_cast<int64_t>(off);
    }
  }
  return -1;
}

// Returns 0 on success, -1 on a detectably invalid free (overlap with an
// existing hole), in which case the free list is left unchanged.
int arena_free(void* handle, uint64_t offset, uint64_t nbytes) {
  auto* a = static_cast<Arena*>(handle);
  nbytes = a->round(nbytes);
  std::lock_guard<std::mutex> g(a->mu);
  auto next = a->free_blocks.lower_bound(offset);
  // overlap checks against both neighbors
  if (next != a->free_blocks.end() && offset + nbytes > next->first) {
    return -1;
  }
  if (next != a->free_blocks.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second > offset) {
      return -1;
    }
  }
  uint64_t new_off = offset;
  uint64_t new_sz = nbytes;
  // coalesce with the following hole
  if (next != a->free_blocks.end() && offset + nbytes == next->first) {
    new_sz += next->second;
    next = a->free_blocks.erase(next);
  }
  // coalesce with the preceding hole
  if (next != a->free_blocks.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second == new_off) {
      new_off = prev->first;
      new_sz += prev->second;
      a->free_blocks.erase(prev);
    }
  }
  a->free_blocks.emplace(new_off, new_sz);
  return 0;
}

uint64_t arena_free_bytes(void* handle) {
  auto* a = static_cast<Arena*>(handle);
  std::lock_guard<std::mutex> g(a->mu);
  uint64_t total = 0;
  for (auto& kv : a->free_blocks) total += kv.second;
  return total;
}

uint64_t arena_num_holes(void* handle) {
  auto* a = static_cast<Arena*>(handle);
  std::lock_guard<std::mutex> g(a->mu);
  return a->free_blocks.size();
}

}  // extern "C"
