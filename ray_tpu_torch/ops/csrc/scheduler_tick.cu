// The scheduler tick for Hopper (sm_90a), CUDA C++.
//
// Replaces the XLA device path of ray_tpu/_private/scheduler/kernels.py
// (jitted JAX, no Pallas): the instant-completion tick _make_instant_tick
// (:691, body :707) with _scan_classes (:540) and _assign_class_traced
// (:437); the non-instant tick (:851); the drive loop _make_drive_loop
// (:607) behind jax_drive (:758) and jax_bench (:821); the compacted batch
// assignment jax_assign (:652); and the batched gang pack jax_pack_many
// (:302). Same function as the plain PyTorch versions in
// ray_tpu_torch/_private/scheduler/kernels.py (tick_reference,
// drive_reference, pack_many_reference), integer outputs equal and f32
// avail equal to the bit.
//
//   state int8 [C] (0 FREE, 1 WAITING, 3 RUNNING, 4 DONE), indeg, cls, pin
//   int32 [C], demands f32 [K, R], avail / cap f32 [N, R], src / dst int32
//   [E], consumed bool [E]; class_mask bool [K, N] and class_spread bool
//   [K] (batch assignment only).
//
// Bound: bytes. A tick reads each task's state, indegree, pin and class
// and each edge's ends and flag, and writes states, indegrees and flags:
// 18 bytes a task and 10 an edge, a few integer operations each. At the
// 1M-task fan-out that is 18 MB, 5.4 us at 3.35 TB/s. What bounds it in
// practice is the chain of dependent launches (3 or 4 a tick) and the one
// block that plans the assignment; the drive captures its ticks in one
// CUDA graph so that the host is out of the loop.
//
// Design. One tick is four kernels, in stream order:
//   (a) sched_ready_kernel over the tasks: ready = WAITING & indeg <= 0;
//       pinned ready tasks become RUNNING on their pin; each warp counts
//       its unpinned ready tasks per class (a "scan unit" of 512 tasks,
//       lane-striped so that index order is (item, lane) order) with
//       __match_any_sync, the leader of each class group adding to the
//       warp's counters in shared memory. It also flags whether any task
//       is WAITING, for the drive's loop condition.
//   (b) sched_plan_kernel, one block: for each class in class order (the
//       reference's lax.scan), an exclusive scan of the units' counts gives
//       each unit its first rank; then per node (one thread each) fit,
//       capacity check, liveness and load; node 0's share t0 under the
//       hybrid threshold; a stable rank sort of the loads; the segment
//       counts (or, for a SPREAD class, the water-fill of round-robin
//       rounds) and their inclusive sum cum[0..N]; the tasks each node
//       received, and avail -= per_node * d. The instant tick hands it all
//       back: avail = min(avail + release, cap).
//   (c) sched_assign_kernel over the tasks: a task's rank in its class is
//       its unit's first rank plus its rank in the unit (the same match
//       loop); seg = #{j : cum[j] <= rank}, a binary search over the N + 1
//       values (the reference's searchsorted, scatter and cumsum compute
//       the same count); the task goes to seq_nodes[seg] and becomes
//       RUNNING (DONE in the instant tick, as does every RUNNING task).
//   (d) sched_edge_kernel over the edges (instant tick): an edge whose
//       source is DONE and that has not fired decrements its destination's
//       indegree by an integer atomic and is marked consumed. The result
//       does not depend on the atomics' order, so dst need not be sorted.
// The drive launches max_ticks ticks into the caller's stream (one CUDA
// graph when captured). Control words at the head of the workspace carry
// the loop: the plan kernel of a tick runs it only if the drive has not
// stopped and the ready pass saw a WAITING task, counts it, and otherwise
// stops the drive; every kernel of a stopped drive returns at once. So the
// count of ticks equals the reference's while_loop count, and the ticks
// left over cost one near-empty launch per kernel.
//
// Exactness. All f32 arithmetic is written with round-to-nearest
// intrinsics (__fdiv_rn, __fmul_rn, __fsub_rn, __fadd_rn), so nothing is
// contracted into an FMA, and floor(avail / d) divides in IEEE; the
// threshold is an f32, as JAX's weak typing makes it. Counts and ranks are
// int32 (the wrapper keeps C < 2^24, so every count is exact in f32 too).
// Per-node sums go in class order in one thread: no float atomics. The
// only atomics are the edge pass's integer decrements.
//
// sched_pack_kernel: one block, one thread per node. Groups and bundles go
// in order; a bundle takes the first node (lowest index) that is alive,
// fits it and, under strict spread, has no bundle of the group yet: a
// ballot per warp, __ffs, the least over warps. A group commits its trial
// consumption only if every bundle found a node; otherwise its bundles
// read -1.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWaiting = 1, kRunning = 3, kDone = 4;
constexpr int kWarps = 8;                    // warps a block, task passes
constexpr int kItems = 16;                   // tasks a lane
constexpr int kUnit = 32 * kItems;           // tasks a warp: a scan unit
constexpr int kTaskThreads = 32 * kWarps;
constexpr int kBlockTasks = kWarps * kUnit;
constexpr int kPlanThreads = 1024;
constexpr int kMaxNodes = 1024;
constexpr int kMaxClasses = 1024;
constexpr int kEdgeThreads = 256;
constexpr int kEdgeItems = 4;
constexpr unsigned kFull = 0xffffffffu;

// control words at the head of the workspace: reset to 0 before a run,
// except kTotalTicks, which sums the ticks of every run on the workspace
enum { kStopped = 0, kTicks = 1, kWaitingFlag = 2, kTotalTicks = 4,
       kCtrlInts = 8 };

struct Layout {
  size_t units, counts, cum, seqn, release, total;   // in 4-byte words
};

Layout layout(int C, int N, int R, int K) {
  Layout L;
  L.units = (size_t)((C + kBlockTasks - 1) / kBlockTasks) * kWarps;
  L.counts = kCtrlInts;
  L.cum = L.counts + L.units * K;
  L.seqn = L.cum + (size_t)K * (N + 1);
  L.release = L.seqn + (size_t)K * (N + 1);
  L.total = L.release + (size_t)N * R;
  return L;
}

// (a) the ready set, pins, per-unit class counts, the WAITING flag
__global__ void __launch_bounds__(kTaskThreads) sched_ready_kernel(
    int8_t* __restrict__ state, const int* __restrict__ indeg,
    const int* __restrict__ cls, const int* __restrict__ pin,
    int* __restrict__ node_of, int* __restrict__ counts,
    int* __restrict__ ctrl, int C, int K) {
  extern __shared__ int warp_counts[];
  if (ctrl[kStopped]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t unit = (size_t)blockIdx.x * kWarps + warp;
  int* wc = warp_counts + warp * K;
  for (int c = lane; c < K; c += 32) wc[c] = 0;
  __syncwarp();
  bool waiting = false;
  for (int j = 0; j < kItems; ++j) {
    const size_t i = unit * kUnit + j * 32 + lane;
    int c = -1;
    if (i < (size_t)C) {
      bool ready = false;
      int p = -1;
      if (state[i] == kWaiting) {
        waiting = true;
        ready = indeg[i] <= 0;
      }
      if (ready) {
        p = pin[i];
        if (p >= 0) {
          state[i] = kRunning;
        } else {
          c = cls[i];
        }
      }
      if (node_of != nullptr) node_of[i] = p >= 0 ? p : -1;
    }
    const bool member = c >= 0 && c < K;
    const unsigned members = __ballot_sync(kFull, member);
    if (member) {
      const unsigned group = __match_any_sync(members, c);
      if (lane == __ffs(group) - 1) wc[c] += __popc(group);
    }
    __syncwarp();
  }
  for (int c = lane; c < K; c += 32) counts[unit * K + c] = wc[c];
  if (__syncthreads_or(waiting) && threadIdx.x == 0) {
    atomicOr(&ctrl[kWaitingFlag + (ctrl[kTicks] & 1)], 1);
  }
}

// exclusive sum over the block (kPlanThreads threads); total = the sum
__device__ __forceinline__ int block_exclusive_sum(int v, int* tmp,
                                                  int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarpsPlan = kPlanThreads / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarpsPlan ? tmp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? tmp[warp - 1] : 0;
  total = tmp[kWarpsPlan - 1];
  __syncthreads();   // tmp is reused by the next call
  return before + x - v;
}

// (b) the plan of every class, in class order, and avail; one block
// (one block: up to 64 registers a thread, not the 32 of two blocks an SM)
__global__ void __launch_bounds__(kPlanThreads, 1) sched_plan_kernel(
    int* __restrict__ ctrl, int* __restrict__ counts,
    const float* __restrict__ demands, float* __restrict__ avail,
    const float* __restrict__ cap, float* __restrict__ release,
    const uint8_t* __restrict__ class_mask,
    const uint8_t* __restrict__ class_spread, int* __restrict__ cum_out,
    int* __restrict__ seqn_out, int U, int N, int R, int K, int batch_cap,
    float threshold, int instant, int gated) {
  __shared__ float load[kMaxNodes];
  __shared__ int fit[kMaxNodes], order[kMaxNodes], pos[kMaxNodes];
  __shared__ int seqc[kMaxNodes + 1], cum[kMaxNodes + 1];
  __shared__ unsigned char elig[kMaxNodes];
  __shared__ int scan_tmp[32];
  __shared__ int run_t0[2];
  const int t = threadIdx.x;
  if (t == 0) {
    const int run = !ctrl[kStopped] &&
                    (!gated || ctrl[kWaitingFlag + (ctrl[kTicks] & 1)]);
    if (run) {
      const int ticks = ctrl[kTicks] + 1;
      ctrl[kTicks] = ticks;
      ctrl[kTotalTicks] += 1;
      ctrl[kWaitingFlag + (ticks & 1)] = 0;   // for the next ready pass
    } else {
      ctrl[kStopped] = 1;
    }
    run_t0[0] = run;
  }
  __syncthreads();
  if (!run_t0[0]) return;

  const bool node = t < N;
  float* my_avail = avail + (size_t)t * R;
  float* my_release = release + (size_t)t * R;
  bool alive = false;
  if (node) {
    for (int r = 0; r < R; ++r) {
      alive |= cap[(size_t)t * R + r] > 0.f;
      if (instant) my_release[r] = 0.f;
    }
  }
  for (int c = 0; c < K; ++c) {
    // the class's members before each unit, and k = all of them
    int k = 0;
    for (int u0 = 0; u0 < U; u0 += kPlanThreads) {
      const int u = u0 + t;
      const int v = u < U ? counts[(size_t)u * K + c] : 0;
      int sum;
      const int before = block_exclusive_sum(v, scan_tmp, sum);
      if (u < U) counts[(size_t)u * K + c] = k + before;
      k += sum;
    }
    const float* d = demands + (size_t)c * R;
    bool any_active = false;
    for (int r = 0; r < R; ++r) any_active |= d[r] > 0.f;
    const bool spread = class_spread != nullptr && class_spread[c];

    // per node: fit (tasks it can take now), eligibility, load
    if (node) {
      float fit_f = INFINITY, ld = 0.f;
      bool cap_ok = true;
      for (int r = 0; r < R; ++r) {
        const float a = my_avail[r], cp = cap[(size_t)t * R + r];
        if (d[r] > 0.f) {
          fit_f = fminf(fit_f, floorf(__fdiv_rn(a, d[r])));
          cap_ok &= cp >= d[r];
        }
        const float v = cp > 0.f ? __fdiv_rn(__fsub_rn(cp, a),
                                             fmaxf(cp, 1e-9f))
                                 : 0.f;
        ld = r == 0 ? v : fmaxf(ld, v);
      }
      const bool el = alive && (class_mask == nullptr ||
                                class_mask[(size_t)c * N + t]);
      fit_f = any_active ? fmaxf(fit_f, 0.f) : INFINITY;
      fit_f = cap_ok && el ? fit_f : 0.f;
      fit[t] = (int)fminf(fit_f, (float)batch_cap);
      load[t] = ld;
      elig[t] = el;
    }
    __syncthreads();

    // node 0's share under the hybrid threshold; a stable sort of loads
    if (t == 0) {
      float room0 = INFINITY;
      for (int r = 0; r < R; ++r) {
        if (d[r] > 0.f) {
          const float used0 = __fsub_rn(cap[r], my_avail[r]);
          room0 = fminf(room0, floorf(__fdiv_rn(
              __fsub_rn(__fmul_rn(threshold, cap[r]), used0), d[r])));
        }
      }
      const bool under = load[0] < threshold;
      float t0 = any_active ? fminf(fmaxf(room0, 0.f), (float)fit[0])
                            : (under ? (float)k : 0.f);
      if (!(fit[0] > 0 || !any_active) || !under || !elig[0]) t0 = 0.f;
      run_t0[1] = spread ? 0 : (int)t0;
    }
    if (node) {
      const float mine = load[t];
      int p = 0;
      for (int m = 0; m < N; ++m) {
        const float other = load[m];
        p += other < mine || (other == mine && m < t);
      }
      pos[t] = p;
      order[p] = t;
    }
    __syncthreads();

    // segments: node 0's share first, then every node by load
    const int t0 = run_t0[1];
    if (t <= N) {
      if (t == 0) {
        seqc[0] = t0;
      } else {
        const int n = order[t - 1];
        seqc[t] = fit[n] - (n == 0 ? t0 : 0);
      }
    }
    __syncthreads();
    if (t == 0) {
      if (spread) {
        // round-robin counts: the most full rounds lo every node can take
        // within k tasks, then one more for the first nodes with room
        int sum_fit = 0;
        for (int i = 0; i < N; ++i) sum_fit += fit[order[i]];
        const int k_tasks = min(k, sum_fit);
        int lo = 0, hi = batch_cap;
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          int s = 0;
          for (int i = 0; i < N; ++i) s += min(fit[order[i]], mid);
          if (s <= k_tasks) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        int base = 0;
        for (int i = 0; i < N; ++i) base += min(fit[order[i]], lo);
        const int left = k_tasks - base;
        int more = 0;
        seqc[0] = 0;
        for (int i = 0; i < N; ++i) {
          const int f = fit[order[i]];
          more += f > lo;
          seqc[i + 1] = min(f, lo) + (f > lo && more <= left);
        }
      }
      int s = 0;
      for (int j = 0; j <= N; ++j) {
        s += seqc[j];
        cum[j] = s;
      }
    }
    __syncthreads();

    // the tasks each node received; avail (and release) per node
    if (t <= N) {
      cum_out[(size_t)c * (N + 1) + t] = cum[t];
      seqn_out[(size_t)c * (N + 1) + t] = t == 0 ? 0 : order[t - 1];
    }
    if (node) {
      const int k_eff = min(k, cum[N]);
      const int p = pos[t] + 1;
      int got = min(cum[p], k_eff) - min(cum[p - 1], k_eff);
      if (t == 0) got += min(cum[0], k_eff);
      const float per_node = (float)got;
      for (int r = 0; r < R; ++r) {
        const float take = __fmul_rn(per_node, d[r]);
        my_avail[r] = __fsub_rn(my_avail[r], take);
        if (instant) my_release[r] = __fadd_rn(my_release[r], take);
      }
    }
    __syncthreads();
  }
  if (node && instant) {
    for (int r = 0; r < R; ++r) {
      my_avail[r] = fminf(__fadd_rn(my_avail[r], my_release[r]),
                          cap[(size_t)t * R + r]);
    }
  }
}

// (c) ranks, segments, chosen nodes and states
__global__ void __launch_bounds__(kTaskThreads) sched_assign_kernel(
    int8_t* __restrict__ state, const int* __restrict__ indeg,
    const int* __restrict__ cls, const int* __restrict__ pin,
    int* __restrict__ node_of, const int* __restrict__ first_rank,
    const int* __restrict__ cum, const int* __restrict__ seqn,
    const int* __restrict__ ctrl, int C, int N, int K, int instant) {
  extern __shared__ int warp_rank[];
  if (ctrl[kStopped]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t unit = (size_t)blockIdx.x * kWarps + warp;
  int* wr = warp_rank + warp * K;
  for (int c = lane; c < K; c += 32) wr[c] = first_rank[unit * K + c];
  __syncwarp();
  for (int j = 0; j < kItems; ++j) {
    const size_t i = unit * kUnit + j * 32 + lane;
    int s = 0, c = -1;
    if (i < (size_t)C) {
      s = state[i];
      if (s == kWaiting && indeg[i] <= 0 && pin[i] < 0) c = cls[i];
    }
    int next = s;
    const bool member = c >= 0 && c < K;
    const unsigned members = __ballot_sync(kFull, member);
    if (member) {
      const unsigned group = __match_any_sync(members, c);
      const int leader = __ffs(group) - 1;
      int first = 0;
      if (lane == leader) {
        first = wr[c];
        wr[c] = first + __popc(group);
      }
      first = __shfl_sync(group, first, leader);
      const int rank = first + __popc(group & ((1u << lane) - 1u));
      const int* cc = cum + (size_t)c * (N + 1);
      if (rank < __ldg(cc + N)) {
        int lo = 0, hi = N + 1;   // the first j with cum[j] > rank
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(cc + mid) <= rank) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (node_of != nullptr) {
          node_of[i] = __ldg(seqn + (size_t)c * (N + 1) + lo);
        }
        next = instant ? kDone : kRunning;
      }
    }
    if (instant && s == kRunning) next = kDone;
    if (next != s) state[i] = (int8_t)next;
    __syncwarp();
  }
}

// (d) the completion wave over the edges
__global__ void __launch_bounds__(kEdgeThreads) sched_edge_kernel(
    const int8_t* __restrict__ state, int* __restrict__ indeg,
    const int* __restrict__ src, const int* __restrict__ dst,
    uint8_t* __restrict__ consumed, const int* __restrict__ ctrl, int E) {
  if (ctrl[kStopped]) return;
  const size_t base = (size_t)blockIdx.x * kEdgeThreads * kEdgeItems +
                      threadIdx.x;
  for (int j = 0; j < kEdgeItems; ++j) {
    const size_t e = base + (size_t)j * kEdgeThreads;
    if (e < (size_t)E && !consumed[e] && state[src[e]] == kDone) {
      atomicSub(&indeg[dst[e]], 1);
      consumed[e] = 1;
    }
  }
}

// batched gang pack: one block, one thread per node
__global__ void __launch_bounds__(kMaxNodes) sched_pack_kernel(
    const float* __restrict__ demands, float* __restrict__ rem,
    const float* __restrict__ cap, float* __restrict__ trial,
    int* __restrict__ node_of, uint8_t* __restrict__ ok, int G, int B,
    int N, int R, int strict_spread) {
  __shared__ int first[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const bool node = t < N;
  float* my_rem = rem + (size_t)t * R;
  float* my_trial = trial + (size_t)t * R;
  bool alive = false;
  if (node) {
    for (int r = 0; r < R; ++r) alive |= cap[(size_t)t * R + r] > 0.f;
  }
  for (int g = 0; g < G; ++g) {
    if (node) {
      for (int r = 0; r < R; ++r) my_trial[r] = my_rem[r];
    }
    bool used = false, good = true;
    for (int b = 0; b < B && good; ++b) {
      const float* d = demands + ((size_t)g * B + b) * R;
      bool fits = node && alive && !(strict_spread && used);
      for (int r = 0; fits && r < R; ++r) fits = my_trial[r] >= d[r];
      const unsigned ballot = __ballot_sync(kFull, fits);
      if (lane == 0) first[warp] = ballot ? warp * 32 + __ffs(ballot) - 1
                                          : INT_MAX;
      __syncthreads();
      int chosen = INT_MAX;
      for (int w = 0; w < warps; ++w) chosen = min(chosen, first[w]);
      __syncthreads();
      if (chosen == INT_MAX) {
        good = false;
      } else {
        if (t == chosen) {
          for (int r = 0; r < R; ++r) my_trial[r] = __fadd_rn(my_trial[r],
                                                              -d[r]);
          used = true;
        }
        if (t == 0) node_of[(size_t)g * B + b] = chosen;
      }
    }
    if (good && node) {
      for (int r = 0; r < R; ++r) my_rem[r] = my_trial[r];
    }
    __syncthreads();
    if (!good) {
      for (int b = t; b < B; b += blockDim.x) node_of[(size_t)g * B + b] = -1;
    }
    if (t == 0) ok[g] = good;
  }
}

cudaError_t copy(void* to, const void* from, size_t bytes,
                 cudaStream_t s) {
  if (from == nullptr || bytes == 0) return cudaSuccess;
  return cudaMemcpyAsync(to, from, bytes, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

// 4-byte words of workspace sched_run needs for these sizes
extern "C" long long sched_workspace_words(int C, int N, int R, int K) {
  return (long long)layout(C, N, R, K).total;
}

// Up to max_ticks ticks on `stream`. state0, indeg0, avail0, consumed0
// (each may be null) are first copied into state, indeg, avail, consumed,
// which the ticks then update in place. node_of (null: not written) gets
// each task's node of the last tick, -1 where none; class_mask and
// class_spread may be null. gated: stop at the first tick that starts
// with no WAITING task (the drive); else every tick runs. The workspace
// (sched_workspace_words) must be zeroed once when allocated; its word 1
// then holds the ticks this run made and word 4 the ticks of every run.
// Returns the first failed call's cudaError_t, else 0.
extern "C" int sched_run(
    const void* state0, const void* indeg0, const void* avail0,
    const void* consumed0, void* state, void* indeg, void* avail,
    void* consumed, const void* cls, const void* pin, const void* demands,
    const void* cap, const void* src, const void* dst, void* node_of,
    const void* class_mask, const void* class_spread, void* work, int C,
    int E, int N, int R, int K, int batch_cap, float threshold, int instant,
    int max_ticks, int gated, int device, void* stream) {
  if (C < 0 || E < 0 || N < 1 || N > kMaxNodes || R < 1 || K < 1 ||
      K > kMaxClasses || batch_cap < 0 || max_ticks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(C, N, R, K);
  int* w = static_cast<int*>(work);
  const size_t nr = (size_t)N * R * sizeof(float);
  if ((err = copy(state, state0, (size_t)C, s)) != cudaSuccess ||
      (err = copy(indeg, indeg0, (size_t)C * 4, s)) != cudaSuccess ||
      (err = copy(avail, avail0, nr, s)) != cudaSuccess ||
      (err = copy(consumed, consumed0, (size_t)E, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(w, 0, 4 * sizeof(int), s)) != cudaSuccess) {
    return (int)err;
  }
  auto* st = static_cast<int8_t*>(state);
  auto* in = static_cast<int*>(indeg);
  auto* cl = static_cast<const int*>(cls);
  auto* pn = static_cast<const int*>(pin);
  auto* no = static_cast<int*>(node_of);
  const int task_blocks = (C + kBlockTasks - 1) / kBlockTasks;
  const size_t task_smem = (size_t)kWarps * K * sizeof(int);
  const int edge_blocks = (int)(((size_t)E + kEdgeThreads * kEdgeItems - 1) /
                                (kEdgeThreads * kEdgeItems));
  for (int tick = 0; tick < max_ticks; ++tick) {
    if (task_blocks > 0) {
      sched_ready_kernel<<<task_blocks, kTaskThreads, task_smem, s>>>(
          st, in, cl, pn, no, w + L.counts, w, C, K);
    }
    sched_plan_kernel<<<1, kPlanThreads, 0, s>>>(
        w, w + L.counts, static_cast<const float*>(demands),
        static_cast<float*>(avail), static_cast<const float*>(cap),
        reinterpret_cast<float*>(w + L.release),
        static_cast<const uint8_t*>(class_mask),
        static_cast<const uint8_t*>(class_spread), w + L.cum, w + L.seqn,
        (int)L.units, N, R, K, batch_cap, threshold, instant, gated);
    if (task_blocks > 0) {
      sched_assign_kernel<<<task_blocks, kTaskThreads, task_smem, s>>>(
          st, in, cl, pn, no, w + L.counts, w + L.cum, w + L.seqn, w, C, N,
          K, instant);
    }
    if (instant && edge_blocks > 0) {
      sched_edge_kernel<<<edge_blocks, kEdgeThreads, 0, s>>>(
          st, in, static_cast<const int*>(src),
          static_cast<const int*>(dst), static_cast<uint8_t*>(consumed), w,
          E);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// G groups of B bundles (demands f32 [G, B, R]) packed in order against
// one node state: rem [N, R] is updated in place (the caller copies avail
// into it), trial is a workspace of N * R floats; node_of int32 [G, B],
// ok bool [G]. Returns the launch's cudaError_t.
extern "C" int sched_pack(const void* demands, void* rem, const void* cap,
                          void* trial, void* node_of, void* ok, int G, int B,
                          int N, int R, int strict_spread, int device,
                          void* stream) {
  if (G < 0 || B < 1 || N < 1 || N > kMaxNodes || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return 0;
  const int threads = (N + 31) / 32 * 32;
  sched_pack_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demands), static_cast<float*>(rem),
      static_cast<const float*>(cap), static_cast<float*>(trial),
      static_cast<int*>(node_of), static_cast<uint8_t*>(ok), G, B, N, R,
      strict_spread);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
