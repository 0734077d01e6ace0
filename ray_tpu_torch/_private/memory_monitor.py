"""Memory monitor — kill-and-retry under host memory pressure.

Reference surface: the memory monitor (ray: src/ray/common/
memory_monitor.h + python/ray/_private/memory_monitor.py — when node
memory use crosses a threshold, the raylet kills the most recently
started retriable task with a retriable OutOfMemoryError instead of
letting the OS OOM-killer take the whole node).

Here: a driver thread samples /proc/meminfo; past the threshold it
evicts the MOST RECENTLY STARTED running task (last-in-first-killed —
the reference's policy, preserving the oldest/most-completed work):
process-mode victims are killed at the process level and fail with
OutOfMemoryError (retriable per TaskManager.should_retry). Thread-mode
tasks are NOT evicted (a thread cannot be forced to release memory, and
a cooperative cancel would mislabel the failure); pressure is logged —
process workers are the enforcement path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Tuple

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)


def host_memory() -> Tuple[int, int]:
    """(used_bytes, total_bytes) from /proc/meminfo — the profile
    plane's shared parser (one /proc reader for the monitor, the
    utilization sampler, and anything else that needs host memory)."""
    from ray_tpu_torch._private.profile_plane import read_meminfo

    return read_meminfo()


class MemoryMonitor:
    def __init__(self, worker, threshold: Optional[float] = None,
                 interval_s: Optional[float] = None):
        self._worker = worker
        self._threshold = (threshold if threshold is not None
                           else GLOBAL_CONFIG.memory_usage_threshold)
        self._interval = (interval_s if interval_s is not None
                          else GLOBAL_CONFIG.memory_monitor_interval_s)
        self._shutdown = threading.Event()
        self.num_kills = 0
        self._last_kill = float("-inf")
        self._thread: Optional[threading.Thread] = None
        if 0 < self._threshold < 1.0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ray_tpu_memmon")
            self._thread.start()

    def _loop(self) -> None:
        while not self._shutdown.wait(self._interval):
            # the guard is the point: an exception here must never
            # silently disable OOM protection for the process lifetime
            try:
                used, total = host_memory()
                if total and used / total >= self._threshold:
                    self._evict(used, total)
            except Exception:
                logger.exception("memory monitor tick failed; retrying")

    def _evict(self, used: int, total: int) -> None:
        # cooldown: a SIGKILLed process needs time to be reaped and its
        # memory reclaimed; firing every poll would wipe every in-flight
        # task (and burn the victim's retries) during one spike
        now = time.monotonic()
        if now - self._last_kill < max(1.0, 4 * self._interval):
            return
        victim = self._pick_victim()
        if victim is None:
            return
        task_id, kill = victim
        logger.warning(
            "memory monitor: host at %.0f%% (>= %.0f%%); killing most "
            "recent task %s with retriable OutOfMemoryError",
            100 * used / total, 100 * self._threshold,
            task_id.hex()[:16])
        self.num_kills += 1
        self._last_kill = now
        kill()

    def _pick_victim(self):
        """Most recently started running task (process-mode first: a
        killed process actually frees memory)."""
        w = self._worker
        pools = list(w._node_pools.values())
        if w.process_pool is not None and w.process_pool not in pools:
            pools.append(w.process_pool)
        newest = None
        for pool in pools:
            if getattr(pool, "is_remote", False):
                continue  # remote workers don't consume HEAD host memory
            with pool._lock:
                handles = list(pool._handles)
                for h in handles:
                    if h.dead or not h.inflight:
                        continue
                    # newest LEASE on this worker (the last pipelined task)
                    exec_id, inf = next(reversed(h.inflight.items()))
                    if newest is None or inf.started_at > newest[0]:
                        newest = (inf.started_at, h, exec_id)
        if newest is not None:
            _, h, exec_id = newest

            def kill(h=h):
                h.oom_kill = True
                try:
                    h.proc.kill()
                except Exception:
                    pass

            return exec_id, kill
        # thread mode: a thread cannot be forced to release memory, and
        # the cooperative cancel flag would surface as a NON-retriable
        # TaskCancelledError (or do nothing once user code is running) —
        # log the pressure instead of mislabeling an eviction
        with w._running_lock:
            n_running = len(w._running_tasks)
        if n_running:
            logger.warning(
                "memory monitor: host over threshold with %d thread-mode "
                "tasks running; thread workers cannot be OOM-killed "
                "(use worker_mode=process for enforcement)", n_running)
        return None

    def shutdown(self) -> None:
        self._shutdown.set()
