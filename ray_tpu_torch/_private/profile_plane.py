"""Cluster flight recorder: continuous profiling + utilization plane.

The fourth leg of the observability substrate.  Logs capture output,
the task event plane records per-attempt lifecycles, the trace plane
links them causally — this module answers the two questions those
planes keep raising: *what is the CPU actually doing* and *how loaded
is each node over time*.

Two producers, one head-side aggregator:

- :class:`StackSampler` — a daemon thread in every process worker (and
  on the head) walks ``sys._current_frames()`` at ``profile_hz``,
  collapses each stack into a folded ``a;b;c`` string tagged with the
  currently-executing task (ambient context the task-event/trace
  planes already maintain), and hands bounded count batches to a flush
  callback.  Worker batches ride the existing owner pipe as a
  ``("prof", payload)`` message — for daemon-spawned workers that
  message is forwarded as a ``("w", ...)`` report and therefore rides
  the daemon outbox, so samples survive a head blackout + rejoin.
- :class:`ResourceSampler` — a per-node thread reading ``/proc/stat``
  /proc/meminfo`` (the ONE parser ``memory_monitor.host_memory`` also
  uses) plus caller-provided internal gauges (shm arena occupancy,
  control-ring traffic, scheduler queue depths) at
  ``utilization_interval_s``.  Daemons ship each sample as an
  outbox-riding ``("util", payload)`` report; the head records its own
  samples directly.

:class:`ProfilePlane` is the head-side consumer surface: a bounded
folded-stack count table (``profile_stacks_max``, oldest evicted) and
a bounded per-(node, series) time-series ring
(:class:`UtilizationRing`, ``utilization_ring`` points) with
fixed-interval downsampling; off-head timestamps are aligned onto the
head's axis via the same per-pool ``clock_offset`` the task event and
trace planes use.  Disabled contract mirrors the trace plane:
``profile_hz=0`` (the default) leaves ``worker.profile_plane`` as
``None``, no sampler threads exist anywhere, every producer hook is an
``is not None`` check, and the metric families render schema-stable
zeros.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.analysis.runtime_checks import assert_holds

# ----------------------------------------------------------------------
# /proc parsers — the one shared implementation (memory_monitor's
# host_memory() delegates here; keep signatures/semantics stable)
# ----------------------------------------------------------------------

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_meminfo() -> Tuple[int, int]:
    """(used_bytes, total_bytes) for the host, from /proc/meminfo —
    used = MemTotal - MemAvailable (the kernel's own reclaimable-aware
    estimate).  Returns (0, 1) when /proc is unavailable (macOS CI),
    matching the historical memory_monitor fallback."""
    total = available = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    available = int(line.split()[1]) * 1024
                if total is not None and available is not None:
                    break
    except OSError:
        return (0, 1)
    if total is None or available is None:
        return (0, 1)
    return (total - available, total)


def read_self_rss() -> int:
    """Resident set size of THIS process in bytes (0 off-Linux)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


def read_proc_stat() -> Optional[Tuple[int, int]]:
    """(busy_jiffies, total_jiffies) from the aggregate cpu line of
    /proc/stat, or None off-Linux.  busy excludes idle + iowait."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
    except OSError:
        return None
    if not parts or parts[0] != "cpu":
        return None
    try:
        fields = [int(x) for x in parts[1:]]
    except ValueError:
        return None
    total = sum(fields)
    idle = fields[3] if len(fields) > 3 else 0
    iowait = fields[4] if len(fields) > 4 else 0
    return (total - idle - iowait, total)


class CpuPercent:
    """Stateful host CPU utilization from successive /proc/stat deltas.
    The first sample (no delta yet) reports 0.0."""

    def __init__(self) -> None:
        self._last = read_proc_stat()

    def sample(self) -> float:
        cur = read_proc_stat()
        last, self._last = self._last, cur
        if cur is None or last is None:
            return 0.0
        dt = cur[1] - last[1]
        if dt <= 0:
            return 0.0
        return round(100.0 * max(cur[0] - last[0], 0) / dt, 2)


# ----------------------------------------------------------------------
# stack folding + the sampling profiler thread
# ----------------------------------------------------------------------

_MAX_DEPTH = 64


def fold_stack(frame) -> str:
    """Collapse one frame chain into a root-first ``mod.func;...``
    folded-stack string (Brendan Gregg's collapsed format, one level
    per frame)."""
    out: List[str] = []
    while frame is not None and len(out) < _MAX_DEPTH:
        mod = frame.f_globals.get("__name__", "?")
        out.append(f"{mod}.{frame.f_code.co_name}")
        frame = frame.f_back
    out.reverse()
    return ";".join(out)


class StackSampler:
    """Continuous sampling profiler: one daemon thread walking
    ``sys._current_frames()`` at ``hz``.

    ``label_fn`` (worker mode) names the sample after the currently
    executing task; only the main thread — where tasks run — is
    sampled.  With ``all_threads=True`` (the head) every thread is
    sampled and labeled by its thread name.  Folded counts accumulate
    in a bounded buffer (overflow counted, not kept) and ``flush`` is
    handed ``{"samples": [(label, stack, n), ...], "dropped": d}``
    roughly twice a second; a False return (e.g. the worker pipe lock
    is busy) just retries next tick with the buffer intact.
    """

    def __init__(self, hz: float, flush: Callable[[dict], Any],
                 label_fn: Optional[Callable[[], Optional[str]]] = None,
                 all_threads: bool = False, max_keys: int = 2048,
                 flush_interval_s: float = 0.5,
                 name: str = "ray_tpu_profile_sampler") -> None:
        self.hz = float(hz)
        self._flush = flush
        self._label_fn = label_fn
        self._all_threads = all_threads
        self._max_keys = int(max_keys)
        self._flush_interval_s = float(flush_interval_s)
        self._main_id = threading.main_thread().ident
        # parked threads (the common head case in all_threads mode)
        # present the SAME live frame object at the same instruction
        # tick after tick — memoize their folded string instead of
        # re-walking up to _MAX_DEPTH frames per thread per sample
        self._fold_cache: Dict[Tuple[int, int, int], str] = {}
        self._buf: Dict[Tuple[str, str], int] = {}
        self._dropped = 0
        self.samples_taken = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self) -> "StackSampler":
        if self.hz > 0:
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # -- sampler thread ------------------------------------------------
    def _run(self) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        last_flush = time.monotonic()
        while not self._stop.wait(period):
            try:
                self._sample_once()
            except Exception:
                pass  # a torn frame walk must never kill the sampler
            now = time.monotonic()
            if self._buf and now - last_flush >= self._flush_interval_s:
                if self._try_flush():
                    last_flush = now
        self._try_flush()

    def _sample_once(self) -> None:
        own = threading.get_ident()
        names = ({t.ident: t.name for t in threading.enumerate()}
                 if self._all_threads else {})
        label = self._label_fn() if self._label_fn is not None else None
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            if not self._all_threads and tid != self._main_id:
                continue
            cache_key = (id(frame), id(frame.f_code), frame.f_lasti)
            stack = self._fold_cache.get(cache_key)
            if stack is None:
                if len(self._fold_cache) >= 4096:
                    self._fold_cache.clear()
                stack = self._fold_cache[cache_key] = fold_stack(frame)
            if not stack:
                continue
            lbl = (label if tid == self._main_id and label is not None
                   else (names.get(tid, "idle") if self._all_threads
                         else "idle"))
            key = (lbl, stack)
            if key not in self._buf and len(self._buf) >= self._max_keys:
                self._dropped += 1
                continue
            self._buf[key] = self._buf.get(key, 0) + 1
            self.samples_taken += 1

    def _try_flush(self) -> bool:
        if not self._buf and not self._dropped:
            return True
        buf, self._buf = self._buf, {}
        dropped, self._dropped = self._dropped, 0
        payload = {"samples": [(lbl, stack, n)
                               for (lbl, stack), n in buf.items()],
                   "dropped": dropped}
        try:
            if self._flush(payload) is False:
                raise RuntimeError("flush declined")
        except Exception:
            # put the counts back (merged) and retry on a later tick
            for (lbl, stack), n in buf.items():
                key = (lbl, stack)
                if key in self._buf or len(self._buf) < self._max_keys:
                    self._buf[key] = self._buf.get(key, 0) + n
                else:
                    self._dropped += 1
            self._dropped += dropped
            return False
        return True


# ----------------------------------------------------------------------
# per-node resource sampling
# ----------------------------------------------------------------------

class ResourceSampler:
    """Fixed-interval /proc + internal-gauge sampler on a daemon
    thread.  Each tick hands ``sink`` one payload dict::

        {"ts": <local wall clock>, "cpu_percent": ..., "rss_bytes": ...,
         "mem_used_bytes": ..., <gauge name>: <value>, ...}

    ``gauges`` maps extra series names to zero-arg callables (shm arena
    occupancy, scheduler queue depth, ...); a failing gauge reports 0
    rather than killing the loop.  The receiver aligns ``ts`` onto the
    head's clock axis with the link's clock_offset."""

    def __init__(self, interval_s: float, sink: Callable[[dict], Any],
                 gauges: Optional[Dict[str, Callable[[], float]]] = None,
                 name: str = "ray_tpu_resource_sampler") -> None:
        self.interval_s = float(interval_s)
        self._sink = sink
        self._gauges = dict(gauges or {})
        self._cpu = CpuPercent()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self) -> "ResourceSampler":
        if self.interval_s > 0:
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def sample(self) -> dict:
        used, _total = read_meminfo()
        payload: Dict[str, Any] = {
            "ts": time.time(),
            "cpu_percent": self._cpu.sample(),
            "rss_bytes": read_self_rss(),
            "mem_used_bytes": used,
        }
        for series, fn in self._gauges.items():
            try:
                payload[series] = fn()
            except Exception:
                payload[series] = 0
        return payload

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._sink(self.sample())
            except Exception:
                pass  # a dead link must never kill the sampler


# ----------------------------------------------------------------------
# head-side aggregation
# ----------------------------------------------------------------------

class UtilizationRing:
    """Bounded time series keyed by (node, series): ``maxlen`` points
    per key, fixed-interval downsampling — a sample arriving within
    ~80% of ``interval_s`` of the previous point REPLACES it (latest
    value wins, counted) so one flappy producer cannot advance the ring
    faster than the configured cadence.  Callers hold the owning
    plane's lock."""

    def __init__(self, interval_s: float, maxlen: int) -> None:
        self.interval_s = float(interval_s)
        self.maxlen = max(int(maxlen), 1)
        self._series: Dict[Tuple[int, str], deque] = {}
        self.points_recorded = 0
        self.points_downsampled = 0

    def record(self, node: int, series: str, ts: float,
               value: float) -> None:
        dq = self._series.get((node, series))
        if dq is None:
            dq = self._series[(node, series)] = deque(maxlen=self.maxlen)
        if dq and ts - dq[-1][0] < 0.8 * self.interval_s:
            dq[-1] = (dq[-1][0], value)
            self.points_downsampled += 1
            return
        dq.append((ts, value))
        self.points_recorded += 1

    def rows(self, node: Optional[int] = None,
             series: Optional[str] = None) -> List[dict]:
        out = []
        for (n, s), dq in sorted(self._series.items(),
                                 key=lambda kv: (kv[0][0], kv[0][1])):
            if node is not None and n != node:
                continue
            if series is not None and s != series:
                continue
            out.append({"node": n, "series": s,
                        "points": [[ts, v] for ts, v in dq]})
        return out

    def latest(self) -> Dict[int, Dict[str, float]]:
        """{node: {series: latest value}} for the metric gauges."""
        out: Dict[int, Dict[str, float]] = {}
        for (n, s), dq in self._series.items():
            if dq:
                out.setdefault(n, {})[s] = dq[-1][1]
        return out


class ProfilePlane:
    """Head-side flight-recorder state: the folded-stack count table +
    the utilization ring, fed by every node's samplers."""

    def __init__(self, hz: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 util_maxlen: Optional[int] = None,
                 max_stacks: Optional[int] = None) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        self.hz = float(GLOBAL_CONFIG.profile_hz if hz is None else hz)
        if interval_s is None:
            interval_s = GLOBAL_CONFIG.utilization_interval_s
        if util_maxlen is None:
            util_maxlen = GLOBAL_CONFIG.utilization_ring
        if max_stacks is None:
            max_stacks = GLOBAL_CONFIG.profile_stacks_max
        self._max_stacks = int(max_stacks)
        self._lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.profile_plane.ProfilePlane._lock")
        # (node, label, stack) -> count, least recently bumped first
        self._counts: "OrderedDict[Tuple[int, str, str], int]" \
            = OrderedDict()
        self.samples_recorded = 0
        self.samples_dropped = 0
        self.stacks_evicted = 0
        self.util = UtilizationRing(interval_s, util_maxlen)
        self._samplers: List[Any] = []

    # -- producers -----------------------------------------------------
    def record_batch(self, node: int, payload: dict) -> None:
        """One shipped profiler batch from ``node`` (see StackSampler
        flush payload shape)."""
        samples = payload.get("samples") or ()
        with self._lock:
            self.samples_dropped += int(payload.get("dropped", 0))
            counts = self._counts
            for label, stack, n in samples:
                key = (node, label or "idle", stack)
                cur = counts.get(key)
                if cur is None:
                    while len(counts) >= self._max_stacks:
                        counts.popitem(last=False)
                        self.stacks_evicted += 1
                    counts[key] = int(n)
                else:
                    counts[key] = cur + int(n)
                    counts.move_to_end(key)
                self.samples_recorded += int(n)

    def record_util(self, node: int, payload: dict,
                    offset: float = 0.0) -> None:
        """One resource sample from ``node``; ``offset`` maps the
        producer's wall clock onto the head's axis (0 for the head and
        local pools)."""
        ts = float(payload.get("ts", 0.0) or time.time()) + offset
        with self._lock:
            for series, value in payload.items():
                if series == "ts":
                    continue
                try:
                    self.util.record(node, series, ts, float(value))
                except (TypeError, ValueError):
                    continue

    # -- the head's own samplers ---------------------------------------
    def start_head_samplers(
            self,
            gauges: Optional[Dict[str, Callable[[], float]]] = None,
            label_fn: Optional[Callable[[], Optional[str]]] = None
            ) -> None:
        """Head node (index 0): a stack sampler over every thread in
        this process and a resource sampler carrying the cluster-internal
        gauges; both record straight into this plane, no wire hop."""
        stack = StackSampler(
            self.hz, lambda p: self.record_batch(0, p),
            label_fn=label_fn, all_threads=label_fn is None,
            name="ray_tpu_profile_head").start()
        res = ResourceSampler(
            self.util.interval_s, lambda p: self.record_util(0, p),
            gauges=gauges, name="ray_tpu_util_head").start()
        self._samplers.extend((stack, res))

    def shutdown(self) -> None:
        for s in self._samplers:
            try:
                s.stop()
            except Exception:
                pass
        self._samplers = []

    # -- consumers (state API / CLI / dashboard / metrics) -------------
    def profile_stacks(self) -> List[dict]:
        """One row per resident (node, task, stack), highest count
        first."""
        with self._lock:
            assert_holds(self._lock, "ProfilePlane stack table")
            items = list(self._counts.items())
        rows = [{"node": n, "task": lbl, "stack": stack, "count": c}
                for (n, lbl, stack), c in items]
        rows.sort(key=lambda r: -r["count"])
        return rows

    def list_utilization(self, node: Optional[int] = None,
                         series: Optional[str] = None) -> List[dict]:
        with self._lock:
            return self.util.rows(node=node, series=series)

    def utilization_latest(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            return self.util.latest()

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples_recorded": self.samples_recorded,
                "samples_dropped": self.samples_dropped,
                "stacks_evicted": self.stacks_evicted,
                "stacks_resident": len(self._counts),
                "util_points_recorded": self.util.points_recorded,
                "util_points_downsampled": self.util.points_downsampled,
            }


# ----------------------------------------------------------------------
# exports: collapsed stacks, speedscope, top-tasks table
# ----------------------------------------------------------------------

def collapsed(rows: List[dict]) -> str:
    """Brendan Gregg folded-stack text: ``node;task;frames count`` per
    line — feed straight into flamegraph.pl / inferno / speedscope."""
    out = []
    for r in rows:
        out.append(f"node{r['node']};{r['task']};{r['stack']} "
                   f"{r['count']}")
    return "\n".join(out) + ("\n" if out else "")


def top_tasks(rows: List[dict], limit: int = 15) -> List[dict]:
    """Samples aggregated by task label, highest CPU share first."""
    total = sum(r["count"] for r in rows) or 1
    by_task: Dict[Tuple[int, str], int] = {}
    for r in rows:
        key = (r["node"], r["task"])
        by_task[key] = by_task.get(key, 0) + r["count"]
    table = [{"node": n, "task": t, "samples": c,
              "cpu_pct": round(100.0 * c / total, 1)}
             for (n, t), c in by_task.items()]
    table.sort(key=lambda r: -r["samples"])
    return table[:limit]


def speedscope(rows: List[dict], name: str = "ray_tpu") -> dict:
    """speedscope.app sampled-profile JSON; every (node, task) prefix
    becomes the two outermost frames so the flamegraph groups by node
    then task."""
    frames: List[dict] = []
    index: Dict[str, int] = {}

    def fidx(fname: str) -> int:
        i = index.get(fname)
        if i is None:
            i = index[fname] = len(frames)
            frames.append({"name": fname})
        return i

    samples, weights = [], []
    for r in rows:
        chain = [f"node{r['node']}", r["task"]] + r["stack"].split(";")
        samples.append([fidx(f) for f in chain])
        weights.append(r["count"])
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled", "name": name, "unit": "none",
            "startValue": 0, "endValue": total,
            "samples": samples, "weights": weights,
        }],
        "name": name,
    }


def flamegraph_report(rows: List[dict]) -> dict:
    """The ``ray_tpu_torch.profile()`` return shape: a speedscope document
    plus the collapsed text and a top-tasks-by-CPU table."""
    return {
        "samples": sum(r["count"] for r in rows),
        "top_tasks": top_tasks(rows),
        "collapsed": collapsed(rows),
        "speedscope": speedscope(rows),
    }
