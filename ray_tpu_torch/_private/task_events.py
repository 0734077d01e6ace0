"""Head-side task event plane.

The reference keeps per-task profile events in the GCS so a run stays
debuggable after the fact (``ray list tasks --detail`` / ``ray
timeline``).  Here the :class:`TaskEventAggregator` lives in the driver
process and accumulates one record per task *attempt*:

    submitted -> (waiting_deps) -> ready -> dispatched -> running
              -> finished | failed

Transition timestamps flow in from the scheduler's existing transition
points (submit/ready/dispatch hooks) and from worker-side execution
windows piggybacked on the ``done``/``err`` wire messages.  Remote
daemons ship a ``("clock", time.time(), perf_counter())`` sample right
after their hello so off-head wall-clock timestamps can be mapped onto
the head's axis (``RemoteNodePool.clock_offset``) and spans from
different hosts land on one timeline.

FINISHED/FAILED records are kept in a bounded ring sized by the
``task_events_max`` config knob.  Eviction is per-state: finished
records are dropped before failed ones, so failures outlive successes
under pressure.  ``task_events_max=0`` disables the plane entirely
(the bench A/B baseline) -- the worker then leaves ``task_events`` as
``None`` and every producer hook is a cheap ``is not None`` check.

All record methods take the hot path seriously: batch variants hold the
lock once per batch, records are plain lists (fixed indices below), and
nothing here ever blocks a scheduler or pool thread on I/O.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.analysis.runtime_checks import assert_holds

# Record field indices.  Plain lists beat dataclasses ~3x on the
# 100k-task submit path, and the aggregator is the only reader.
TID = 0         # TaskID (hashable; .hex() for display)
NAME = 1        # task name
ATTEMPT = 2     # attempt number (each retry is its own record)
NODE = 3        # node index (-1 until dispatch)
WORKER = 4      # worker id (hex str / thread ident) once known
ERROR = 5       # error type name for failed attempts
SUBMITTED = 6   # wall-clock timestamps (head axis), None until reached
READY = 7       # deps satisfied; None for no-dep tasks == submitted
DISPATCHED = 8
START = 9       # execution window (worker-side, clock-aligned)
END = 10
STATE = 11      # "LIVE" | "FINISHED" | "FAILED"
RETRIED = 12    # failed attempt that was retried (not terminal)
STAGED = 13     # dispatch-time arg staging kicked off (None = no staging)
TCTX = 14       # trace plane context 4-tuple (trace_id, span_id,
                # parent_span_id, sampled) | None when unsampled
TIER = 15       # QoS priority tier (0 when the plane is off)

_LIVE, _FINISHED, _FAILED = "LIVE", "FINISHED", "FAILED"

# Latency histogram buckets (seconds).  Sub-millisecond buckets matter:
# queue/dep-wait times on a healthy head are microseconds.
_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
            0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
            60.0)


class _Hist:
    """Fixed-bucket histogram rendered in Prometheus text format."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(_BUCKETS, v)] += 1
        self.sum += v
        self.count += 1

    def render(self, name: str, desc: str) -> List[str]:
        out = [f"# HELP {name} {desc}", f"# TYPE {name} histogram"]
        cum = 0
        for le, c in zip(_BUCKETS, self.counts):
            cum += c
            out.append(f'{name}_bucket{{le="{le}"}} {cum}')
        cum += self.counts[-1]
        out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{name}_sum {self.sum}")
        out.append(f"{name}_count {self.count}")
        return out


def _pct(sorted_vals: List[float], p: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(p * len(sorted_vals)))]


class TaskEventAggregator:
    """Cluster-wide per-task lifecycle records, bounded head-side."""

    def __init__(self, max_records: Optional[int] = None) -> None:
        if max_records is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            max_records = GLOBAL_CONFIG.task_events_max
        self._max = int(max_records)
        self._lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.task_events.TaskEventAggregator._lock")
        self._live: Dict[Any, list] = {}
        self._finished: deque = deque()
        self._failed: deque = deque()
        self.hist_queue = _Hist()
        self.hist_dep = _Hist()
        self.hist_exec = _Hist()
        # reservoir of recent (queue_s, dep_s, exec_s) for p50/p95 tiles
        self._recent: deque = deque(maxlen=512)
        self.finished_total = 0
        self.failed_total = 0          # failed attempts (incl. retried)
        self.retries_total = 0
        self.failed_by_type: Dict[str, int] = {}
        # Safety valve: tasks that never reach a terminal hook (e.g.
        # actor lifecycles routed elsewhere) must not pin the live map.
        self._live_cap = max(65536, 4 * max(self._max, 1))

    # ------------------------------------------------------------------
    # producers (scheduler / worker / pool hooks)

    def _new_rec(self, task_id: Any, name: str, attempt: int,
                 now: float) -> list:
        return [task_id, name, attempt, -1, None, None,
                now, None, None, None, None, _LIVE, False, None, None, 0]

    def record_submitted_batch(self, specs: Iterable[Any]) -> None:
        now = time.time()
        with self._lock:
            live = self._live
            for s in specs:
                rec = self._new_rec(
                    s.task_id, s.name, s.attempt_number, now)
                rec[TCTX] = getattr(s, "trace_ctx", None)
                rec[TIER] = getattr(s, "priority", 0) or 0
                live[s.task_id] = rec
            if len(live) > self._live_cap:
                self._trim_live_locked()

    def record_submitted(self, spec: Any) -> None:
        self.record_submitted_batch((spec,))

    def record_ready_batch(self, task_ids: Iterable[Any]) -> None:
        """Deps satisfied.  No-dep tasks never pass through here --
        their READY defaults to SUBMITTED at read time."""
        now = time.time()
        with self._lock:
            live = self._live
            for tid in task_ids:
                rec = live.get(tid)
                if rec is not None and rec[READY] is None:
                    rec[READY] = now

    def record_dispatched_batch(
            self, rows: Iterable[Tuple[Any, int]]) -> None:
        """rows: (task_id, node_index) handed to a pool/executor."""
        now = time.time()
        with self._lock:
            live = self._live
            for tid, node in rows:
                rec = live.get(tid)
                if rec is not None:
                    rec[DISPATCHED] = now
                    rec[NODE] = node

    def record_staged(self, task_id: Any, node: int = -1) -> None:
        """Dispatch-time arg staging began for this attempt: the head
        shipped known peer locations with the lease so the target
        daemon's pull manager overlaps transfers with queue wait."""
        now = time.time()
        with self._lock:
            rec = self._live.get(task_id)
            if rec is not None:
                rec[STAGED] = now
                if node >= 0:
                    rec[NODE] = node

    def record_exec(self, task_id: Any,
                    timing: Optional[Tuple[float, float]],
                    node: int = -1, worker: Optional[Any] = None,
                    offset: float = 0.0) -> None:
        """Attach an execution window to a still-live record (used on
        the error path before the failure hooks finalize it)."""
        with self._lock:
            rec = self._live.get(task_id)
            if rec is None:
                return
            if timing is not None:
                rec[START] = timing[0] + offset
                rec[END] = timing[1] + offset
            if node >= 0:
                rec[NODE] = node
            if worker is not None:
                rec[WORKER] = worker

    def record_finished_batch(
            self,
            rows: Iterable[Tuple[Any, Optional[Tuple[float, float]],
                                 Optional[Any], int]],
            offset: float = 0.0) -> None:
        """rows: (task_id, (t0, t1) | None, worker_id | None, node).

        ``offset`` maps worker-side wall-clock windows onto the head
        axis (``RemoteNodePool.clock_offset`` for off-head nodes)."""
        now = time.time()
        with self._lock:
            live = self._live
            for tid, timing, wkr, node in rows:
                rec = live.pop(tid, None)
                if rec is None:
                    continue
                if timing is not None:
                    rec[START] = timing[0] + offset
                    rec[END] = timing[1] + offset
                if rec[END] is None:
                    rec[END] = now
                if node >= 0:
                    rec[NODE] = node
                if wkr is not None:
                    rec[WORKER] = wkr
                self._finalize_locked(rec, _FINISHED)

    def record_failed(self, task_id: Any, error_type: str,
                      name: Optional[str] = None, attempt: int = 0,
                      node: int = -1) -> None:
        """Terminal failure (no further retries)."""
        now = time.time()
        with self._lock:
            rec = self._live.pop(task_id, None)
            if rec is None:
                # never saw the submit (e.g. evicted live rec): still
                # record the failure -- failures must not vanish.
                rec = self._new_rec(task_id, name or "?", attempt, now)
                rec[SUBMITTED] = None
                if node >= 0:
                    rec[NODE] = node
            rec[ERROR] = error_type
            if rec[END] is None:
                rec[END] = now
            self.failed_total += 1
            self.failed_by_type[error_type] = \
                self.failed_by_type.get(error_type, 0) + 1
            self._finalize_locked(rec, _FAILED)

    def record_retry(self, old_task_id: Any, error_type: str,
                     spec: Any) -> None:
        """A failed attempt is being retried: finalize the old attempt
        into the failed ring (flagged retried) and open a fresh record
        for the new attempt's task id."""
        now = time.time()
        with self._lock:
            rec = self._live.pop(old_task_id, None)
            if rec is not None:
                rec[ERROR] = error_type
                rec[RETRIED] = True
                if rec[END] is None:
                    rec[END] = now
                self.failed_total += 1
                self.failed_by_type[error_type] = \
                    self.failed_by_type.get(error_type, 0) + 1
                self._finalize_locked(rec, _FAILED)
            self.retries_total += 1
            new_rec = self._new_rec(
                spec.task_id, spec.name, spec.attempt_number, now)
            # retry mutates the spec in place, so the new attempt
            # carries the SAME logical trace context as the failed one
            new_rec[TCTX] = getattr(spec, "trace_ctx", None)
            new_rec[TIER] = getattr(spec, "priority", 0) or 0
            self._live[spec.task_id] = new_rec

    # ------------------------------------------------------------------
    # internals (caller holds self._lock)

    def _finalize_locked(self, rec: list, state: str) -> None:
        assert_holds(self._lock, "TaskEventAggregator ring")
        rec[STATE] = state
        if self._max == 0:
            return
        if state == _FINISHED:
            self._finished.append(rec)
            self.finished_total += 1
            q, dep, ex = _durations(rec)
            if dep is not None and dep >= 0:
                self.hist_dep.observe(dep)
            if q is not None and q >= 0:
                self.hist_queue.observe(q)
            if ex is not None and ex >= 0:
                self.hist_exec.observe(ex)
            self._recent.append((q or 0.0, dep or 0.0, ex or 0.0))
        else:
            self._failed.append(rec)
        # per-state eviction: drain finished before touching failed,
        # so failure records outlive success records under pressure.
        while len(self._finished) + len(self._failed) > self._max:
            (self._finished or self._failed).popleft()

    def _trim_live_locked(self) -> None:
        assert_holds(self._lock, "TaskEventAggregator live table")
        live = self._live
        while len(live) > self._live_cap:
            live.pop(next(iter(live)))

    # ------------------------------------------------------------------
    # consumers (state API / timeline / metrics / dashboard)

    def dead_rows(self, state: Optional[str] = None) -> List[Dict]:
        with self._lock:
            recs = []
            if state in (None, _FINISHED):
                recs.extend(self._finished)
            if state in (None, _FAILED):
                recs.extend(self._failed)
            return [_row(rec) for rec in recs]

    def live_detail(self) -> Dict[str, Dict]:
        """task_id hex -> per-transition timestamps for live tasks
        (used to enrich scheduler task_table rows in detail mode)."""
        with self._lock:
            return {_hex(rec[TID]): _detail(rec)
                    for rec in self._live.values()}

    def timeline(self) -> List[Dict]:
        """Chrome-trace events: one pid per node, tid 0 is the
        scheduler lane (queue + dep-wait spans), small tids are worker
        lanes (execution spans), instants mark retries/failures."""
        with self._lock:
            recs = (list(self._finished) + list(self._failed)
                    + list(self._live.values()))
        events: List[Dict] = []
        lanes: Dict[Tuple[int, Any], int] = {}
        lanes_per_pid: Dict[int, int] = {}
        named_pids = set()

        def _pid_meta(pid: int) -> None:
            if pid in named_pids:
                return
            named_pids.add(pid)
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": f"node {pid}"}})
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": "scheduler"}})

        def _lane(pid: int, worker: Any) -> int:
            key = (pid, worker)
            t = lanes.get(key)
            if t is None:
                t = lanes_per_pid.get(pid, 0) + 1
                lanes_per_pid[pid] = t
                lanes[key] = t
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": t,
                               "args": {"name": f"worker {worker}"}})
            return t

        for rec in recs:
            node = rec[NODE]
            pid = node if isinstance(node, int) and node >= 0 else 0
            _pid_meta(pid)
            name = rec[NAME]
            args = {"task_id": _hex(rec[TID]), "attempt": rec[ATTEMPT]}
            tctx = rec[TCTX] if len(rec) > TCTX else None
            if tctx is not None:
                args["trace_id"] = tctx[0]
            sub = rec[SUBMITTED]
            rdy = rec[READY] if rec[READY] is not None else sub
            dsp = rec[DISPATCHED]
            t0, t1 = rec[START], rec[END]
            if sub is not None and rdy is not None and rdy > sub:
                events.append({"name": f"{name}:dep_wait",
                               "cat": "dep_wait", "ph": "X", "pid": pid,
                               "tid": 0, "ts": sub * 1e6,
                               "dur": (rdy - sub) * 1e6, "args": args})
            if rdy is not None and dsp is not None and dsp >= rdy:
                events.append({"name": f"{name}:queue", "cat": "queue",
                               "ph": "X", "pid": pid, "tid": 0,
                               "ts": rdy * 1e6,
                               "dur": (dsp - rdy) * 1e6, "args": args})
            if t0 is not None and t1 is not None:
                wkr = rec[WORKER] if rec[WORKER] is not None else 0
                events.append({"name": name, "cat": "exec", "ph": "X",
                               "pid": pid, "tid": _lane(pid, wkr),
                               "ts": t0 * 1e6,
                               "dur": max(t1 - t0, 0.0) * 1e6,
                               "args": dict(args,
                                            worker_id=str(wkr))})
            if rec[STATE] == _FAILED:
                kind = "retry" if rec[RETRIED] else "failed"
                events.append({"name": f"{name}:{kind}", "ph": "i",
                               "s": "p", "pid": pid, "tid": 0,
                               "ts": (t1 if t1 is not None
                                      else time.time()) * 1e6,
                               "args": dict(args,
                                            error_type=rec[ERROR])})
        return events

    def latency_summary(self) -> Dict[str, Any]:
        """p50/p95 over the recent-finish reservoir (dashboard tiles)."""
        with self._lock:
            recent = list(self._recent)
            out: Dict[str, Any] = {
                "finished_total": self.finished_total,
                "failed_total": self.failed_total,
                "retries_total": self.retries_total,
                "n": len(recent),
            }
        if recent:
            for i, key in ((0, "queue"), (1, "dep_wait"), (2, "exec")):
                vals = sorted(r[i] for r in recent)
                out[f"{key}_p50_s"] = _pct(vals, 0.50)
                out[f"{key}_p95_s"] = _pct(vals, 0.95)
        return out

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "finished_total": self.finished_total,
                "failed_total": self.failed_total,
                "retries_total": self.retries_total,
                "failed_by_type": dict(self.failed_by_type),
                "live": len(self._live),
                "dead": len(self._finished) + len(self._failed),
            }


# ----------------------------------------------------------------------
# record -> row helpers

def _hex(tid: Any) -> str:
    h = getattr(tid, "hex", None)
    return h() if callable(h) else str(tid)


def _durations(rec: list):
    sub = rec[SUBMITTED]
    rdy = rec[READY] if rec[READY] is not None else sub
    dsp = rec[DISPATCHED]
    t0, t1 = rec[START], rec[END]
    dep = (rdy - sub) if (sub is not None and rdy is not None) else None
    q = (dsp - rdy) if (rdy is not None and dsp is not None) else None
    ex = (t1 - t0) if (t0 is not None and t1 is not None) else None
    return q, dep, ex


def _detail(rec: list) -> Dict[str, Any]:
    q, dep, ex = _durations(rec)
    tctx = rec[TCTX] if len(rec) > TCTX else None
    return {
        "attempt": rec[ATTEMPT],
        "trace_id": tctx[0] if tctx is not None else None,
        "span_id": tctx[1] if tctx is not None else None,
        "parent_span_id": tctx[2] if tctx is not None else None,
        "worker_id": (None if rec[WORKER] is None
                      else str(rec[WORKER])),
        "error_type": rec[ERROR],
        "retried": rec[RETRIED],
        "submitted_at": rec[SUBMITTED],
        "ready_at": rec[READY],
        "dispatched_at": rec[DISPATCHED],
        "staged_at": rec[STAGED] if len(rec) > STAGED else None,
        "start_at": rec[START],
        "end_at": rec[END],
        "queue_s": q,
        "dep_wait_s": dep,
        "exec_s": ex,
    }


def _row(rec: list) -> Dict[str, Any]:
    out = {
        "task_id": _hex(rec[TID]),
        "name": rec[NAME],
        "state": rec[STATE],
        "node_index": rec[NODE],
        "scheduling_class": -1,
        "tier": rec[TIER] if len(rec) > TIER else 0,
    }
    out.update(_detail(rec))
    return out


# ----------------------------------------------------------------------
# Prometheus rendering (called from metrics._render_core)

_FAMILIES = (
    ("hist_queue", "ray_tpu_task_queue_time_seconds",
     "time from deps-ready to dispatch (scheduler queue)"),
    ("hist_dep", "ray_tpu_task_dep_wait_seconds",
     "time from submit to all dependencies ready"),
    ("hist_exec", "ray_tpu_task_exec_time_seconds",
     "task execution wall time on the worker"),
)


def render_prometheus(te: Optional[TaskEventAggregator]) -> List[str]:
    """Task-plane metric families; zero-valued when the plane is
    disabled (task_events_max=0) so scrapes stay schema-stable."""
    if te is None:
        te = TaskEventAggregator(max_records=0)
    lines: List[str] = []
    with te._lock:
        for attr, name, desc in _FAMILIES:
            lines.extend(getattr(te, attr).render(name, desc))
        lines.append("# HELP ray_tpu_tasks_failed_total failed task "
                     "attempts by error type (includes attempts that "
                     "were retried)")
        lines.append("# TYPE ray_tpu_tasks_failed_total counter")
        if te.failed_by_type:
            for etype in sorted(te.failed_by_type):
                lines.append(
                    'ray_tpu_tasks_failed_total{error_type="%s"} %d'
                    % (etype, te.failed_by_type[etype]))
        else:
            lines.append("ray_tpu_tasks_failed_total 0")
        lines.append("# HELP ray_tpu_task_retries_total task attempts "
                     "that failed and were retried")
        lines.append("# TYPE ray_tpu_task_retries_total counter")
        lines.append(f"ray_tpu_task_retries_total {te.retries_total}")
    return lines
