"""Cluster-wide causal tracing plane.

The task event plane (task_events.py) records per-attempt lifecycles
and the log plane captures output, but neither links records causally.
This module adds the missing layer: a ``TraceContext`` — a plain
4-tuple ``(trace_id, span_id, parent_span_id, sampled)`` — stamped
into :class:`TaskSpec` at submit, carried to workers inside the
existing wire envelopes (a ``"trace"`` key in the task payload dict
and a sixth element in the actor-call blob; no new framed tags), and
restored worker-side so nested ``.remote()`` submissions and actor
calls inherit parentage automatically.  The logical span survives
retries because retry mutates the spec in place: each attempt becomes
its own record under the same ``span_id`` (attempt spans are derived
as ``span#attempt`` at export time, children of the logical span).

Propagation is ambient: whoever is about to run user code installs the
code's own context with :func:`parent_scope`, and submission paths ask
:func:`current_parent` — a thread-local, so the driver's thread-mode
execution, the head's per-request client threads, and the head-side
RPC handlers for worker-nested submissions all compose without passing
contexts through call signatures.

The :class:`TraceAggregator` mirrors ``TaskEventAggregator``
structurally: plain-list records with fixed indices, one lock, batch
hooks that hold it once, worker-side ``(t0, t1)`` windows mapped onto
the head's clock axis via the same per-pool ``clock_offset``, and
bounded retention — here keyed by trace_id, evicting the least
recently active trace wholesale when ``traces_max`` is exceeded.
``trace_sample_rate`` gates stamping at the root: children always
inherit the root's decision so a trace is recorded completely or not
at all.  Rate 0 (or ``traces_max=0``) disables the plane entirely —
the worker leaves ``trace_plane`` as ``None``, specs are never
stamped, and every producer hook is a cheap ``is not None`` check
(the same contract as ``task_events_max=0``).
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.analysis.runtime_checks import assert_holds

# Record field indices (plain lists, same rationale as task_events).
TID = 0         # task id / call id / span id for client ops (hashable)
NAME = 1        # task or method name; "client:<op>" for client ops
KIND = 2        # "task" | "actor" | "client"
TRACE = 3       # trace_id hex
SPAN = 4        # logical span id hex (stable across retries)
PARENT = 5      # parent span id hex, None for roots
ATTEMPT = 6     # attempt number (each retry is its own record)
NODE = 7        # node index (-1 until dispatch)
WORKER = 8      # worker id once known
SUBMITTED = 9   # wall-clock timestamps (head axis), None until reached
DISPATCHED = 10
STAGED = 11     # dispatch-time arg staging kicked off (None = none)
START = 12      # execution window (worker-side, clock-aligned)
END = 13
STATE = 14      # "LIVE" | "FINISHED" | "FAILED"
ERROR = 15      # error type name for failed attempts
RETRIED = 16    # failed attempt that was retried (not terminal)
LANE = 17       # dispatch lane: None (head) | "local" | "p2p"

_LIVE, _FINISHED, _FAILED = "LIVE", "FINISHED", "FAILED"

# Per-trace span cap: one runaway fan-out must not evict every other
# trace's history; excess spans are counted, not kept.
_SPANS_PER_TRACE_CAP = 8192

_local = threading.local()


def current_parent() -> Optional[Tuple]:
    """The ambient TraceContext of the code currently running on this
    thread (None outside any traced scope)."""
    return getattr(_local, "parent", None)


@contextmanager
def parent_scope(ctx: Optional[Tuple]):
    """Install ``ctx`` as the ambient parent for the duration: any
    submission on this thread becomes its child.  No-op for None, so
    callers never need their own enablement check."""
    if ctx is None:
        yield
        return
    prev = getattr(_local, "parent", None)
    _local.parent = ctx
    try:
        yield
    finally:
        _local.parent = prev


def _new_id() -> str:
    return os.urandom(8).hex()


def new_context(rate: float,
                parent: Optional[Tuple] = None) -> Tuple:
    """TraceContext for a fresh submission.  Children join the parent's
    trace and inherit its sampling decision; roots sample at ``rate``."""
    if parent is not None:
        return (parent[0], _new_id(), parent[1], parent[3])
    sampled = rate >= 1.0 or random.random() < rate
    return (_new_id(), _new_id(), None, sampled)


def attempt_span(span: str, attempt: int) -> str:
    """Per-attempt span id, a child of the logical span ``span``."""
    return span if attempt == 0 else f"{span}#{attempt}"


def _flow_id(key: str) -> int:
    """Stable positive int for a Chrome-trace flow arrow pair."""
    return int(hashlib.md5(key.encode()).hexdigest()[:8], 16) & 0x7fffffff


class TraceAggregator:
    """Head-side span records for sampled traces, bounded by trace."""

    def __init__(self, sample_rate: Optional[float] = None,
                 max_traces: Optional[int] = None) -> None:
        if sample_rate is None or max_traces is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if sample_rate is None:
                sample_rate = GLOBAL_CONFIG.trace_sample_rate
            if max_traces is None:
                max_traces = GLOBAL_CONFIG.traces_max
        self.sample_rate = float(sample_rate)
        self._max = int(max_traces)
        self._lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.trace_plane.TraceAggregator._lock")
        self._live: Dict[Any, list] = {}
        # trace_id -> finalized span records, least recently active first
        self._traces: "OrderedDict[str, List[list]]" = OrderedDict()
        self.spans_total = 0
        self.spans_dropped = 0
        self.traces_evicted = 0
        self.client_ops_total = 0
        # Same safety valve as the task event plane: records that never
        # reach a terminal hook must not pin the live map.
        self._live_cap = max(65536, 4 * max(self._max, 1))

    # ------------------------------------------------------------------
    # context creation

    def make_context(self, parent: Optional[Tuple] = None) -> Tuple:
        if parent is None:
            parent = current_parent()
        return new_context(self.sample_rate, parent)

    # ------------------------------------------------------------------
    # producers (mirror the TaskEventAggregator hook signatures)

    def _new_rec(self, key: Any, name: str, kind: str, ctx: Tuple,
                 attempt: int, now: float) -> list:
        return [key, name, kind, ctx[0], ctx[1], ctx[2], attempt,
                -1, None, now, None, None, None, None, _LIVE, None,
                False, None]

    def on_submit_batch(self, specs: Iterable[Any]) -> None:
        """Stamp unstamped specs with a context (child of the thread's
        ambient parent, if any) and open records for sampled ones."""
        now = time.time()
        rate = self.sample_rate
        parent = current_parent()
        sampled = []
        for s in specs:
            ctx = s.trace_ctx
            if ctx is None:
                ctx = new_context(rate, parent)
                s.trace_ctx = ctx
            if ctx[3]:
                sampled.append(s)
        if not sampled:
            return
        with self._lock:
            live = self._live
            for s in sampled:
                ctx = s.trace_ctx
                live[s.task_id] = self._new_rec(
                    s.task_id, s.name, "task", ctx, s.attempt_number,
                    now)
            if len(live) > self._live_cap:
                self._trim_live_locked()

    def on_submit(self, spec: Any) -> None:
        self.on_submit_batch((spec,))

    def on_actor_call(self, call: Any, name: str,
                      node: int = -1) -> None:
        """An actor method submission (``call`` is actor._Call, already
        stamped with its trace_ctx)."""
        ctx = call.trace_ctx
        if ctx is None or not ctx[3]:
            return
        now = time.time()
        rec = self._new_rec(call.task_id, name, "actor", ctx, 0, now)
        if node >= 0:
            rec[NODE] = node
        with self._lock:
            self._live[call.task_id] = rec
            if len(self._live) > self._live_cap:
                self._trim_live_locked()

    def record_local_dispatch(self, task_id: Any, name: str,
                              ctx: Optional[Tuple], node: int,
                              now: Optional[float] = None) -> None:
        """A node's LocalScheduler admitted a worker-submitted task
        without a head round-trip: open the attempt record directly in
        the dispatched state, flagged ``lane="local"`` so the export
        draws its dispatch arrow from the NODE's lane, not the head
        scheduler lane it never crossed."""
        if ctx is None or not ctx[3]:
            return
        t = now if now is not None else time.time()
        rec = self._new_rec(task_id, name, "task", ctx, 0, t)
        rec[DISPATCHED] = t
        rec[NODE] = node
        rec[LANE] = "local"
        with self._lock:
            self._live[task_id] = rec
            if len(self._live) > self._live_cap:
                self._trim_live_locked()

    def record_p2p_span(self, task_id: Any, name: str,
                        ctx: Optional[Tuple], node: int,
                        timing: Optional[Tuple[float, float]],
                        worker: Optional[Any] = None,
                        offset: float = 0.0,
                        error_type: Optional[str] = None) -> None:
        """A peer-to-peer actor call's completion receipt: the head
        learns of the call only now, so the record opens and finalizes
        together — ``lane="p2p"`` suppresses the head-side logical and
        scheduler spans at export (the call never touched them) while
        the exec span and the worker->peer flow arrow remain."""
        if ctx is None or not ctx[3]:
            return
        now = time.time()
        rec = self._new_rec(task_id, name, "actor", ctx, 0, now)
        rec[NODE] = node
        rec[LANE] = "p2p"
        if worker is not None:
            rec[WORKER] = worker
        if timing is not None:
            rec[START] = timing[0] + offset
            rec[END] = timing[1] + offset
            rec[SUBMITTED] = rec[START]
        else:
            rec[END] = now
        if error_type is not None:
            rec[ERROR] = error_type
        with self._lock:
            self._finalize_locked(rec,
                                  _FAILED if error_type else _FINISHED)

    def record_dispatched_batch(
            self, rows: Iterable[Tuple[Any, int]]) -> None:
        """rows: (task_id, node_index) — the scheduler's decision."""
        now = time.time()
        with self._lock:
            live = self._live
            for tid, node in rows:
                rec = live.get(tid)
                if rec is not None:
                    rec[DISPATCHED] = now
                    rec[NODE] = node

    def record_staged(self, task_id: Any, node: int = -1) -> None:
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
        """Same row shape and clock-offset contract as the task event
        plane: (task_id, (t0, t1) | None, worker | None, node)."""
        now = time.time()
        with self._lock:
            live = self._live
            for tid, timing, wkr, node in rows:
                rec = live.pop(tid, None)
                if rec is None:
                    continue  # unsampled (or evicted) task
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

    def record_failed(self, task_id: Any, error_type: str) -> None:
        """Terminal failure.  Unlike the task event plane this does not
        synthesize a record — an unsampled task hits this hook on every
        failure and must stay free."""
        now = time.time()
        with self._lock:
            rec = self._live.pop(task_id, None)
            if rec is None:
                return
            rec[ERROR] = error_type
            if rec[END] is None:
                rec[END] = now
            self._finalize_locked(rec, _FAILED)

    def record_retry(self, old_task_id: Any, error_type: str,
                     spec: Any) -> None:
        """Finalize the failed attempt (flagged retried) and open the
        next attempt's record under the SAME logical span — the spec's
        trace_ctx is unchanged by retry, only task_id/attempt mutate."""
        ctx = getattr(spec, "trace_ctx", None)
        now = time.time()
        with self._lock:
            rec = self._live.pop(old_task_id, None)
            if rec is not None:
                rec[ERROR] = error_type
                rec[RETRIED] = True
                if rec[END] is None:
                    rec[END] = now
                self._finalize_locked(rec, _FAILED)
            if ctx is not None and ctx[3]:
                self._live[spec.task_id] = self._new_rec(
                    spec.task_id, spec.name, "task", ctx,
                    spec.attempt_number, now)

    @contextmanager
    def client_span(self, op: str):
        """Span for one ray:// client operation.  Roots a fresh trace
        (sampled at the knob rate) and installs it as the thread's
        parent so the head-side submission it triggers becomes its
        child."""
        ctx = self.make_context(parent=None)
        t0 = time.time()
        with parent_scope(ctx):
            try:
                yield ctx
            finally:
                t1 = time.time()
                with self._lock:
                    self.client_ops_total += 1
                    if ctx[3]:
                        rec = self._new_rec(ctx[1], f"client:{op}",
                                            "client", ctx, 0, t0)
                        rec[START] = t0
                        rec[END] = t1
                        self._finalize_locked(rec, _FINISHED)

    # ------------------------------------------------------------------
    # internals (caller holds self._lock)

    def _finalize_locked(self, rec: list, state: str) -> None:
        assert_holds(self._lock, "TraceAggregator ring")
        rec[STATE] = state
        trace_id = rec[TRACE]
        spans = self._traces.get(trace_id)
        if spans is None:
            if self._max and len(self._traces) >= self._max:
                self._traces.popitem(last=False)
                self.traces_evicted += 1
            spans = self._traces[trace_id] = []
        else:
            self._traces.move_to_end(trace_id)
        if len(spans) >= _SPANS_PER_TRACE_CAP:
            self.spans_dropped += 1
            return
        spans.append(rec)
        self.spans_total += 1

    def _trim_live_locked(self) -> None:
        assert_holds(self._lock, "TraceAggregator live table")
        live = self._live
        while len(live) > self._live_cap:
            live.pop(next(iter(live)))

    # ------------------------------------------------------------------
    # consumers (state API / CLI / dashboard / metrics)

    def list_traces(self) -> List[Dict[str, Any]]:
        """One row per resident trace, most recently active first."""
        with self._lock:
            items = [(t, list(rs)) for t, rs in self._traces.items()]
            live = [list(r) for r in self._live.values()]
        agg: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        for trace_id, recs in items:
            agg[trace_id] = {"trace_id": trace_id, "recs": recs,
                             "live_spans": 0}
        for rec in live:
            row = agg.setdefault(rec[TRACE],
                                 {"trace_id": rec[TRACE], "recs": [],
                                  "live_spans": 0})
            row["live_spans"] += 1
            row["recs"].append(rec)
        rows = []
        for row in agg.values():
            recs = row.pop("recs")
            roots = [r for r in recs if r[PARENT] is None]
            subs = [r[SUBMITTED] for r in recs
                    if r[SUBMITTED] is not None]
            ends = [r[END] for r in recs if r[END] is not None]
            row["spans"] = len(recs) - row["live_spans"]
            row["root"] = roots[0][NAME] if roots else None
            row["failed"] = sum(1 for r in recs
                                if r[STATE] == _FAILED
                                and not r[RETRIED])
            row["first_ts"] = min(subs) if subs else None
            row["last_ts"] = max(ends) if ends else None
            rows.append(row)
        rows.reverse()
        return rows

    def trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """Chrome-trace/Perfetto events for one trace: a driver lane of
        logical spans, a scheduler lane of per-attempt decision spans,
        one exec lane per (node, worker), dispatch flow arrows from the
        scheduler lane to the exec lane, and spawn flow arrows from a
        parent's exec span to each child's exec span.  Prefix match on
        ``trace_id`` is allowed (CLI id handling idiom)."""
        with self._lock:
            recs = [list(r) for t, rs in self._traces.items()
                    if t.startswith(trace_id) for r in rs]
            recs.extend(list(r) for r in self._live.values()
                        if r[TRACE].startswith(trace_id))
        return _export(recs)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spans_total": self.spans_total,
                "spans_dropped": self.spans_dropped,
                "traces_evicted": self.traces_evicted,
                "client_ops_total": self.client_ops_total,
                "traces_resident": len(self._traces),
                "live_spans": len(self._live),
            }


# ----------------------------------------------------------------------
# Perfetto export

def _hex(tid: Any) -> str:
    h = getattr(tid, "hex", None)
    return h() if callable(h) else str(tid)


def _export(recs: List[list]) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    named_pids = set()
    lanes: Dict[Tuple[int, Any], int] = {}
    lanes_per_pid: Dict[int, int] = {}
    # (span, attempt) -> (pid, tid) of the attempt's exec event, for
    # spawn flow arrows in the second pass
    placed: Dict[Tuple[str, int], Tuple[int, int]] = {}

    def _pid_meta(pid: int) -> None:
        if pid in named_pids:
            return
        named_pids.add(pid)
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": ("head" if pid == 0
                                         else f"node {pid}")}})
        if pid == 0:
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": 0, "args": {"name": "driver"}})
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": 1, "args": {"name": "scheduler"}})
            lanes_per_pid[0] = 1  # head exec lanes start at tid 2

    def _lane(pid: int, worker: Any, label: Optional[str] = None) -> int:
        key = (pid, worker)
        t = lanes.get(key)
        if t is None:
            t = lanes_per_pid.get(pid, 0) + 1
            lanes_per_pid[pid] = t
            lanes[key] = t
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": t,
                           "args": {"name": label
                                    or f"worker {worker}"}})
        return t

    _pid_meta(0)
    by_span: "OrderedDict[str, List[list]]" = OrderedDict()
    for rec in recs:
        by_span.setdefault(rec[SPAN], []).append(rec)

    for span, srecs in by_span.items():
        srecs.sort(key=lambda r: r[ATTEMPT])
        r0 = srecs[0]
        rN = srecs[-1]
        base = {"trace_id": r0[TRACE], "span_id": span,
                "parent_span_id": r0[PARENT], "kind": r0[KIND]}
        subs = [r[SUBMITTED] for r in srecs
                if r[SUBMITTED] is not None]
        ends = [r[END] for r in srecs if r[END] is not None]
        t_lo = min(subs) if subs else None
        t_hi = (max(ends) if ends
                else (time.time() if t_lo is not None else None))
        span_p2p = all(r[LANE] == "p2p" for r in srecs)
        if t_lo is not None and t_hi is not None and not span_p2p:
            # the logical span: driver submit -> resolve. A purely
            # peer-to-peer call never touched the head lane — emitting
            # a head span for it would invent a round-trip that the
            # whole p2p plane exists to remove.
            events.append({"name": r0[NAME], "cat": "span", "ph": "X",
                           "pid": 0, "tid": 0, "ts": t_lo * 1e6,
                           "dur": max(t_hi - t_lo, 0.0) * 1e6,
                           "args": dict(base, attempts=len(srecs),
                                        state=rN[STATE],
                                        error_type=rN[ERROR])})
        for rec in srecs:
            aspan = attempt_span(span, rec[ATTEMPT])
            args = {"trace_id": rec[TRACE], "span_id": aspan,
                    "parent_span_id": span, "attempt": rec[ATTEMPT],
                    "task_id": _hex(rec[TID])}
            sub, dsp = rec[SUBMITTED], rec[DISPATCHED]
            stg = rec[STAGED]
            node = rec[NODE]
            lane = rec[LANE]
            pid = node if isinstance(node, int) and node >= 0 else 0
            _pid_meta(pid)
            sched_src = None  # (pid, tid) the dispatch arrow leaves from
            if sub is not None and dsp is not None and dsp >= sub:
                if lane == "local":
                    # admitted by the NODE's LocalScheduler: its
                    # decision span lives on the node, not the head
                    ltid = _lane(pid, "__lsched__", "local scheduler")
                    sched_src = (pid, ltid)
                    events.append({"name": f"lsched:{rec[NAME]}",
                                   "cat": "sched", "ph": "X",
                                   "pid": pid, "tid": ltid,
                                   "ts": sub * 1e6,
                                   "dur": (dsp - sub) * 1e6,
                                   "args": dict(args, node_chosen=node,
                                                lane="local")})
                elif lane is None:
                    sched_src = (0, 1)
                    events.append({"name": f"sched:{rec[NAME]}",
                                   "cat": "sched", "ph": "X", "pid": 0,
                                   "tid": 1, "ts": sub * 1e6,
                                   "dur": (dsp - sub) * 1e6,
                                   "args": dict(args, node_chosen=node,
                                                staged=stg is not None)})
            t0, t1 = rec[START], rec[END]
            if t0 is not None and t1 is not None:
                wkr = rec[WORKER] if rec[WORKER] is not None else 0
                tid = _lane(pid, wkr)
                placed[(span, rec[ATTEMPT])] = (pid, tid)
                events.append({"name": f"exec:{rec[NAME]}",
                               "cat": "exec", "ph": "X", "pid": pid,
                               "tid": tid, "ts": t0 * 1e6,
                               "dur": max(t1 - t0, 0.0) * 1e6,
                               "args": dict(args, worker_id=str(wkr),
                                            lane=lane or "head")})
                anchor = dsp if dsp is not None else sub
                # p2p calls get their arrow from the CALLER's exec span
                # (the spawn pass below, named "p2p"); the head never
                # dispatched them, so no head-anchored arrow exists
                if anchor is not None and lane != "p2p":
                    src = sched_src if sched_src is not None else (0, 1)
                    fid = _flow_id(aspan + ":d")
                    events.append({"ph": "s", "cat": "flow",
                                   "name": ("local_dispatch"
                                            if lane == "local"
                                            else "dispatch"),
                                   "id": fid,
                                   "pid": src[0], "tid": src[1],
                                   "ts": anchor * 1e6})
                    events.append({"ph": "f", "bp": "e", "cat": "flow",
                                   "name": ("local_dispatch"
                                            if lane == "local"
                                            else "dispatch"),
                                   "id": fid, "pid": pid, "tid": tid,
                                   "ts": t0 * 1e6})
            if rec[STATE] == _FAILED:
                kind = "retry" if rec[RETRIED] else "failed"
                events.append({"name": f"{rec[NAME]}:{kind}",
                               "ph": "i", "s": "p", "pid": pid,
                               "tid": 0,
                               "ts": ((t1 if t1 is not None
                                       else time.time()) * 1e6),
                               "args": dict(args,
                                            error_type=rec[ERROR])})

    # spawn flow arrows: parent exec span -> child exec span
    for span, srecs in by_span.items():
        parent = srecs[0][PARENT]
        if parent is None or parent not in by_span:
            continue
        child = next((r for r in srecs if (span, r[ATTEMPT]) in placed),
                     None)
        if child is None or child[SUBMITTED] is None:
            continue
        # the parent attempt lane (last placed attempt wins)
        ppl = None
        for prec in by_span[parent]:
            ppl = placed.get((parent, prec[ATTEMPT]), ppl)
        if ppl is None:
            continue
        fid = _flow_id(span + ":p")
        cpid, ctid = placed[(span, child[ATTEMPT])]
        # a p2p child's arrow IS its dispatch record: caller exec lane
        # straight to the peer exec lane, no head hop in between
        aname = "p2p" if child[LANE] == "p2p" else "spawn"
        events.append({"ph": "s", "cat": "flow", "name": aname,
                       "id": fid, "pid": ppl[0], "tid": ppl[1],
                       "ts": child[SUBMITTED] * 1e6})
        events.append({"ph": "f", "bp": "e", "cat": "flow",
                       "name": aname, "id": fid, "pid": cpid,
                       "tid": ctid, "ts": child[START] * 1e6})
    return events
