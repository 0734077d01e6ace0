"""Prometheus text-format metrics endpoint + user metrics API backing.

Reference: ray::stats + per-node dashboard agent Prometheus endpoints
(ray: src/ray/stats/, dashboard reporter) and ray.util.metrics
(Counter/Gauge/Histogram). Serves GET /metrics on
config metrics_export_port (0 = disabled).

A copy of ray_tpu's metrics plane. Family names keep the reference's
``ray_tpu_`` prefix, so scrapes of the two packages compare line for
line; the planes the port does not have (QoS, profile, two-level,
transfer, multi-node) render as the reference renders them when off.
"""

from __future__ import annotations

import http.server
import threading
from typing import Dict, List, Optional, Tuple

# -- user metrics registry (ray_tpu_torch.util.metrics facade) ----------------

_user_metrics: Dict[str, "_Metric"] = {}
_user_lock = threading.Lock()


def _escape_label(v: str) -> str:
    """Prometheus text-format label escaping (backslash, quote, LF)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def clear_registry() -> None:
    """Drop all user metrics (test helper). User metrics are
    PROCESS-scoped like the reference's (ray.util.metrics): they are NOT
    cleared at worker shutdown — clearing would orphan metric objects
    users still hold, which would keep accepting updates while silently
    vanishing from scrapes."""
    with _user_lock:
        _user_metrics.clear()


class _Metric:
    def __init__(self, name: str, description: str, kind: str,
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.kind = kind
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}
        # NOTE: subclasses call _register() at the END of their own
        # __init__, once all their state exists

    def _register(self) -> None:
        """Publish to the scrape registry LAST (subclasses call this
        after their own state exists — a concurrent scrape must never
        see a half-constructed metric). Re-registration with the same
        name+kind adopts the existing series instead of discarding it."""
        with _user_lock:
            prev = _user_metrics.get(self.name)
            if prev is not None and prev.kind == self.kind \
                    and type(prev) is type(self):
                self._adopt(prev)
            _user_metrics[self.name] = self

    def _adopt(self, prev: "_Metric") -> None:
        self._values = prev._values

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        if tags and self.tag_keys:
            undeclared = set(tags) - set(self.tag_keys)
            if undeclared:
                raise ValueError(
                    f"metric {self.name!r} got undeclared tag keys "
                    f"{sorted(undeclared)}; declared: "
                    f"{list(self.tag_keys)}")
        return tuple(sorted((tags or {}).items()))

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            label = ",".join(f'{k}="{_escape_label(val)}"'
                             for k, val in key)
            out.append(f"{self.name}{{{label}}} {v}" if label
                       else f"{self.name} {v}")
        return out


class Counter(_Metric):
    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, "counter", tag_keys)
        self._register()

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, "gauge", tag_keys)
        self._register()

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(_Metric):
    """Prometheus-style cumulative histogram."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, "histogram", tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._register()

    def _adopt(self, prev: "_Metric") -> None:
        if getattr(prev, "boundaries", None) == self.boundaries:
            self._counts = prev._counts
            self._sums = prev._sums

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            self._sums[k] = self._sums.get(k, 0.0) + value
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            # copy the INNER bucket lists too: observe() mutates them in
            # place and a scrape must be internally consistent
            items = [(k, list(v)) for k, v in self._counts.items()]
            sums = dict(self._sums)
        for key, counts in items:
            base = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
            cum = 0
            for b, c in zip(self.boundaries, counts):
                cum += c
                lab = f'{base},le="{b}"' if base else f'le="{b}"'
                out.append(f"{self.name}_bucket{{{lab}}} {cum}")
            cum += counts[-1]
            lab = f'{base},le="+Inf"' if base else 'le="+Inf"'
            out.append(f"{self.name}_bucket{{{lab}}} {cum}")
            suffix = f"{{{base}}}" if base else ""
            out.append(f"{self.name}_sum{suffix} {sums.get(key, 0.0)}")
            out.append(f"{self.name}_count{suffix} {cum}")
        return out


def _render_serve() -> List[str]:
    """Serving-plane families (ray_tpu_torch.serve.core._ServeMetrics).

    Looked up through sys.modules rather than imported: pulling in the
    serve package from a metrics scrape would be a heavy side effect,
    and most clusters never serve. When serve was never imported the
    families still render as schema-stable zeros — dashboards and
    alert rules keyed on these names see the full set either way.
    ray_tpu_serve_ttft_seconds is a prometheus histogram: bucket
    counts in _ServeMetrics are already cumulative per boundary, and
    le="+Inf" equals the observation count.
    """
    import sys

    core = sys.modules.get("ray_tpu_torch.serve.core")
    if core is not None:
        snap = core.metrics.snapshot()
        bounds = core._TTFT_BUCKETS
    else:
        snap = {}
        bounds = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                  5.0, 10.0)
    buckets = snap.get("ttft_buckets") or [0] * len(bounds)
    count = snap.get("ttft_count", 0)
    lines = [
        "# HELP ray_tpu_serve_ttft_seconds time-to-first-token of "
        "serving streams (first non-empty frame, includes prefill + "
        "KV handoff on the disaggregated path)",
        "# TYPE ray_tpu_serve_ttft_seconds histogram",
    ]
    for b, c in zip(bounds, buckets):
        lines.append(f'ray_tpu_serve_ttft_seconds_bucket{{le="{b}"}} {c}')
    lines.append(
        f'ray_tpu_serve_ttft_seconds_bucket{{le="+Inf"}} {count}')
    lines.append(f"ray_tpu_serve_ttft_seconds_sum "
                 f"{snap.get('ttft_sum', 0.0)}")
    lines.append(f"ray_tpu_serve_ttft_seconds_count {count}")

    def emit(name, desc, value):
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {value}")

    emit("ray_tpu_serve_affinity_hit_total",
         "follow-up turns routed to the decode replica already "
         "holding the session's KV pages",
         snap.get("affinity_hit", 0))
    emit("ray_tpu_serve_affinity_miss_total",
         "follow-up turns whose KV-holding replica was gone "
         "(re-prefill or directory promotion)",
         snap.get("affinity_miss", 0))
    emit("ray_tpu_serve_admission_shed_total",
         "streams shed at ingress by the SLO admission gate "
         "(recent p95 TTFT over serve_slo_ttft_p95_s)",
         snap.get("admission_shed", 0))
    emit("ray_tpu_kv_pages_transferred_bytes_total",
         "KV-cache bytes handed from prefill to decode replicas "
         "through the object plane",
         snap.get("kv_bytes", 0))
    return lines


# -- the endpoint -------------------------------------------------------

# fixed spill-reason label set: one per LocalScheduler admission check
# (see node_daemon._maybe_local_submit) plus "other" for daemons
# predating per-reason reporting. "tier" is the QoS watermark check:
# the submission's priority sat below the head's top-spilled-tier.
SPILL_REASONS = ("queue_full", "tier", "pg", "resources", "refs",
                 "no_slot", "other")


def _render_core(worker) -> List[str]:
    """Core runtime metrics (reference: metric_defs.cc's task/object/
    scheduler families)."""
    stats = worker.scheduler.stats()
    lines = []

    def emit(name, kind, desc, value):
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    emit("ray_tpu_tasks_submitted_total", "counter",
         "tasks submitted to the scheduler", stats.get("submitted", 0))
    emit("ray_tpu_tasks_dispatched_total", "counter",
         "tasks dispatched to workers", stats.get("dispatched", 0))
    emit("ray_tpu_tasks_finished_total", "counter",
         "tasks finished", stats.get("finished", 0))
    emit("ray_tpu_scheduler_ready_queue", "gauge",
         "tasks ready for assignment", stats.get("ready_queue", 0))
    emit("ray_tpu_scheduler_waiting_deps", "gauge",
         "tasks blocked on dependencies", stats.get("waiting_deps", 0))
    emit("ray_tpu_scheduler_ticks_total", "counter",
         "scheduler ticks", stats.get("ticks", 0))
    emit("ray_tpu_objects_in_store", "gauge",
         "objects in the owner memory store", worker.memory_store.size())
    emit("ray_tpu_actors_alive", "gauge", "registered live actors",
         sum(1 for e in worker.gcs.actor_table()
             if e.state == "ALIVE"))
    emit("ray_tpu_nodes_alive", "gauge", "alive cluster nodes",
         sum(1 for e in worker.gcs.node_table()
             if e.state == "ALIVE"))

    # log plane: driver-streaming volume + on-disk capture volume (the
    # byte count is a session-dir scan — honest across processes, since
    # workers write their files directly, not through this process)
    lm = getattr(worker, "log_monitor", None)
    emit("ray_tpu_log_lines_emitted_total", "counter",
         "captured log lines re-emitted on the driver",
         lm.lines_emitted if lm is not None else 0)
    emit("ray_tpu_log_lines_dropped_total", "counter",
         "captured log lines dropped by the driver rate limiter",
         lm.lines_dropped if lm is not None else 0)
    from ray_tpu_torch._private import log_plane
    log_dir = getattr(worker, "session_log_dir", None)
    log_resident = (sum(r["size_bytes"]
                        for r in log_plane.list_log_files(log_dir))
                    if log_dir else 0)
    emit("ray_tpu_log_bytes_resident", "gauge",
         "bytes resident in this session's log capture files "
         "(shrinks under log rotation)", log_resident)

    # locality scheduling + transfer accounting (worker.transfer_stats)
    ts = getattr(worker, "transfer_stats", None) or {}
    emit("ray_tpu_sched_locality_hit_total", "counter",
         "remote dispatches whose located args were ALL resident on "
         "the chosen node (no cross-node arg transfer needed)",
         ts.get("locality_hits", 0))
    emit("ray_tpu_sched_locality_miss_total", "counter",
         "remote dispatches that needed at least one cross-node arg "
         "transfer", ts.get("locality_misses", 0))
    emit("ray_tpu_transfer_bytes_pulled_total", "counter",
         "object bytes moved across nodes (peer pulls and "
         "head-mediated fetches)", ts.get("bytes_pulled", 0))
    emit("ray_tpu_transfer_bytes_saved_total", "counter",
         "arg bytes already resident on the dispatch target "
         "(transfers avoided by locality-aware placement)",
         ts.get("bytes_saved", 0))

    # two-level scheduling + p2p actor plane (worker.two_level_stats;
    # schema-stable zeros while local_dispatch/actor_p2p are off)
    tl = getattr(worker, "two_level_stats", None) or {}
    emit("ray_tpu_sched_local_dispatch_total", "counter",
         "worker-submitted tasks admitted by a node's LocalScheduler "
         "without a head round-trip", tl.get("local_dispatch", 0))
    # spillback: bare total plus one labeled series per fixed reason
    # ("why does my task still spill?" — the README Scheduling section
    # maps each reason to its admission check). Reasons count on lazy
    # "spillback:<reason>" keys so the base stats schema is unchanged
    # while everything admits locally.
    lines.append("# HELP ray_tpu_sched_spillback_total local "
                 "submissions a node declined that spilled up to the "
                 "head scheduler, by admission-check reason")
    lines.append("# TYPE ray_tpu_sched_spillback_total counter")
    lines.append(f"ray_tpu_sched_spillback_total {tl.get('spillback', 0)}")
    for reason in SPILL_REASONS:
        lines.append(
            f'ray_tpu_sched_spillback_total{{reason="{reason}"}} '
            f"{tl.get('spillback:' + reason, 0)}")
    emit("ray_tpu_actor_calls_p2p_total", "counter",
         "actor calls executed worker-to-peer over the daemon lane "
         "(head saw only the completion receipt)", tl.get("p2p", 0))
    emit("ray_tpu_actor_calls_head_fallback_total", "counter",
         "p2p actor calls re-routed through the head path after a "
         "peer-lane drop/sever/timeout", tl.get("head_fallback", 0))

    # QoS plane (config.qos): preemptions by victim tier, per-tenant
    # queue/run gauges, and the fair-share deficit. Schema-stable
    # zeros when the plane is off: the bare totals always render, and
    # labeled series appear per tier/tenant the plane has actually
    # seen (no tenants exist while it is off).
    plane = getattr(worker, "qos_plane", None)
    qstats = plane.stats() if plane is not None else {}
    lines.append("# HELP ray_tpu_sched_preemptions_total running "
                 "tasks killed by the QoS plane to unblock a starved "
                 "higher tier, by victim tier (synthetic worker "
                 "death: the victim retries, exactly-once)")
    lines.append("# TYPE ray_tpu_sched_preemptions_total counter")
    lines.append(f"ray_tpu_sched_preemptions_total "
                 f"{qstats.get('preemptions_total', 0)}")
    for tier, n in sorted((qstats.get("preempts_by_tier") or {}).items()):
        lines.append(
            f'ray_tpu_sched_preemptions_total{{tier="{tier}"}} {n}')
    tenants = qstats.get("tenants") or {}
    lines.append("# HELP ray_tpu_tenant_queued_tasks tasks queued at "
                 "the head per QoS tenant")
    lines.append("# TYPE ray_tpu_tenant_queued_tasks gauge")
    lines.append(f"ray_tpu_tenant_queued_tasks "
                 f"{sum(t['queued'] for t in tenants.values())}")
    for name in sorted(tenants):
        lines.append(f'ray_tpu_tenant_queued_tasks{{tenant="{name}"}} '
                     f"{tenants[name]['queued']}")
    lines.append("# HELP ray_tpu_tenant_running_tasks dispatched "
                 "(running or leased) tasks per QoS tenant")
    lines.append("# TYPE ray_tpu_tenant_running_tasks gauge")
    lines.append(f"ray_tpu_tenant_running_tasks "
                 f"{sum(t['running'] for t in tenants.values())}")
    for name in sorted(tenants):
        lines.append(f'ray_tpu_tenant_running_tasks{{tenant="{name}"}} '
                     f"{tenants[name]['running']}")
    lines.append("# HELP ray_tpu_fairshare_deficit per-tenant "
                 "weighted fair-share deficit in dispatches (positive "
                 "= underserved relative to the tenant_quotas weight "
                 "share of everything dispatched so far)")
    lines.append("# TYPE ray_tpu_fairshare_deficit gauge")
    lines.append("ray_tpu_fairshare_deficit 0")
    for name in sorted(tenants):
        lines.append(f'ray_tpu_fairshare_deficit{{tenant="{name}"}} '
                     f"{tenants[name]['deficit']}")

    # task event plane: latency-breakdown histograms + failure counters
    from ray_tpu_torch._private import task_events
    lines.extend(task_events.render_prometheus(
        getattr(worker, "task_events", None)))

    # trace plane: span/trace accounting (zero-valued when the plane is
    # disabled so scrapers see a stable family set either way)
    tp = getattr(worker, "trace_plane", None)
    tsum = tp.summary() if tp is not None else {}
    emit("ray_tpu_trace_spans_recorded_total", "counter",
         "sampled spans recorded by the trace aggregator",
         tsum.get("spans_total", 0))
    emit("ray_tpu_trace_spans_dropped_total", "counter",
         "spans dropped by the per-trace span cap",
         tsum.get("spans_dropped", 0))
    emit("ray_tpu_trace_evicted_total", "counter",
         "whole traces evicted from the bounded trace ring "
         "(oldest-first, see config traces_max)",
         tsum.get("traces_evicted", 0))
    emit("ray_tpu_traces_resident", "gauge",
         "distinct traces currently resident in the trace aggregator",
         tsum.get("traces_resident", 0))
    emit("ray_tpu_trace_client_ops_total", "counter",
         "ray:// client operations recorded as trace spans "
         "(submit / create_actor / actor_call)",
         tsum.get("client_ops_total", 0))

    # head failover + daemon outbox plane: did this head replay a
    # journal at boot, and how much daemon-side traffic is buffered /
    # has been replayed across link drops
    emit("ray_tpu_head_failovers_total", "counter",
         "head restarts this GCS recovered from (journal replays that "
         "found prior state)", getattr(worker.gcs, "head_failovers", 0))
    outbox_depth = 0
    outbox_replayed = 0
    for e in worker.gcs.node_table():
        pool = e.pool
        if pool is not None and getattr(pool, "is_remote", False):
            outbox_depth += getattr(pool, "outbox_depth", 0)
            outbox_replayed += getattr(pool, "outbox_replayed", 0)
    emit("ray_tpu_daemon_outbox_depth", "gauge",
         "report-class daemon messages currently buffered awaiting "
         "head acknowledgement (summed over remote nodes)", outbox_depth)
    emit("ray_tpu_daemon_outbox_replayed_total", "counter",
         "buffered daemon messages re-sent after a link drop or head "
         "failover (summed over remote nodes)", outbox_replayed)

    # node-loss fault domain: whole-node deaths handled by the head's
    # node-death reconciler, and the fate of the adopted local leases
    # each death orphaned (resubmitted under their original return
    # oids vs dropped as fenced dead-era replays). Schema-stable zeros
    # while no node has ever died.
    emit("ray_tpu_node_deaths_total", "counter",
         "whole-node failures the head reconciled (daemon SIGKILL, "
         "lost link past the rejoin grace, stale heartbeat)",
         tl.get("node_deaths", 0))
    emit("ray_tpu_orphan_leases_retried_total", "counter",
         "locally-dispatched leases orphaned by a node death and "
         "resubmitted head-side under their original return oids",
         tl.get("orphan_retried", 0))
    emit("ray_tpu_orphan_leases_fenced_total", "counter",
         "stale outbox replay envelopes dropped by the epoch fence "
         "after a declared-dead node rejoined",
         tl.get("orphan_fenced", 0))

    # shared-memory control ring (local process pools): envelope
    # traffic vs pipe fallback. Schema-stable zeros when the ring is
    # disabled or no process pool exists.
    ring = {"msgs": 0, "bytes": 0, "fallback": 0, "full_waits": 0}
    for e in worker.gcs.node_table():
        rs = getattr(e.pool, "ring_stats", None)
        if rs:
            for k in ring:
                ring[k] += rs.get(k, 0)
    emit("ray_tpu_control_ring_msgs_total", "counter",
         "control messages (lease + completion envelopes) delivered "
         "over shm control rings", ring["msgs"])
    emit("ray_tpu_control_ring_bytes_total", "counter",
         "payload bytes carried by shm control-ring slots",
         ring["bytes"])
    emit("ray_tpu_control_ring_fallback_total", "counter",
         "control messages that fell back to the worker pipe "
         "(oversized envelope, full ring, or no ring)",
         ring["fallback"])
    emit("ray_tpu_control_ring_full_waits_total", "counter",
         "ring-full backpressure events observed by producers before "
         "falling back to the pipe", ring["full_waits"])

    # profile/utilization plane: sampler accounting + the latest value
    # of each node's resource series (zero-valued with an empty label
    # set when profile_hz=0 so scrapers see a stable family set)
    pp = getattr(worker, "profile_plane", None)
    psum = pp.summary() if pp is not None else {}
    emit("ray_tpu_profile_samples_recorded_total", "counter",
         "folded stack samples recorded by the head profile plane "
         "(all nodes)", psum.get("samples_recorded", 0))
    emit("ray_tpu_profile_samples_dropped_total", "counter",
         "stack samples lost to bounded sampler buffers or evicted "
         "from the head stack table",
         psum.get("samples_dropped", 0) + psum.get("stacks_evicted", 0))
    latest = pp.utilization_latest() if pp is not None else {}
    for name, desc, series in (
            ("ray_tpu_node_cpu_percent",
             "host CPU utilization sampled from /proc/stat deltas",
             "cpu_percent"),
            ("ray_tpu_node_rss_bytes",
             "resident set size of the node's runtime process",
             "rss_bytes"),
            ("ray_tpu_node_arena_used_bytes",
             "shm object-arena bytes in use on the node",
             "arena_used_bytes")):
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} gauge")
        total = 0.0
        for node in sorted(latest):
            v = latest[node].get(series)
            if v is None:
                continue
            lines.append(f'{name}{{node="{node}"}} {v}')
            total += v
        lines.append(f"{name} {round(total, 2)}")

    lines.extend(_render_serve())

    from ray_tpu_torch._private.chaos import get_controller
    chaos = get_controller().counters()
    for name, desc, per_site, total in (
            ("ray_tpu_chaos_injected_total",
             "faults injected by the chaos controller",
             chaos["injected"], chaos["injected_total"]),
            ("ray_tpu_chaos_recovered_total",
             "injected faults the runtime detected and recovered from",
             chaos["recovered"], chaos["recovered_total"])):
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} counter")
        for site in sorted(per_site):
            lines.append(f'{name}{{site="{_escape_label(site)}"}} '
                         f'{per_site[site]}')
        lines.append(f"{name} {total}")
    return lines


def render_all(worker) -> str:
    lines = _render_core(worker)
    with _user_lock:
        metrics = list(_user_metrics.values())
    for m in metrics:
        lines.extend(m.render())
    return "\n".join(lines) + "\n"


class MetricsServer:
    def __init__(self, worker, port: int):
        self.port = port
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = render_all(worker).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ray_tpu_metrics")
        self._thread.start()

    def shutdown(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
