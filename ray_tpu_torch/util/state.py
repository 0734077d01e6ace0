"""State observability API.

Reference: ray.util.state (ray: python/ray/util/state/ — list_tasks /
list_actors / list_objects / list_nodes, summarize). The task verbs
read straight off the scheduler's live tables — for the tensor
scheduler that IS the device-array state (the survey's "a `list tasks`
that reads back the scheduler tensors").
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod


def _client_dispatch(fn):
    """In client mode, run the verb HEAD-side over the session (the GCS
    client accessor analog — `ray list ...` from any process). The
    driver-side body below each decorated function only ever executes
    in-process, where worker.scheduler/.gcs exist. Arguments (e.g.
    get_log's filename/node_id/tail) normalize to positionals so they
    ride the client's ("state", verb, *args) RPC unchanged."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        w = worker_mod.get_worker()
        if getattr(w, "is_client", False):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return w.state(fn.__name__, *bound.args)
        return fn(*args, **kwargs)
    return wrapper


@_client_dispatch
def list_tasks(detail: bool = False,
               state: Optional[str] = None) -> List[Dict[str, Any]]:
    """Live (queued/pending/running) tasks from the scheduler arrays.

    ``detail=True`` widens the result in two ways: live rows gain
    per-transition timestamps from the task event plane, and the bounded
    ring of FINISHED/FAILED records is appended — tasks remain queryable
    after they leave the scheduler (reference: ray list tasks
    --detail). ``state=`` filters both sets ("FINISHED", "FAILED", or
    any live scheduler state)."""
    w = worker_mod.get_worker()
    rows = w.scheduler.task_table()
    if state is not None:
        rows = [r for r in rows if r["state"] == state]
    if not detail:
        return rows
    te = getattr(w, "task_events", None)
    if te is None:
        return rows
    live = te.live_detail()
    for r in rows:
        d = live.get(r["task_id"])
        if d:
            r.update(d)
    return rows + te.dead_rows(state)


@_client_dispatch
def list_actors() -> List[Dict[str, Any]]:
    """All actors from the GCS actor table (the registry of record)."""
    w = worker_mod.get_worker()
    rows = []
    for e in w.gcs.actor_table():
        row = {"actor_id": e.actor_id.hex(), "name": e.name,
               "namespace": e.namespace, "class_name": e.class_name,
               "state": e.state, "node_index": e.node_index}
        # p2p routing identity: (node_index, (host, port), worker_num)
        # when the actor is reachable over a peer daemon link, else None
        # — the address worker-side .remote() calls ship envelopes to
        # when actor_p2p is on.
        resolve = getattr(w, "resolve_actor_address", None)
        addr = resolve(e.actor_id.binary()) if resolve is not None else None
        if addr is not None:
            row["resolved_address"] = {"node_index": addr[0],
                                       "peer": list(addr[1]),
                                       "worker_num": addr[2]}
        else:
            row["resolved_address"] = None
        rows.append(row)
    return rows


@_client_dispatch
def list_objects(locations: bool = False) -> List[Dict[str, Any]]:
    """Objects in the owner's store (+ shm residency and pin counts).

    ``locations=True`` adds each object's node rows from the GCS object
    directory, primary copy first — staged secondary copies (peer pulls
    completed by the locality-aware dispatcher) show up here. An empty
    list means the object lives only in the head's store."""
    w = worker_mod.get_worker()
    rows = []
    for oid, entry in w.memory_store.entries():
        row = {
            "object_id": oid.hex(),
            "is_exception": entry.is_exception,
            "size": entry.size,
            "in_shm": (w.shm_store is not None
                       and w.shm_store.locate(oid) is not None),
            "local_refs": w.reference_counter.num_local_references(oid),
        }
        if locations:
            row["locations"] = w.gcs.object_locations(oid)
        rows.append(row)
    return rows


@_client_dispatch
def list_nodes() -> List[Dict[str, Any]]:
    import time

    w = worker_mod.get_worker()
    now = time.monotonic()
    rows = []
    for e in w.gcs.node_table():
        row = {"node_id": e.node_id.hex(), "index": e.index,
               "state": e.state,
               "kind": e.kind, "resources": dict(e.resources),
               # seconds since the GCS last recorded a heartbeat; compare
               # against config node_heartbeat_timeout_s to spot nodes the
               # staleness monitor is about to declare dead
               "heartbeat_age_s": round(now - e.last_heartbeat, 3)}
        if e.state == "REJOINING" and e.rejoining_since is not None:
            # how long the daemon link has been down; escalates to DEAD
            # once it passes config daemon_rejoin_grace_s
            row["rejoining_for_s"] = round(now - e.rejoining_since, 3)
        if e.state == "DEAD":
            # why the node-death reconciler fired (chaos machine-death,
            # expired rejoin grace, stale heartbeat, ...)
            row["death_reason"] = getattr(e, "death_reason", "") or ""
        pool = e.pool
        if pool is not None and getattr(pool, "is_remote", False):
            # outbox telemetry (same numbers as the metrics endpoint's
            # ray_tpu_daemon_outbox_* families, but per node): depth is
            # the daemon's unacked backlog, replayed counts envelopes
            # re-delivered after rejoins
            row["outbox_depth"] = getattr(pool, "outbox_depth", 0)
            row["outbox_replayed"] = getattr(pool, "outbox_replayed", 0)
            # two-level scheduling telemetry: tasks currently admitted
            # by the node's LocalScheduler but not yet completed, and
            # the lifetime count of local admissions (same numbers the
            # dashboard nodes panel shows)
            depth_fn = getattr(pool, "local_queue_depth", None)
            row["local_queue_depth"] = depth_fn() if depth_fn else 0
            row["local_dispatched"] = getattr(pool, "local_dispatched", 0)
            # per-reason spillback counters (why did submissions from
            # this node consult the head?) and resource-view freshness:
            # seconds since the head last pushed its view to the node's
            # daemon — None when no push ever went out (knobs off)
            row["spill_reasons"] = dict(
                getattr(pool, "spill_reasons", None) or {})
            t = getattr(pool, "_resview_t", None)
            row["resview_age_s"] = (round(now - t, 3)
                                    if t is not None else None)
        rows.append(row)
    return rows


@_client_dispatch
def list_faults() -> List[Dict[str, Any]]:
    """Faults the chaos controller has injected this run, in injection
    order: {seq, site, kind, when, context}. Same-seed runs of the same
    workload produce the identical sequence — the reproducibility
    receipt for chaos-soak tests."""
    from ray_tpu_torch._private.chaos import get_controller

    return get_controller().list_faults()


@_client_dispatch
def list_placement_groups() -> List[Dict[str, Any]]:
    w = worker_mod.get_worker()
    return [dict(info, pg_id=pg_id)
            for pg_id, info in w.placement_groups.table().items()]


@_client_dispatch
def list_tenants() -> List[Dict[str, Any]]:
    """QoS plane tenants (config.qos), one row per tenant seen this
    session: fair-share weight and share, served/queued/running/
    preempted counts, and the deficit (positive = underserved relative
    to the tenant's weight share of all dispatches so far). Empty when
    the plane is off."""
    w = worker_mod.get_worker()
    plane = getattr(w, "qos_plane", None)
    if plane is None:
        return []
    stats = plane.stats()
    return [dict(info, tenant=name)
            for name, info in sorted(stats["tenants"].items())]


@_client_dispatch
def list_serve_deployments() -> List[Dict[str, Any]]:
    """Serving deployments from the live serve controller, one row per
    deployment: replica count, in-flight calls, sticky sessions,
    version, and the declared autoscaling metric (None = fixed-size;
    "ttft"/"sessions" mark the disaggregated pools). Empty when
    serve was never started in this session."""
    import sys

    core = sys.modules.get("ray_tpu_torch.serve.core")
    if core is None:
        return []
    return core.serving_stats()["deployments"]


@_client_dispatch
def list_data_streams() -> List[Dict[str, Any]]:
    """Streaming-split ingest stats: one row per live
    Dataset.streaming_split coordinator plus the last few shut-down
    ones (per-consumer blocks/bytes consumed, wait time, and the
    producer/consumer overlap fraction)."""
    from ray_tpu_torch.data._streaming import split_coordinator_stats

    return split_coordinator_stats()


def _remote_log_node(w, node_id: str):
    """The GCS entry for an off-head node addressed by id hex (prefix
    match allowed, like the CLI's id handling elsewhere)."""
    for e in w.gcs.node_table():
        if e.node_id.hex().startswith(node_id):
            return e
    raise ValueError(f"unknown node_id: {node_id!r}")


@_client_dispatch
def list_logs(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Capture files in the session log dir, one row per file:
    {filename, size_bytes, mtime, node_id}. ``node_id=None`` spans the
    whole cluster (head dir + every remote node's dir, queried over
    the daemon links)."""
    from ray_tpu_torch._private import log_plane

    w = worker_mod.get_worker()
    head_hex = w.node_id.hex()

    def _head_rows() -> List[Dict[str, Any]]:
        if w.session_log_dir is None:
            return []
        return [dict(r, node_id=head_hex)
                for r in log_plane.list_log_files(w.session_log_dir)]

    if node_id is None:
        rows = _head_rows()
        for e in w.gcs.node_table():
            if e.kind == "remote" and e.state == "ALIVE" \
                    and e.pool is not None:
                rows.extend(dict(r, node_id=e.node_id.hex())
                            for r in e.pool.list_logs_remote())
        return rows
    if head_hex.startswith(node_id):
        return _head_rows()
    e = _remote_log_node(w, node_id)
    if e.kind != "remote" or e.pool is None:
        # local virtual nodes share the head's session dir
        return _head_rows()
    return [dict(r, node_id=e.node_id.hex())
            for r in e.pool.list_logs_remote()]


@_client_dispatch
def get_log(filename: str, node_id: Optional[str] = None,
            tail: Optional[int] = None) -> str:
    """Contents of one capture file (last ``tail`` lines when set).
    ``node_id=None`` / the head's id reads the head session dir;
    an off-head id fetches over that node's daemon link."""
    from ray_tpu_torch._private import log_plane

    w = worker_mod.get_worker()
    if node_id is not None and not w.node_id.hex().startswith(node_id):
        e = _remote_log_node(w, node_id)
        if e.kind == "remote" and e.pool is not None:
            return e.pool.fetch_log_remote(filename, tail)
    if w.session_log_dir is None:
        raise FileNotFoundError("log capture is disabled (no session "
                                "log dir)")
    return log_plane.read_log(w.session_log_dir, filename, tail)


@_client_dispatch
def task_timeline() -> List[Dict[str, Any]]:
    """Chrome-trace events for the cluster-wide task event plane: one
    scheduler lane (dep-wait + queue spans) and one lane per (node,
    worker) with exec spans, all on the head's clock axis. Falls back to
    the driver-local EventBuffer when task events are disabled
    (``task_events_max=0``)."""
    from ray_tpu_torch._private import events

    w = worker_mod.get_worker()
    te = getattr(w, "task_events", None)
    if te is not None:
        return te.timeline()
    return events.plane_disabled_timeline(w)


@_client_dispatch
def list_traces() -> List[Dict[str, Any]]:
    """Resident traces from the trace plane, most recently active
    first: {trace_id, root, spans, live_spans, failed, first_ts,
    last_ts}. Empty when the plane is disabled
    (``trace_sample_rate=0`` or ``traces_max=0``)."""
    w = worker_mod.get_worker()
    tp = getattr(w, "trace_plane", None)
    if tp is None:
        return []
    return tp.list_traces()


@_client_dispatch
def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Perfetto/Chrome-trace events for ONE trace (id prefix match
    allowed): the driver lane holds each logical span submit→resolve,
    the scheduler lane the per-attempt decision windows, per-(node,
    worker) lanes the exec windows on the head's clock axis, with flow
    arrows connecting dispatch→exec and parent exec→child exec across
    lanes. Falls back to the same driver-local EventBuffer degradation
    path as ``task_timeline`` when the plane is disabled."""
    from ray_tpu_torch._private import events

    w = worker_mod.get_worker()
    tp = getattr(w, "trace_plane", None)
    if tp is None:
        return events.plane_disabled_timeline(w)
    return tp.trace(trace_id)


@_client_dispatch
def profile_stacks() -> List[Dict[str, Any]]:
    """Resident folded-stack counts from the profile plane, highest
    sample count first: {node, node_id, task, stack, count} where
    ``task`` is "name:taskid8" for samples taken inside a task and
    "idle"/a thread name otherwise. Empty when the plane is disabled
    (``profile_hz=0``, the default)."""
    w = worker_mod.get_worker()
    pp = getattr(w, "profile_plane", None)
    if pp is None:
        return []
    ids = {e.index: e.node_id.hex() for e in w.gcs.node_table()}
    rows = pp.profile_stacks()
    for r in rows:
        r["node_id"] = ids.get(r["node"], "")
    return rows


@_client_dispatch
def list_utilization(node_id: Optional[str] = None,
                     series: Optional[str] = None) -> List[Dict[str, Any]]:
    """Utilization time series from the profile plane's head-side
    ring: {node, node_id, series, points: [[ts, value], ...]} with
    every timestamp on the HEAD's clock axis (daemon samples are
    shifted by the link's clock offset). ``node_id`` prefix-filters
    like ``get_trace``; ``series`` selects one series (e.g.
    "cpu_percent"). Empty when the plane is disabled
    (``profile_hz=0``)."""
    w = worker_mod.get_worker()
    pp = getattr(w, "profile_plane", None)
    if pp is None:
        return []
    ids = {e.index: e.node_id.hex() for e in w.gcs.node_table()}
    out = []
    for r in pp.list_utilization(series=series):
        nid = ids.get(r["node"], "")
        if node_id is not None and not nid.startswith(node_id):
            continue
        r["node_id"] = nid
        out.append(r)
    return out


@_client_dispatch
def summarize_tasks() -> Dict[str, int]:
    """Counts by state (reference: ray summary tasks). Includes
    FAILED_TOTAL and per-error-type FAILED(<Type>) counts from the task
    event plane (terminal + retried attempts both count)."""
    out: Dict[str, int] = {}
    for row in list_tasks():
        out[row["state"]] = out.get(row["state"], 0) + 1
    w = worker_mod.get_worker()
    stats = w.scheduler.stats()
    out["FINISHED_TOTAL"] = stats.get("finished", 0)
    te = getattr(w, "task_events", None)
    if te is None:
        out["FAILED_TOTAL"] = 0
        return out
    s = te.summary()
    out["FAILED_TOTAL"] = s["failed_total"]
    for etype, n in sorted(s["failed_by_type"].items()):
        out[f"FAILED({etype})"] = n
    return out
