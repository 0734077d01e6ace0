"""Cluster-state checkpoint/resume.

Reference role: GCS fault tolerance (ray: src/ray/gcs/ — with Redis
persistence the GCS restarts and replays its tables) plus SURVEY §5's
TPU-native addition: the checkpoint also captures the SCHEDULER'S
device-resident tensors, and pending work resubmits on restore (specs
travel by cloudpickle, results land under their ORIGINAL object ids so
pre-snapshot refs resolve in the restored session).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import cloudpickle

FORMAT_VERSION = 1


def save_cluster_state(worker, path: str) -> Dict[str, Any]:
    """Snapshot control-plane tables + scheduler state to ``path``."""
    gcs = worker.gcs

    def _started(task_id) -> bool:
        """Window-leased tasks queued behind a worker are resubmittable;
        anything observed executing (thread registry or leased onto a
        worker pipe) is not."""
        with worker._running_lock:
            if task_id in worker._running_tasks:
                return True
        for pool in list(worker._node_pools.values()):
            with pool._lock:
                if task_id in pool._by_task:
                    return True
        return False

    try:
        pending = worker.scheduler.pending_entries(_started)
    except TypeError:  # EventScheduler: no window leases exist
        pending = worker.scheduler.pending_entries()
    snap = {
        "version": FORMAT_VERSION,
        "time": time.time(),
        "kv": {f"{ns}\x00{k.decode('latin1')}": v
               for (ns, k), v in gcs._kv.items()},
        "jobs": {j.hex(): dict(meta) for j, meta in
                 gcs.job_table().items()},
        "actors": [
            {"actor_id": e.actor_id.hex(), "name": e.name,
             "namespace": e.namespace, "class_name": e.class_name,
             "state": e.state, "node_index": e.node_index}
            for e in gcs.actor_table()
        ],
        "placement_groups": worker.placement_groups.table(),
        "pending_tasks": [],
        "unsnapshottable_tasks": 0,
        "scheduler_arrays": worker.scheduler.device_state_snapshot(),
        "scheduler_stats": worker.scheduler.stats(),
    }
    for spec, deps in pending:
        try:
            blob = cloudpickle.dumps(spec)
        except Exception:
            # a spec closing over unpicklable state (locks, sockets)
            # cannot travel; count it honestly rather than failing the
            # whole snapshot
            snap["unsnapshottable_tasks"] += 1
            continue
        # deps recompute from the spec at restore; only the spec travels
        snap["pending_tasks"].append({"spec": blob})
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        cloudpickle.dump(snap, f)
    os.replace(tmp, path)
    return {"pending_tasks": len(snap["pending_tasks"]),
            "unsnapshottable_tasks": snap["unsnapshottable_tasks"],
            "kv_entries": len(snap["kv"]),
            "actors": len(snap["actors"])}


def load_cluster_state(worker, path: str) -> Dict[str, Any]:
    """Restore into a (fresh) session: KV entries re-populate, and every
    snapshotted pending task RESUBMITS — results store under the
    original return ids, so ObjectRefs reconstructed from the snapshot
    epoch resolve here. Actors are metadata-only in the snapshot (their
    instances died with the old process; the reference restarts them
    through the FSM — callers re-create from the recorded class names)."""
    with open(path, "rb") as f:
        snap = cloudpickle.load(f)
    if snap.get("version") != FORMAT_VERSION:
        raise ValueError(f"snapshot version {snap.get('version')} != "
                         f"{FORMAT_VERSION}")
    for key, v in snap["kv"].items():
        ns, _, k = key.partition("\x00")
        worker.gcs.kv_put(k.encode("latin1"), v, namespace=ns)

    from ray_tpu_torch._private.scheduler.base import PendingTask

    resubmitted = 0
    for entry in snap["pending_tasks"]:
        spec = cloudpickle.loads(entry["spec"])
        return_ids = (getattr(spec, "_retry_return_ids", None)
                      or spec.return_ids())
        for oid in return_ids:
            worker.reference_counter.add_owned_object(
                oid, lineage_task=spec.task_id)
        from ray_tpu_torch._private.worker import _top_level_deps

        deps = _top_level_deps(spec.args, spec.kwargs)
        worker.reference_counter.add_submitted_task_references(deps)
        worker.task_manager.add_pending(spec, deps)
        unresolved = [d for d in deps
                      if not worker.memory_store.contains(d)]
        for d in unresolved:
            worker.object_recovery.maybe_recover(d)
        worker.scheduler.submit(PendingTask(spec=spec, deps=unresolved,
                                            execute=lambda t, n: None))
        resubmitted += 1
    return {"resubmitted_tasks": resubmitted,
            "kv_entries": len(snap["kv"]),
            "snapshot_time": snap["time"],
            "actors_recorded": len(snap["actors"])}
