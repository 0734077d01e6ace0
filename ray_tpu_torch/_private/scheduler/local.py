"""Event-driven scheduler — the semantics oracle.

Per-event O(1) decisions in the style of the reference's
ClusterTaskManager::QueueAndScheduleTask + LocalTaskManager dispatch
(ray: src/ray/raylet/scheduling/cluster_task_manager.cc,
local_task_manager.cc): tasks wait for dependencies, then for resources,
then dispatch. Node selection uses the hybrid policy analog: prefer the
least-loaded feasible node, preferring node 0 (local) until its load
crosses the configured threshold.

The tensorized scheduler (scheduler/tensor.py) must make decisions
consistent with this one; property tests drive both with the same task
graphs.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.scheduler.base import PendingTask, SchedulerBase
from ray_tpu_torch._private.task_spec import custom_resources, resources_to_vector


class NodeState:
    __slots__ = ("capacity", "available", "node_id", "pg_id", "bundle_index",
                 "parent", "defunct", "custom", "custom_avail",
                 "window_factor")

    def __init__(self, capacity: Tuple[float, ...], node_id=None,
                 pg_id=None, bundle_index: int = -1, parent: int = -1,
                 custom_resources: Optional[Dict[str, float]] = None,
                 window_factor: int = 1):
        self.capacity = list(capacity)
        self.available = list(capacity)
        self.node_id = node_id
        # declared NAMED resources: per-name placement feasibility rides
        # the eligibility masks; per-name QUANTITY is debited host-side
        # at allocate/release (the batched kernel sees the aggregate
        # CUSTOM dimension; the per-name check is re-validated at apply)
        self.custom: Dict[str, float] = dict(custom_resources or {})
        self.custom_avail: Dict[str, float] = dict(self.custom)
        # bundle rows: a committed placement-group bundle is a virtual
        # node whose capacity was carved out of ``parent``'s availability
        # (reference: PG bundles become per-bundle resources,
        # ray: src/ray/gcs/gcs_server/gcs_placement_group_scheduler.cc)
        self.pg_id = pg_id              # None = physical node
        self.bundle_index = bundle_index
        self.parent = parent
        # removed PG whose in-flight tasks haven't finished: remaining
        # capacity returns to the parent as each task releases
        self.defunct = False
        # dispatch window (reference: the raylet's local dispatch queue
        # + ReportWorkerBacklog): simple CPU-only tasks may be leased to
        # this node up to window_factor x cpu-capacity OUTSTANDING, the
        # excess queueing at the node's pool; real concurrency stays
        # bounded by the pool's worker processes. 1 = strict (no
        # over-dispatch). Only >1 for process-pool nodes on
        # oversubscribed hosts.
        self.window_factor = window_factor

    @property
    def is_bundle(self) -> bool:
        return self.pg_id is not None

    def has_custom(self, custom: Dict[str, float]) -> bool:
        """Per-name feasibility: every named demand must be declared on
        the node at sufficient capacity."""
        return all(self.custom.get(k, 0.0) >= v for k, v in custom.items())

    def fits_custom(self, custom: Dict[str, float]) -> bool:
        """Per-name availability (has_custom checks declared capacity)."""
        return all(self.custom_avail.get(k, 0.0) >= v - 1e-9
                   for k, v in custom.items())

    def allocate_custom(self, custom: Dict[str, float]) -> None:
        for k, v in custom.items():
            self.custom_avail[k] = self.custom_avail.get(k, 0.0) - v

    def release_custom(self, custom: Dict[str, float]) -> None:
        for k, v in custom.items():
            self.custom_avail[k] = min(
                self.custom_avail.get(k, 0.0) + v, self.custom.get(k, 0.0))

    def fits(self, demand: Tuple[float, ...]) -> bool:
        return all(a >= d for a, d in zip(self.available, demand))

    def feasible(self, demand: Tuple[float, ...]) -> bool:
        return all(c >= d for c, d in zip(self.capacity, demand))

    def allocate(self, demand: Tuple[float, ...]) -> None:
        for i, d in enumerate(demand):
            self.available[i] -= d

    def release(self, demand: Tuple[float, ...]) -> None:
        for i, d in enumerate(demand):
            self.available[i] = min(self.available[i] + d, self.capacity[i])

    def load(self) -> float:
        """Fraction of the binding resource in use."""
        worst = 0.0
        for c, a in zip(self.capacity, self.available):
            if c > 0:
                worst = max(worst, (c - a) / c)
        return worst


class EventScheduler(SchedulerBase):
    def __init__(self, nodes: List[NodeState],
                 dispatcher: Callable[[PendingTask], None],
                 store_contains: Optional[Callable[[ObjectID], bool]] = None):
        """dispatcher runs the task (typically enqueues to an executor pool);
        it must call notify_task_finished when done. store_contains is
        checked under the scheduler lock so an object becoming ready
        concurrently with submit() cannot be missed."""
        self._nodes = nodes
        self._dispatch = dispatcher
        self._store_contains = store_contains or (lambda oid: False)
        self._lock = threading.Lock()
        # object_id -> tasks waiting on it
        self._waiters: Dict[ObjectID, List[PendingTask]] = {}
        self._dep_count: Dict[TaskID, int] = {}
        self._tasks: Dict[TaskID, PendingTask] = {}
        self._ready: Deque[PendingTask] = collections.deque()
        self._infeasible: List[PendingTask] = []
        self._num_submitted = 0
        self._num_dispatched = 0
        self._num_finished = 0
        # per-node leases outstanding (dispatched, not yet finished):
        # the spillback bound for locality preference reads this
        self._outstanding: Dict[int, int] = {}

    # -- SchedulerBase -----------------------------------------------------
    def submit(self, task: PendingTask) -> None:
        to_dispatch = []
        with self._lock:
            self._num_submitted += 1
            self._tasks[task.spec.task_id] = task
            remaining = 0
            for dep in task.deps:
                if self._store_contains(dep):
                    continue
                self._waiters.setdefault(dep, []).append(task)
                remaining += 1
            if remaining == 0:
                self._ready.append(task)
            else:
                self._dep_count[task.spec.task_id] = remaining
            to_dispatch = self._drain_ready_locked()
        self._run_dispatch(to_dispatch)

    def notify_object_ready(self, object_id: ObjectID) -> None:
        to_dispatch = []
        newly_ready = []
        with self._lock:
            for task in self._waiters.pop(object_id, []):
                tid = task.spec.task_id
                if tid not in self._dep_count:
                    continue
                self._dep_count[tid] -= 1
                if self._dep_count[tid] == 0:
                    del self._dep_count[tid]
                    self._ready.append(task)
                    newly_ready.append(tid)
            to_dispatch = self._drain_ready_locked()
        if newly_ready:
            te = self.task_events
            if te is not None:
                te.record_ready_batch(newly_ready)
        self._run_dispatch(to_dispatch)

    def notify_task_finished(self, task_id: TaskID, node_index: int,
                             resources: Dict[str, float]) -> None:
        to_dispatch = []
        with self._lock:
            self._num_finished += 1
            self._tasks.pop(task_id, None)
            if node_index in self._outstanding:
                self._outstanding[node_index] -= 1
                if self._outstanding[node_index] <= 0:
                    del self._outstanding[node_index]
            if 0 <= node_index < len(self._nodes):
                node = self._nodes[node_index]
                vec = resources_to_vector(resources)
                custom = custom_resources(resources)
                if node.defunct:
                    # removed bundle: this task's share of the carved-out
                    # capacity returns to the parent now that it is free
                    self._nodes[node.parent].release(vec)
                    self._nodes[node.parent].release_custom(custom)
                    node.capacity = [max(c - v, 0.0)
                                     for c, v in zip(node.capacity, vec)]
                else:
                    node.release(vec)
                    node.release_custom(custom)
            to_dispatch = self._drain_ready_locked()
        self._run_dispatch(to_dispatch)

    def cancel(self, task_id: TaskID) -> bool:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None or task.node_index >= 0:
                return False  # unknown or already dispatched
            task.cancelled = True
            self._tasks.pop(task_id, None)
            self._dep_count.pop(task_id, None)
            try:
                self._ready.remove(task)
            except ValueError:
                pass
            return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "submitted": self._num_submitted,
                "dispatched": self._num_dispatched,
                "finished": self._num_finished,
                "local_dispatch": self._num_local_dispatch,
                "spillback": self._num_spillback,
                "waiting_deps": len(self._dep_count),
                "ready_queue": len(self._ready),
                "infeasible": len(self._infeasible),
                "nodes": [
                    {"available": list(n.available),
                     "capacity": list(n.capacity),
                     "is_bundle": n.is_bundle,
                     "custom": dict(n.custom),
                     "custom_avail": dict(n.custom_avail)}
                    for n in self._nodes
                ],
            }

    def shutdown(self) -> None:
        with self._lock:
            self._ready.clear()
            self._waiters.clear()
            self._dep_count.clear()

    def pending_entries(self):
        """(spec, unresolved deps) for every not-yet-dispatched task."""
        with self._lock:
            seen = set()
            out = []
            # cancelled tasks linger in _waiters/_infeasible (cancel()
            # pops the other indexes); a snapshot must not resurrect them
            for bucket in (self._ready, self._infeasible):
                for t in bucket:
                    if not t.cancelled and t.spec.task_id not in seen:
                        seen.add(t.spec.task_id)
                        out.append((t.spec, list(t.deps)))
            for waiters in self._waiters.values():
                for t in waiters:
                    if not t.cancelled and t.spec.task_id not in seen:
                        seen.add(t.spec.task_id)
                        out.append((t.spec, list(t.deps)))
            return out

    def device_state_snapshot(self):
        return {}  # the oracle keeps no array state

    def task_table(self) -> List[Dict[str, Any]]:
        """Live tasks (oracle-scheduler view; mirrors
        TensorScheduler.task_table)."""
        with self._lock:
            rows = []
            ready_ids = {t.spec.task_id for t in self._ready}
            infeasible_ids = {t.spec.task_id for t in self._infeasible}
            for tid, task in self._tasks.items():
                if tid in self._dep_count:
                    state = "PENDING_ARGS"
                elif tid in infeasible_ids:
                    state = "INFEASIBLE"
                elif tid in ready_ids:
                    state = "PENDING_NODE"
                elif task.node_index >= 0:
                    state = "RUNNING"
                else:
                    state = "PENDING_NODE"
                rows.append({
                    "task_id": tid.hex(),
                    "name": task.spec.name,
                    "state": state,
                    "node_index": task.node_index,
                    "attempt": task.spec.attempt_number,
                    "scheduling_class": -1,
                })
            return rows

    def node_state(self, index: int) -> Optional[NodeState]:
        with self._lock:
            return self._nodes[index] if 0 <= index < len(self._nodes) \
                else None

    def try_allocate(self, index: int, resources: Dict[str, float]) -> bool:
        """Directly charge a row if it fits (actor restart-elsewhere:
        the replacement node must account for the actor's resources)."""
        vec = resources_to_vector(resources)
        custom = custom_resources(resources)
        with self._lock:
            if not (0 <= index < len(self._nodes)):
                return False
            n = self._nodes[index]
            if n.fits(vec) and any(c > 0 for c in n.capacity) \
                    and n.has_custom(custom) and n.fits_custom(custom):
                n.allocate(vec)
                n.allocate_custom(custom)
                return True
            return False

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    # -- node management (used by the virtual cluster test util) -----------
    def add_node(self, node: NodeState, wake: bool = True) -> int:
        """wake=False defers dispatch until the caller finishes wiring
        the node (pool registration) and calls poke() — see
        TensorScheduler.add_node."""
        with self._lock:
            self._nodes.append(node)
            idx = len(self._nodes) - 1
        if wake:
            # a new node can make previously-infeasible tasks feasible
            self.poke()
        return idx

    def poke(self) -> None:
        to_dispatch = []
        with self._lock:
            if self._infeasible:
                self._ready.extend(self._infeasible)
                self._infeasible.clear()
            to_dispatch = self._drain_ready_locked()
        self._run_dispatch(to_dispatch)

    def remove_node(self, node_index: int) -> None:
        with self._lock:
            self._nodes[node_index].capacity = [0.0] * len(
                self._nodes[node_index].capacity)
            self._nodes[node_index].available = [0.0] * len(
                self._nodes[node_index].available)
            # a dead node's named resources leave the cluster with it
            self._nodes[node_index].custom = {}
            self._nodes[node_index].custom_avail = {}

    # -- placement groups ---------------------------------------------------
    def pack_snapshot(self):
        """(avail [N,R], cap [N,R], row indices) over PHYSICAL nodes only —
        the input to the placement-group bin-pack solve."""
        import numpy as np

        with self._lock:
            rows = [i for i, n in enumerate(self._nodes) if not n.is_bundle]
            avail = np.asarray([self._nodes[i].available for i in rows],
                               dtype=np.float32)
            cap = np.asarray([self._nodes[i].capacity for i in rows],
                             dtype=np.float32)
            return avail, cap, rows

    def add_bundle_nodes(self, pg_id, placements) -> Optional[List[int]]:
        """Atomically reserve bundles: placements = [(parent_row,
        demand_vec, custom_dict), ...] in bundle order. All-or-nothing:
        validates every reservation against current availability first
        (2-phase commit of the reference's PrepareBundleResources/
        CommitBundleResources,
        ray: src/ray/raylet/placement_group_resource_manager.cc). Returns
        the new bundle row indices, or None if any reservation no longer
        fits (caller repacks against a fresh snapshot)."""
        to_dispatch: List[PendingTask] = []
        with self._lock:
            need: Dict[int, List[float]] = {}
            for parent, vec, _custom in placements:
                acc = need.setdefault(parent, [0.0] * len(vec))
                for i, v in enumerate(vec):
                    acc[i] += v
            for parent, total in need.items():
                if not self._nodes[parent].fits(tuple(total)):
                    return None
            rows = []
            for bindex, (parent, vec, custom) in enumerate(placements):
                self._nodes[parent].allocate(tuple(vec))
                self._nodes[parent].allocate_custom(custom)
                self._nodes.append(NodeState(
                    tuple(vec), node_id=self._nodes[parent].node_id,
                    pg_id=pg_id, bundle_index=bindex, parent=parent,
                    custom_resources=custom))
                rows.append(len(self._nodes) - 1)
            # bundle rows make parked PG tasks feasible
            if self._infeasible:
                self._ready.extend(self._infeasible)
                self._infeasible.clear()
            to_dispatch = self._drain_ready_locked()
        self._run_dispatch(to_dispatch)
        return rows

    def drain_pg_tasks(self, pg_id) -> List[PendingTask]:
        """Remove and return every not-yet-dispatched task targeting the
        group (its rows are gone; leaving them queued would hang their
        callers forever)."""
        pid = pg_id.binary()

        def match(t: PendingTask) -> bool:
            p = t.spec.placement_group_id
            return p is not None and p.binary() == pid

        out: List[PendingTask] = []
        with self._lock:
            for bucket in (self._ready, self._infeasible):
                kept = [t for t in bucket if not match(t)]
                out.extend(t for t in bucket if match(t))
                bucket.clear()
                bucket.extend(kept)
            for oid, waiters in list(self._waiters.items()):
                kept = [t for t in waiters if not match(t)]
                out.extend(t for t in waiters if match(t))
                if kept:
                    self._waiters[oid] = kept
                else:
                    del self._waiters[oid]
            seen = set()
            uniq = []
            for t in out:
                tid = t.spec.task_id
                if tid in seen:
                    continue
                seen.add(tid)
                uniq.append(t)
                self._tasks.pop(tid, None)
                self._dep_count.pop(tid, None)
        return uniq

    def remove_pg(self, pg_id) -> None:
        """Release a placement group's bundle rows back to their parents.

        Only the FREE part of each bundle returns immediately; capacity
        held by still-running tasks stays charged against the bundle (the
        row goes ``defunct``) and flows back to the parent task-by-task in
        notify_task_finished — releasing it all at once would overcommit
        the parent while those tasks still occupy it. Rows are zeroed, not
        deleted: indices held by in-flight tasks stay valid."""
        with self._lock:
            for n in self._nodes:
                if n.pg_id == pg_id and not n.defunct \
                        and any(c > 0 for c in n.capacity):
                    parent = self._nodes[n.parent]
                    parent.release(tuple(n.available))
                    # unused named resources return now; the in-use part
                    # follows task-by-task via the defunct completion path
                    parent.release_custom(n.custom_avail)
                    in_use = [c - a for c, a in zip(n.capacity, n.available)]
                    n.capacity = in_use
                    n.available = [0.0] * len(n.available)
                    n.defunct = True

    # -- internals ---------------------------------------------------------
    def _drain_ready_locked(self) -> List[PendingTask]:
        """Pop ready tasks whose resources fit; assign nodes (hybrid policy)."""
        out = []
        threshold = GLOBAL_CONFIG.sched_hybrid_threshold
        locality_on = (GLOBAL_CONFIG.scheduler_locality
                       and self.locations_of is not None)
        spill_depth = GLOBAL_CONFIG.locality_spillback_queue_depth
        plane = self.qos_plane
        if plane is not None and len(self._ready) > 1:
            # QoS drain order: strict tiers first, weighted fair-share
            # between tenants inside a tier, FIFO within a tenant
            tasks = list(self._ready)
            order = plane.order([(t.spec.priority, t.spec.tenant)
                                 for t in tasks])
            self._ready = collections.deque(tasks[i] for i in order)
        deferred: List[PendingTask] = []
        while self._ready:
            task = self._ready.popleft()
            if task.cancelled:
                continue
            demand = task.spec.resource_vector()
            custom = custom_resources(task.spec.resources)
            # resolve soft affinity ONCE: the fallback placement must be
            # used for the infeasibility check too, or a soft-aff task
            # whose fallback nodes are momentarily full parks forever
            placement = self._effective_placement_locked(
                task.spec.placement(), custom)
            # locality: the node holding the most resident input bytes
            # is preferred when feasible; SPREAD / PG / affinity
            # placements keep their own policies untouched
            prefer = None
            if locality_on and placement[0] == "default" \
                    and getattr(task.spec, "arg_sizes", None):
                prefer = self._preferred_node_locked(task.spec.arg_sizes)
            idx = self._pick_node(demand, threshold, placement, custom,
                                  prefer=prefer, spill_depth=spill_depth)
            if idx is None:
                if not any(self._eligible(i, placement, custom)
                           and n.feasible(demand)
                           for i, n in enumerate(self._nodes)):
                    self._infeasible.append(task)
                else:
                    deferred.append(task)
                continue
            self._nodes[idx].allocate(demand)
            self._nodes[idx].allocate_custom(custom)
            task.node_index = idx
            self._num_dispatched += 1
            self._outstanding[idx] = self._outstanding.get(idx, 0) + 1
            out.append(task)
        self._ready.extend(deferred)
        return out

    def _preferred_node_locked(self, arg_sizes) -> Optional[int]:
        """Node row holding the most resident bytes of this task's args
        (primary or staged secondary copies both count; a copy of
        unknown size weighs 1 byte so it still attracts). Ties break to
        the lowest row for determinism."""
        locs_of = self.locations_of
        bytes_on: Dict[int, int] = {}
        for oid, nbytes in arg_sizes:
            for node in locs_of(oid):
                bytes_on[node] = bytes_on.get(node, 0) + max(int(nbytes), 1)
        if not bytes_on:
            return None
        return max(bytes_on.items(), key=lambda kv: (kv[1], -kv[0]))[0]

    def _effective_placement_locked(self, placement: Tuple,
                                    custom: Dict[str, float]) -> Tuple:
        """Soft node affinity whose target is missing/dead resolves to the
        default placement (mirrors TensorScheduler._mask_row)."""
        if placement[0] == "aff" and len(placement) > 2 and placement[2]:
            target_alive = any(
                self._eligible(i, placement, custom)
                and any(c > 0 for c in n.capacity)
                for i, n in enumerate(self._nodes))
            if not target_alive:
                return ("default",)
        return placement

    def _eligible(self, idx: int, placement: Tuple,
                  custom: Dict[str, float] = {}) -> bool:
        node = self._nodes[idx]
        if custom and not node.has_custom(custom):
            return False
        kind = placement[0]
        if kind == "pg":
            _, pid, bindex = placement
            return (node.pg_id is not None
                    and not node.defunct
                    and node.pg_id.binary() == pid
                    and (bindex < 0 or node.bundle_index == bindex))
        if kind == "aff":
            nid = placement[1]
            node_id = node.node_id
            node_id = node_id.binary() if hasattr(node_id, "binary") \
                else node_id
            return not node.is_bundle and node_id == nid
        return not node.is_bundle   # default / spread

    def _pick_node(self, demand: Tuple[float, ...], threshold: float,
                   placement: Tuple = ("default",),
                   custom: Dict[str, float] = {},
                   prefer: Optional[int] = None,
                   spill_depth: int = 0) -> Optional[int]:
        kind = placement[0]
        if kind == "aff":
            best, best_load = None, float("inf")
            target_alive = False
            for i, n in enumerate(self._nodes):
                if self._eligible(i, placement, custom):
                    if any(c > 0 for c in n.capacity):
                        target_alive = True
                    if n.fits(demand) and n.fits_custom(custom):
                        ld = n.load()
                        if ld < best_load:
                            best, best_load = i, ld
            if best is not None:
                return best
            if target_alive:
                return None  # node exists but is busy: wait for it
            # soft affinity falls back to the default policy only when the
            # target node is missing or dead (documented semantics)
            if len(placement) > 2 and placement[2]:
                placement = ("default",)
            else:
                return None
            kind = "default"
        # locality preference outranks the hybrid local bias: the node
        # holding the task's input bytes takes it when it fits; when it is
        # momentarily full the task WAITS for it, but only while its
        # outstanding-lease depth stays under the spillback bound —
        # beyond that the task falls through to the normal policy
        if kind == "default" and prefer is not None \
                and 0 <= prefer < len(self._nodes):
            n = self._nodes[prefer]
            if self._eligible(prefer, placement, custom) \
                    and n.feasible(demand) and n.has_custom(custom):
                if n.fits(demand) and n.fits_custom(custom):
                    return prefer
                if self._outstanding.get(prefer, 0) < spill_depth:
                    return None  # bounded wait for the data-resident node
        # hybrid: local (node 0) until its load crosses threshold, then the
        # least-loaded eligible node that fits. SPREAD and PG classes skip
        # the local bias (PG rows exclude node 0 anyway).
        if kind == "default" and self._nodes \
                and self._eligible(0, placement, custom) \
                and self._nodes[0].fits(demand) \
                and self._nodes[0].fits_custom(custom) \
                and self._nodes[0].load() < threshold:
            return 0
        best, best_load = None, float("inf")
        for i, n in enumerate(self._nodes):
            if self._eligible(i, placement, custom) and n.fits(demand) \
                    and n.fits_custom(custom):
                ld = n.load()
                if ld < best_load:
                    best, best_load = i, ld
        return best

    def _run_dispatch(self, tasks: List[PendingTask]) -> None:
        for task in tasks:
            self._dispatch(task)
