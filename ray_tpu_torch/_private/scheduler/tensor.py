"""TensorScheduler — batched array-resident scheduler (the north star).

Replaces the per-event O(1) decisions of EventScheduler (and of the
reference's ClusterTaskManager / ILocalTaskManager,
ray: src/ray/raylet/scheduling/cluster_task_manager.cc,
local_task_manager.cc) with per-tick batched decisions over the whole
pending set, held as arrays (see kernels.py for the decision kernels).

Architecture:
  - submit()/notify_*() only enqueue events (O(1), lock-held briefly)
    and wake the tick thread.
  - The tick thread drains all queued events, updates the task arena
    arrays in bulk, computes the ready set + assignments with one
    batched kernel call, and dispatches outside the lock.
  - Dependencies are tracked as an ``indegree`` vector plus a host-side
    ``object -> waiting slots`` index; object-ready events decrement
    indegrees with one scatter per tick.

Backends: numpy ticks by default (lowest latency at interactive sizes);
the device path (``kernels.assign``: the hand-written CUDA kernels of
``ops/csrc/scheduler_tick.cu`` on the card, their plain PyTorch version
with ``sched_device="cpu"``) takes over for large ready batches (config
sched_device_min_batch), or for every batch with sched_backend="cuda".
The device path runs on the scheduler's own CUDA stream, so it neither
waits on nor blocks the work tasks and actors queue on the default
stream. A device assignment that raises fails its batch's tasks with
``SchedulingError`` (through the ``fail_tasks`` hook the worker
attaches); it is never retried on numpy.

The EventScheduler is kept as the semantics oracle: property tests run
identical task graphs through both and assert the same completion
semantics and capacity invariants.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.scheduler import kernels
from ray_tpu_torch._private.scheduler.base import PendingTask, SchedulerBase
from ray_tpu_torch._private.scheduler.kernels import DONE, FREE, RUNNING, WAITING
from ray_tpu_torch._private.scheduler.local import NodeState
from ray_tpu_torch._private.task_spec import custom_resources, resources_to_vector

_BACKENDS = ("auto", "cuda", "numpy")


def check_device() -> None:
    """Raise unless the configured backend can run: ``auto`` and ``cuda``
    launch on ``sched_device``, so a CUDA device must exist unless that is
    ``"cpu"`` (the tests). Called by ``init`` before any thread starts;
    never creates a CUDA context."""
    backend = GLOBAL_CONFIG.sched_backend
    device = GLOBAL_CONFIG.sched_device
    if backend not in _BACKENDS:
        raise ValueError(f"sched_backend {backend!r}: one of {_BACKENDS}")
    if torch.device(device).type not in ("cuda", "cpu"):
        raise ValueError(f"sched_device {device!r}: cuda or cpu")
    if (backend != "numpy" and torch.device(device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(
            f"scheduler='tensor' with sched_backend={backend!r} assigns on "
            f"{device!r}, and this host has no CUDA device. Pass "
            "_system_config={'sched_device': 'cpu'} to run the device "
            "path's plain version on the host, or sched_backend='numpy'.")


class TensorScheduler(SchedulerBase):
    def __init__(self, nodes: List[NodeState],
                 dispatcher: Callable[[PendingTask], None],
                 store_contains: Optional[Callable[[ObjectID], bool]] = None,
                 initial_capacity: Optional[int] = None):
        self._dispatch = dispatcher
        # batch lease-grant path: a dispatcher OBJECT may expose
        # dispatch_many(list) so one tick's grants ship per-worker in
        # single pipe messages (plain callables dispatch one at a time)
        self._dispatch_many = getattr(dispatcher, "dispatch_many", None)
        self._store_contains = store_contains or (lambda oid: False)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # True only while the tick thread is parked in wait(): producers
        # skip the notify syscall when the loop is already awake (under
        # load it almost always is, and notify-per-event was measurable)
        self._sleeping = False

        n_res = GLOBAL_CONFIG.sched_num_resources
        self._cap = np.zeros((0, n_res), dtype=np.float32)
        self._avail = np.zeros((0, n_res), dtype=np.float32)
        self._node_states: List[NodeState] = []
        # dispatch-window bookkeeping (reference: raylet dispatch queue):
        # outstanding = dispatched-not-finished per node; win_cap > 0
        # lets simple CPU tasks lease beyond avail up to that many
        # outstanding, queueing at the node's pool
        self._outstanding = np.zeros(0, dtype=np.int64)
        self._win_cap = np.zeros(0, dtype=np.int64)
        for n in nodes:
            self._append_node_locked(n)

        # arena slots grow by doubling; the knob sets the starting size
        # (bigger = fewer regrow copies on sustained load, more resident
        # memory up front)
        c = (initial_capacity if initial_capacity is not None
             else GLOBAL_CONFIG.sched_arena_capacity)
        self._state = np.zeros(c, dtype=np.int8)
        self._indeg = np.zeros(c, dtype=np.int32)
        self._cls = np.zeros(c, dtype=np.int32)
        self._node_of = np.full(c, -1, dtype=np.int32)
        # True for slots leased through the dispatch window: they hold a
        # pool-queue position, not node resources, so completion must
        # not release what was never charged
        self._windowed = np.zeros(c, dtype=bool)
        self._free: collections.deque = collections.deque(range(c))

        self._tasks: Dict[int, PendingTask] = {}       # slot -> task
        self._slot_of: Dict[TaskID, int] = {}
        # id the slot was admitted under: spec.task_id mutates on retry, so
        # release must use the admission-time id, not spec.task_id
        self._tid_of: Dict[int, TaskID] = {}
        self._waiters: Dict[ObjectID, List[int]] = {}  # oid -> slots
        self._deps_of: Dict[int, List[ObjectID]] = {}  # slot -> pending oids
        # slot -> ((ObjectID, nbytes), ...) stamped at submit: drives the
        # locality column. A dict (not an array) because only tasks with
        # ObjectRef args under remote clusters carry it — usually sparse.
        self._argsz: Dict[int, Tuple] = {}

        self._class_index: Dict[Tuple, int] = {}
        self._demands = np.zeros((0, n_res), dtype=np.float32)
        # node-eligibility masks per scheduling class (placement groups,
        # SPREAD, node affinity). Rebuilt lazily when classes or the node
        # set change; the kernels consume them as [K,N] / [K] arrays.
        self._class_place: List[Tuple] = []
        # named custom demands per class (per-name feasibility lives in
        # the eligibility masks; the demand MATRIX keeps a fixed width)
        self._class_custom: List[Dict[str, float]] = []
        # dispatch-window eligibility per class: plain CPU<=1 demand,
        # default/spread placement, no named resources — the shape whose
        # real concurrency bound is "one worker pipe each"
        self._class_window_ok: List[bool] = []
        self._class_mask = np.zeros((0, 0), dtype=bool)
        self._class_spread = np.zeros(0, dtype=bool)
        self._mask_dirty = False

        self._submit_q: collections.deque = collections.deque()
        self._ready_obj_q: collections.deque = collections.deque()
        self._finish_q: collections.deque = collections.deque()

        self._num_submitted = 0
        self._num_dispatched = 0
        self._num_finished = 0
        self._num_ticks = 0
        self._last_tick = 0.0  # monotonic stamp of the last coalesced tick
        # auto-backend calibration: the device path only wins when the
        # round trip (uploads, launch, the fetch of node_of) is cheap
        # against numpy at this batch. "cold" -> background warmup on the
        # first large batch -> timed head-to-head -> "device" | "numpy";
        # "failed" keeps the device's error, which every later large
        # batch under auto raises again (no silent numpy fallback).
        self._calib_state = "cold"   # cold | warming | device | numpy | failed
        self._calib_error: Optional[BaseException] = None
        self._np_cost = 0.0          # EWMA of assign_np wall time (s)
        self._device_cost = float("inf")
        # the device path's own CUDA stream (made on first use)
        self._stream: Optional[torch.cuda.Stream] = None
        self._num_device_assigns = 0
        self._num_device_assign_errors = 0
        # ticks whose batch carried a locality matrix: kernels.assign has
        # no locality column, so these run assign_np on the host by the
        # reference's rule (decided before the tick, never after an error)
        self._num_locality_host_assigns = 0
        self._dirty = False  # schedulability changed without a queued event
        self._shutdown = False
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True, name="ray_tpu_sched_tick")
        self._tick_thread.start()

    # -- SchedulerBase -----------------------------------------------------
    def submit(self, task: PendingTask) -> None:
        with self._wake:
            self._submit_q.append(task)
            self._num_submitted += 1
            if self._sleeping:
                self._wake.notify()

    def submit_many(self, tasks: List[PendingTask]) -> None:
        """One lock acquire + one wakeup for the whole batch (the
        per-submit lock/notify pair is most of submit()'s cost once
        callers batch)."""
        with self._wake:
            self._submit_q.extend(tasks)
            self._num_submitted += len(tasks)
            if self._sleeping:
                self._wake.notify()

    def notify_object_ready(self, object_id: ObjectID) -> None:
        with self._wake:
            self._ready_obj_q.append(object_id)
            if self._sleeping:
                self._wake.notify()

    def notify_task_finished(self, task_id: TaskID, node_index: int,
                             resources: Dict[str, float]) -> None:
        with self._wake:
            self._finish_q.append((task_id, node_index, resources))
            self._num_finished += 1
            if self._sleeping:
                self._wake.notify()

    def notify_batch(self, ready_objects, finished) -> None:
        with self._wake:
            self._ready_obj_q.extend(ready_objects)
            self._finish_q.extend(finished)
            self._num_finished += len(finished)
            if self._sleeping:
                self._wake.notify()

    def cancel(self, task_id: TaskID) -> bool:
        with self._wake:
            # not yet admitted: remove straight from the submission queue
            for task in self._submit_q:
                if task.spec.task_id == task_id:
                    task.cancelled = True
                    self._submit_q.remove(task)
                    return True
            slot = self._slot_of.get(task_id)
            if slot is None or self._state[slot] not in (WAITING,):
                return False
            task = self._tasks.get(slot)
            if task is not None:
                task.cancelled = True
            self._release_slot_locked(slot)
            return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            waiting_mask = self._state == WAITING
            dep_blocked = waiting_mask & (self._indeg > 0)
            ready_mask = waiting_mask & (self._indeg <= 0)
            # infeasible = ready but no node's *capacity* can ever hold it;
            # feasibility depends only on the class, so compute per class
            # (K x N) and count ready slots per class — O(K*N + C)
            if self._demands.shape[0] and ready_mask.any():
                class_feasible = (self._cap[None, :, :]
                                  >= self._demands[:, None, :]).all(
                                      axis=2).any(axis=1)  # [K]
                ready_cls_counts = np.bincount(
                    self._cls[ready_mask],
                    minlength=self._demands.shape[0])
                infeasible = int(ready_cls_counts[~class_feasible].sum())
            else:
                infeasible = 0
            return {
                "submitted": self._num_submitted,
                "dispatched": self._num_dispatched,
                "finished": self._num_finished,
                "local_dispatch": self._num_local_dispatch,
                "spillback": self._num_spillback,
                "ticks": self._num_ticks,
                "waiting_deps": int(dep_blocked.sum()),
                "ready_queue": int(ready_mask.sum()) - infeasible,
                "running": int((self._state == RUNNING).sum()),
                "infeasible": infeasible,
                "device_assigns": self._num_device_assigns,
                "device_assign_errors": self._num_device_assign_errors,
                "locality_host_assigns": self._num_locality_host_assigns,
                "calibration": {
                    "state": self._calib_state,
                    "numpy_s": self._np_cost,
                    "device_s": self._device_cost,
                    "error": (repr(self._calib_error)
                              if self._calib_error is not None else None),
                },
                "nodes": [
                    {"available": self._avail[i].tolist(),
                     "capacity": self._cap[i].tolist(),
                     "is_bundle": self._node_states[i].is_bundle,
                     "custom": dict(self._node_states[i].custom),
                     "custom_avail":
                         dict(self._node_states[i].custom_avail)}
                    for i in range(len(self._node_states))
                ],
            }

    def shutdown(self) -> None:
        with self._wake:
            self._shutdown = True
            if self._sleeping:
                self._wake.notify()
        self._tick_thread.join(timeout=2.0)

    def pending_entries(self, started=None) -> List[Tuple[Any, List[ObjectID]]]:
        """(spec, unresolved deps) for every not-yet-dispatched task —
        the resubmittable half of a control-plane snapshot. ``started``
        (task_id -> bool) lets the caller also reclaim window-leased
        slots that are still queued behind a worker (leased != running
        for a dispatch-window grant)."""
        with self._lock:
            out = []
            for slot, task in self._tasks.items():
                if self._state[slot] == WAITING:
                    out.append((task.spec, list(task.deps)))
                elif (self._windowed[slot] and started is not None
                      and self._state[slot] == RUNNING
                      and not started(task.spec.task_id)):
                    out.append((task.spec, list(task.deps)))
            out.extend((t.spec, list(t.deps)) for t in self._submit_q)
            return out

    def device_state_snapshot(self) -> Dict[str, Any]:
        """Copies of the scheduler's resident arrays, trimmed to the
        occupied slot prefix (SURVEY §5: the checkpoint includes the
        device tensors, not just host tables). FORENSIC data: restore
        resubmits from the task SPECS and re-admission rebuilds these
        arrays — raw slots are meaningless in a new session without the
        old slot maps, so they are recorded for inspection/debugging of
        the snapshot moment, not replayed."""
        with self._lock:
            hi = int(np.flatnonzero(self._state != FREE).max(initial=-1)
                     ) + 1
            return {
                "state": self._state[:hi].copy(),
                "indeg": self._indeg[:hi].copy(),
                "cls": self._cls[:hi].copy(),
                "node_of": self._node_of[:hi].copy(),
                "demands": self._demands.copy(),
                "avail": self._avail.copy(),
                "cap": self._cap.copy(),
            }

    def task_table(self) -> List[Dict[str, Any]]:
        """Live tasks straight off the scheduler arrays (the survey's
        'list tasks that reads back the scheduler tensors'): one row per
        occupied arena slot, state decoded from the state vector."""
        with self._lock:
            rows = []
            for slot, task in self._tasks.items():
                st = int(self._state[slot])
                state = {WAITING: ("PENDING_ARGS" if self._indeg[slot] > 0
                                   else "PENDING_NODE"),
                         RUNNING: "RUNNING",
                         DONE: "FINISHED",
                         FREE: "FREE"}.get(st, str(st))
                spec = task.spec
                rows.append({
                    "task_id": self._tid_of.get(slot, spec.task_id).hex(),
                    "name": spec.name,
                    "state": state,
                    "node_index": int(self._node_of[slot]),
                    "attempt": spec.attempt_number,
                    "scheduling_class": int(self._cls[slot]),
                })
            # queued-but-unadmitted submissions
            for task in self._submit_q:
                rows.append({
                    "task_id": task.spec.task_id.hex(),
                    "name": task.spec.name,
                    "state": "QUEUED",
                    "node_index": -1,
                    "attempt": task.spec.attempt_number,
                    "scheduling_class": -1,
                })
            return rows

    def node_state(self, index: int) -> Optional[NodeState]:
        with self._lock:
            return self._node_states[index] \
                if 0 <= index < len(self._node_states) else None

    def try_allocate(self, index: int, resources: Dict[str, float]) -> bool:
        """Directly charge a row if it fits (actor restart-elsewhere:
        the replacement node must account for the actor's resources)."""
        with self._wake:
            if not (0 <= index < len(self._node_states)):
                return False
            vec = np.asarray(resources_to_vector(resources),
                             dtype=np.float32)[:self._cap.shape[1]]
            custom = custom_resources(resources)
            ns = self._node_states[index]
            if self._cap[index].any() \
                    and (self._avail[index] >= vec - 1e-6).all() \
                    and ns.has_custom(custom) and ns.fits_custom(custom):
                self._avail[index] -= vec
                ns.allocate(tuple(vec.tolist()))
                ns.allocate_custom(custom)
                return True
            return False

    def node_count(self) -> int:
        with self._lock:
            return len(self._node_states)

    # -- node management ---------------------------------------------------
    def add_node(self, node: NodeState, wake: bool = True) -> int:
        """wake=False appends the row WITHOUT waking the tick thread:
        callers that must finish wiring (e.g. registering the node's
        worker pool) before any task can dispatch to the row call
        poke() afterwards — dispatching into a half-registered node
        races pool_for_node() to None."""
        with self._wake:
            idx = self._append_node_locked(node)
            if wake:
                self._dirty = True
                if self._sleeping:
                    self._wake.notify()
            return idx

    def poke(self) -> None:
        """Wake the tick thread (schedulability may have changed)."""
        with self._wake:
            self._dirty = True
            if self._sleeping:
                self._wake.notify()

    def remove_node(self, node_index: int) -> None:
        with self._wake:
            self._cap[node_index] = 0.0
            self._avail[node_index] = 0.0
            self._node_states[node_index].capacity = [0.0] * self._cap.shape[1]
            self._node_states[node_index].available = [0.0] * self._cap.shape[1]
            # a dead node's named resources leave the cluster with it
            self._node_states[node_index].custom = {}
            self._node_states[node_index].custom_avail = {}
            # soft-affinity classes pinned to this node must re-resolve
            # (dead target -> fall back to the default node set)
            self._mask_dirty = True
            self._dirty = True
            if self._sleeping:
                self._wake.notify()

    def _append_node_locked(self, node: NodeState) -> int:
        vec = np.zeros((1, self._cap.shape[1] if self._cap.size else
                        GLOBAL_CONFIG.sched_num_resources), dtype=np.float32)
        for i, v in enumerate(node.capacity[:vec.shape[1]]):
            vec[0, i] = v
        self._cap = np.concatenate([self._cap, vec], axis=0)
        av = vec.copy()
        for i, v in enumerate(node.available[:vec.shape[1]]):
            av[0, i] = v
        self._avail = np.concatenate([self._avail, av], axis=0)
        self._node_states.append(node)
        self._outstanding = np.concatenate(
            [self._outstanding, np.zeros(1, dtype=np.int64)])
        win = 0
        if node.window_factor > 1 and not node.is_bundle:
            win = int(node.window_factor * max(vec[0, 0], 1.0))
        self._win_cap = np.concatenate(
            [self._win_cap, np.asarray([win], dtype=np.int64)])
        self._mask_dirty = True
        return len(self._node_states) - 1

    # -- placement groups ---------------------------------------------------
    def pack_snapshot(self):
        """(avail [N,R], cap [N,R], row indices) over PHYSICAL nodes only —
        the input to the placement-group bin-pack solve."""
        with self._wake:
            rows = [i for i, n in enumerate(self._node_states)
                    if not n.is_bundle]
            return (self._avail[rows].copy(), self._cap[rows].copy(), rows)

    def add_bundle_nodes(self, pg_id, placements) -> Optional[List[int]]:
        """Atomically reserve bundles: placements = [(parent_row,
        demand_vec, custom_dict), ...] in bundle order; all-or-nothing
        (the 2-phase prepare/commit of the reference's
        GcsPlacementGroupScheduler,
        ray: src/ray/raylet/placement_group_resource_manager.cc). Returns
        new bundle rows or None if availability moved since the pack."""
        with self._wake:
            n_res = self._cap.shape[1]
            need: Dict[int, np.ndarray] = {}
            for parent, vec, _custom in placements:
                acc = need.setdefault(parent, np.zeros(n_res, np.float32))
                acc[:len(vec)] += np.asarray(vec, dtype=np.float32)[:n_res]
            for parent, total in need.items():
                if not (self._avail[parent] >= total - 1e-6).all():
                    return None
            rows = []
            for bindex, (parent, vec, custom) in enumerate(placements):
                v = np.zeros(n_res, np.float32)
                v[:len(vec)] = np.asarray(vec, dtype=np.float32)[:n_res]
                self._avail[parent] -= v
                self._node_states[parent].allocate(tuple(v.tolist()))
                self._node_states[parent].allocate_custom(custom)
                row = self._append_node_locked(NodeState(
                    tuple(v.tolist()),
                    node_id=self._node_states[parent].node_id,
                    pg_id=pg_id, bundle_index=bindex, parent=parent,
                    custom_resources=custom))
                rows.append(row)
            self._dirty = True
            if self._sleeping:
                self._wake.notify()
            return rows

    def drain_pg_tasks(self, pg_id) -> List[PendingTask]:
        """Remove and return every not-yet-dispatched task targeting the
        group (its rows are gone; leaving them queued would hang their
        callers forever)."""
        pid = pg_id.binary()

        def match(task) -> bool:
            p = task.spec.placement_group_id
            return p is not None and p.binary() == pid

        out: List[PendingTask] = []
        with self._wake:
            kept = collections.deque()
            while self._submit_q:
                t = self._submit_q.popleft()
                (out if match(t) else kept).append(t)
            self._submit_q.extend(kept)
            for slot, task in list(self._tasks.items()):
                if self._state[slot] == WAITING and match(task):
                    out.append(task)
                    self._release_slot_locked(slot)
        return out

    def remove_pg(self, pg_id) -> None:
        """Release a group's bundle rows back to their parents.

        Only the FREE part of each bundle returns immediately; capacity
        held by still-running tasks stays charged to the (now defunct)
        row and flows back to the parent task-by-task as completions
        drain — releasing it all at once would overcommit the parent.
        Row indices stay valid."""
        with self._wake:
            for i, ns in enumerate(self._node_states):
                if ns.pg_id == pg_id and not ns.defunct \
                        and self._cap[i].any():
                    parent = ns.parent
                    free = self._avail[i].copy()
                    self._avail[parent] = np.minimum(
                        self._avail[parent] + free, self._cap[parent])
                    self._node_states[parent].release(tuple(free.tolist()))
                    # the UNUSED part of the bundle's named resources
                    # returns now; the in-use part follows task-by-task
                    # through the defunct completion path
                    self._node_states[parent].release_custom(ns.custom_avail)
                    in_use = self._cap[i] - free
                    self._cap[i] = in_use
                    self._avail[i] = 0.0
                    ns.capacity = in_use.tolist()
                    ns.available = [0.0] * self._cap.shape[1]
                    ns.defunct = True
            self._mask_dirty = True
            self._dirty = True
            if self._sleeping:
                self._wake.notify()

    # -- tick loop ---------------------------------------------------------
    def _tick_loop(self) -> None:
        # Every WAITING->schedulable transition arrives as a queued event
        # (object ready, task finished, node added), so the thread sleeps
        # until events exist — no polling of dep-blocked or saturated tasks.
        while True:
            with self._wake:
                while (not self._shutdown and not self._submit_q
                       and not self._ready_obj_q and not self._finish_q
                       and not self._dirty):
                    self._sleeping = True
                    self._wake.wait(timeout=0.5)
                    self._sleeping = False
                if self._shutdown:
                    return
                # tick coalescing floor: with sched_tick_interval_s > 0,
                # an event burst arriving right after a tick waits out
                # the remainder of the interval so the whole burst lands
                # in ONE drain/assign cycle (0 = tick immediately)
                interval = GLOBAL_CONFIG.sched_tick_interval_s
                if interval > 0.0:
                    remaining = self._last_tick + interval - time.monotonic()
                    if remaining > 0:
                        self._wake.wait(timeout=remaining)
                    if self._shutdown:
                        return
                    self._last_tick = time.monotonic()
                self._dirty = False
                try:
                    snapshot = self._drain_events_locked()
                except Exception:
                    logger.exception(
                        "scheduler tick failed; state may be inconsistent")
                    snapshot = None
            to_dispatch: List[PendingTask] = []
            if snapshot is not None:
                try:
                    # assignment (and any kernel build it triggers) runs
                    # OUTSIDE the lock: the tick thread is the only mutator
                    # of the scheduling arrays, so the snapshot stays
                    # coherent; cancel()/remove_node() races are validated
                    # at apply time
                    ready_idx, decisions, new_avail = self._assign(snapshot)
                except Exception as e:
                    # no retry on another backend: the batch fails with
                    # the cause, so get() raises instead of hanging
                    self._fail_batch(snapshot[0], e)
                    ready_idx = None
                try:
                    if ready_idx is not None:
                        with self._wake:
                            to_dispatch = self._apply_locked(
                                ready_idx, decisions)
                except Exception:
                    logger.exception("scheduler assignment failed")
            if to_dispatch and self._dispatch_many is not None:
                try:
                    self._dispatch_many(to_dispatch)
                except Exception:
                    logger.exception("batch dispatch failed")
            else:
                for task in to_dispatch:
                    try:
                        self._dispatch(task)
                    except Exception:
                        logger.exception("dispatch failed for %s",
                                         task.spec.task_id)

    def _drain_events_locked(self):
        self._num_ticks += 1

        # 1) admissions
        while self._submit_q:
            task = self._submit_q.popleft()
            slot = self._alloc_slot_locked()
            spec = task.spec
            self._tasks[slot] = task
            self._slot_of[spec.task_id] = slot
            self._tid_of[slot] = spec.task_id
            key = spec.scheduling_class()
            cidx = self._class_index.get(key)
            if cidx is None:
                cidx = len(self._class_index)
                self._class_index[key] = cidx
                vec = np.asarray(spec.resource_vector(), dtype=np.float32)
                d = np.zeros((1, self._cap.shape[1]), dtype=np.float32)
                w = min(len(vec), d.shape[1])
                d[0, :w] = vec[:w]
                self._demands = np.concatenate([self._demands, d], axis=0)
                place = spec.placement()
                custom = custom_resources(spec.resources)
                self._class_place.append(place)
                self._class_custom.append(custom)
                self._class_window_ok.append(
                    not custom
                    and place in (("default",), ("spread",))
                    and d[0, 0] <= 1.0
                    and not d[0, 1:].any())
                self._append_class_mask_locked(place, custom)
            self._cls[slot] = cidx
            pending_deps = []
            for dep in task.deps:
                if self._store_contains(dep):
                    continue
                self._waiters.setdefault(dep, []).append(slot)
                pending_deps.append(dep)
            self._indeg[slot] = len(pending_deps)
            if pending_deps:
                self._deps_of[slot] = pending_deps
            sizes = getattr(spec, "arg_sizes", None)
            if sizes:
                self._argsz[slot] = sizes
            self._state[slot] = WAITING

        # 2) object-ready wave (batched indegree scatter)
        dec_slots: List[int] = []
        waiters = self._waiters
        while self._ready_obj_q:
            oid = self._ready_obj_q.popleft()
            if waiters:
                w = waiters.pop(oid, None)
                if w:
                    dec_slots.extend(w)
        if dec_slots:
            np.subtract.at(self._indeg, np.asarray(dec_slots, dtype=np.int64), 1)
            te = self.task_events
            if te is not None:
                # slots whose last dependency just landed (dep-blocked
                # tasks only: no-dep admissions never enter dec_slots)
                tid_of = self._tid_of
                newly_ready = [tid_of[s] for s in set(dec_slots)
                               if self._state[s] == WAITING
                               and self._indeg[s] <= 0
                               and s in tid_of]
                if newly_ready:
                    te.record_ready_batch(newly_ready)

        # 3) completions: release resources, free slots
        while self._finish_q:
            task_id, node_index, resources = self._finish_q.popleft()
            slot = self._slot_of.get(task_id)
            was_windowed = False
            cidx = -1
            if slot is not None and self._state[slot] == RUNNING:
                was_windowed = bool(self._windowed[slot])
                cidx = int(self._cls[slot])
                if 0 <= node_index < len(self._node_states):
                    self._outstanding[node_index] = max(
                        self._outstanding[node_index] - 1, 0)
                self._release_slot_locked(slot)
            if was_windowed:
                continue  # a window lease held no node resources
            if 0 <= node_index < len(self._node_states):
                if 0 <= cidx < len(self._class_custom):
                    # the class row IS the demand vector — skip the
                    # per-completion dict -> vector conversion
                    vec = self._demands[cidx]
                    custom = self._class_custom[cidx]
                else:
                    vec = np.asarray(resources_to_vector(resources),
                                     dtype=np.float32)[:self._cap.shape[1]]
                    custom = custom_resources(resources)
                ns = self._node_states[node_index]
                if ns.defunct:
                    # removed bundle: this task's share of the carved-out
                    # capacity returns to the parent now that it is free
                    parent = ns.parent
                    self._avail[parent] = np.minimum(
                        self._avail[parent] + vec, self._cap[parent])
                    self._node_states[parent].release(tuple(vec))
                    self._node_states[parent].release_custom(custom)
                    self._cap[node_index] = np.maximum(
                        self._cap[node_index] - vec, 0.0)
                    ns.capacity = self._cap[node_index].tolist()
                else:
                    self._avail[node_index] = np.minimum(
                        self._avail[node_index] + vec, self._cap[node_index])
                    ns.release(tuple(vec))
                    ns.release_custom(custom)

        # snapshot for the out-of-lock assignment pass
        ready_idx = np.flatnonzero((self._state == WAITING) & (self._indeg <= 0))
        if len(ready_idx) == 0:
            return None
        plane = self.qos_plane
        tiers = None
        if plane is not None and len(ready_idx) > 0:
            # QoS assignment order: permuting ready_idx dispatches strict
            # tiers first with weighted fair-share between tenants inside
            # a tier (slot order, i.e. FIFO, within a tenant). The greedy
            # kernel honors array order WITHIN a scheduling class but
            # drains classes as groups, so ``tiers`` (priority per ready
            # position, descending) rides along: _assign chunks the batch
            # into per-tier runs so a lower tier never jumps a higher one
            # just because its class was registered first.
            tasks = self._tasks
            keys = []
            for slot in ready_idx:
                spec = tasks[int(slot)].spec
                keys.append((spec.priority, spec.tenant))
            order = plane.order(keys)
            ready_idx = ready_idx[np.asarray(order, dtype=np.int64)]
            tiers = np.asarray([keys[i][0] for i in order], dtype=np.int64)
        if self._mask_dirty:
            self._rebuild_masks_locked()
        # the locality column: only ticks whose ready tasks carry arg
        # sizes with a known remote location build it (arg_sizes is
        # stamped only once a remote node exists)
        locality = None
        outstanding = None
        if (self._argsz and GLOBAL_CONFIG.scheduler_locality
                and self.locations_of is not None):
            locality = self._locality_matrix_locked(ready_idx)
            if locality is not None:
                outstanding = self._outstanding.copy()
        return (ready_idx, self._cls[ready_idx].copy(), self._demands.copy(),
                self._avail.copy(), self._cap.copy(),
                self._class_mask.copy(), self._class_spread.copy(),
                locality, outstanding, tiers)

    def _locality_matrix_locked(self, ready_idx) -> Optional[np.ndarray]:
        """[len(ready_idx), N] resident-arg-bytes per candidate node,
        aligned to ready positions. A copy of unknown size weighs one
        byte so it still attracts. None when no ready task has any arg
        with a known remote location (the kernel's fast path)."""
        argsz = self._argsz
        locs_of = self.locations_of
        N = len(self._node_states)
        m = None
        for pos, slot in enumerate(ready_idx):
            sizes = argsz.get(int(slot))
            if not sizes:
                continue
            for oid, nbytes in sizes:
                for node in locs_of(oid):
                    if 0 <= node < N:
                        if m is None:
                            m = np.zeros((len(ready_idx), N),
                                         dtype=np.float64)
                        m[pos, node] += max(int(nbytes), 1)
        return m

    def _mask_row(self, place: Tuple,
                  custom: Dict[str, float] = {}) -> Tuple[np.ndarray, bool]:
        """(eligibility row [N], spread flag) for one placement descriptor
        (see TaskSpec.placement) + named custom demands against the
        current node set."""
        nodes = self._node_states
        N = len(nodes)
        non_bundle = np.asarray([not ns.is_bundle for ns in nodes],
                                dtype=bool) if N else np.zeros(0, bool)
        if custom:
            # per-NAME feasibility (quantity accounting rides the shared
            # CUSTOM capacity dimension)
            custom_ok = np.asarray([ns.has_custom(custom) for ns in nodes],
                                   dtype=bool) if N else np.zeros(0, bool)
        else:
            custom_ok = None

        def finish(row: np.ndarray, spread: bool):
            if custom_ok is not None:
                row = row & custom_ok
            return row, spread

        row = np.zeros(N, dtype=bool)
        kind = place[0]
        if kind == "pg":
            _, pid, bindex = place
            for i, ns in enumerate(nodes):
                if ns.pg_id is not None and not ns.defunct \
                        and ns.pg_id.binary() == pid \
                        and (bindex < 0 or ns.bundle_index == bindex):
                    row[i] = True
            return finish(row, False)
        if kind == "aff":
            nid, soft = place[1], place[2]
            found_alive = False
            for i, ns in enumerate(nodes):
                node_id = ns.node_id
                node_id = node_id.binary() \
                    if hasattr(node_id, "binary") else node_id
                if not ns.is_bundle and node_id == nid:
                    row[i] = True
                    if any(c > 0 for c in ns.capacity):
                        found_alive = True
            # soft affinity falls back only when the node is missing or
            # DEAD (a live-but-busy node means: wait for it)
            if soft and not found_alive:
                row = non_bundle.copy()
            return finish(row, False)
        return finish(non_bundle.copy(), kind == "spread")

    def _append_class_mask_locked(self, place: Tuple,
                                  custom: Dict[str, float] = {}) -> None:
        """Append one class row without a full K*N rebuild (classes are
        minted far more often than the node set changes)."""
        if self._mask_dirty:
            return  # a full rebuild is due anyway
        row, spread = self._mask_row(place, custom)
        if self._class_mask.shape[0] == 0:
            self._class_mask = row[None, :]
        else:
            self._class_mask = np.vstack([self._class_mask, row[None, :]])
        self._class_spread = np.append(self._class_spread, spread)

    def _rebuild_masks_locked(self) -> None:
        """Recompute [K,N] class->node eligibility + [K] spread flags
        (node set or PG membership changed)."""
        K = len(self._class_place)
        N = len(self._node_states)
        mask = np.zeros((K, N), dtype=bool)
        spread = np.zeros(K, dtype=bool)
        for k, place in enumerate(self._class_place):
            mask[k], spread[k] = self._mask_row(place,
                                                self._class_custom[k])
        self._class_mask = mask
        self._class_spread = spread
        self._mask_dirty = False

    def _assign(self, snapshot):
        """Batched assignment OUTSIDE the lock (the device path's first
        call builds its kernels, seconds, and must not block
        submit()/notify_*)."""
        (ready_idx, ready_cls, demands, avail, cap, class_mask,
         class_spread, locality, outstanding, tiers) = snapshot
        if tiers is not None and len(ready_idx) > 1 and tiers[0] != tiers[-1]:
            # QoS tier barrier: the kernels drain each scheduling class as
            # a group, which would let a lower-tier class registered first
            # absorb capacity ahead of a higher tier. Split the (already
            # tier-descending) batch into contiguous per-tier runs and
            # assign them in order, threading avail, so strict-tier order
            # holds ACROSS classes too. A handful of tiers per tick keeps
            # this cheap; qos=False never reaches here (tiers is None).
            bounds = np.flatnonzero(np.diff(tiers)) + 1
            node_parts = []
            cur_avail = avail
            for s, e in zip(np.r_[0, bounds], np.r_[bounds, len(ready_idx)]):
                sub = (ready_idx[int(s):int(e)], ready_cls[int(s):int(e)],
                       demands, cur_avail, cap, class_mask, class_spread,
                       locality[int(s):int(e)] if locality is not None
                       else None, outstanding, None)
                _, sub_nodes, cur_avail = self._assign(sub)
                node_parts.append(sub_nodes)
            return ready_idx, np.concatenate(node_parts), cur_avail
        backend = GLOBAL_CONFIG.sched_backend
        # class count no longer gates the device path: the kernel scans the
        # class axis (class as data), so many classes don't grow the program
        big = len(ready_idx) >= GLOBAL_CONFIG.sched_device_min_batch
        # calibrate only once numpy ticks are slow enough that a device
        # round trip could plausibly win — otherwise the background
        # calibration steals CPU from the very workload the ticks serve
        state = self._calib_state  # one read: the calibration thread writes it
        if (backend == "auto" and big and state == "cold"
                and self._np_cost > 2e-3):
            self._start_calibration(snapshot)
            state = "warming"
        if backend == "auto" and big and state == "failed":
            raise RuntimeError("the device assignment failed in "
                               "calibration") from self._calib_error
        use_device = (backend == "cuda"
                      or (backend == "auto" and big and state == "device"))
        if locality is not None:
            # kernels.assign has no locality column (nor has the
            # reference's device kernel): a tick with resident-arg scores
            # runs assign_np on the host, whatever the backend. Decided
            # here, before anything runs; a device error never leads here
            use_device = False
            with self._lock:  # stats() reads the counters under it
                self._num_locality_host_assigns += 1
        threshold = GLOBAL_CONFIG.sched_hybrid_threshold
        if use_device:
            node_of_ready, new_avail = self._device_assign(
                ready_cls, demands, avail, cap, threshold, class_mask,
                class_spread)
        else:
            t0 = time.perf_counter()
            cls_full = np.zeros(int(ready_idx.max()) + 1, dtype=np.int32)
            cls_full[ready_idx] = ready_cls
            node_of_ready, new_avail = kernels.assign_np(
                ready_idx, cls_full, demands, avail, cap, threshold,
                class_mask, class_spread,
                locality=locality, outstanding=outstanding,
                spill_depth=GLOBAL_CONFIG.locality_spillback_queue_depth)
            dt = time.perf_counter() - t0
            self._np_cost = 0.8 * self._np_cost + 0.2 * dt if self._np_cost else dt
        return ready_idx, node_of_ready, new_avail

    def _device_assign(self, ready_cls, demands, avail, cap, threshold,
                       class_mask, class_spread):
        """``kernels.assign`` (the reference's ``jax_assign``) on
        sched_device, on the scheduler's own stream. Counts the call, or
        its error, and re-raises the error."""
        # compact the class axis to the classes PRESENT in this batch:
        # self._demands grows for process lifetime (one row per unique
        # scheduling class, never compacted), and the kernel's scan
        # length is its leading dim
        uniq, inv = np.unique(ready_cls, return_inverse=True)
        # and the node axis to the rows that can take a task: a removed
        # node's row (or a drained bundle's) keeps its index with zero
        # capacity, so rows pile up as nodes come and go while the
        # kernel takes at most kernels.MAX_NODES. No implementation ever
        # assigns to an all-zero row, so dropping them changes nothing;
        # row 0 stays, the hybrid policy's local node
        rows = None
        keep = cap.any(axis=1)
        keep[:1] = True
        if not keep.all():
            rows = np.flatnonzero(keep)
            full_avail, avail, cap = avail, avail[rows], cap[rows]
            class_mask = class_mask[:, rows]
        args = (inv.astype(np.int32), demands[uniq], avail, cap, threshold,
                class_mask[uniq], class_spread[uniq])
        device = torch.device(GLOBAL_CONFIG.sched_device)
        try:
            if device.type == "cpu":
                out = kernels.assign(*args, device=device)
            else:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device)
                with torch.cuda.stream(self._stream):
                    out = kernels.assign(*args, device=device)
        except Exception:
            with self._lock:
                self._num_device_assign_errors += 1
            raise
        # the tick thread and the calibration thread both count here
        with self._lock:
            self._num_device_assigns += 1
        if rows is None:
            return out
        node_of, sub_avail = out
        new_avail = full_avail.copy()
        new_avail[rows] = sub_avail
        return (np.where(node_of >= 0, rows[np.maximum(node_of, 0)], -1)
                .astype(node_of.dtype), new_avail)

    def _fail_batch(self, ready_idx, exc: BaseException) -> None:
        """Release the slots of a batch whose assignment raised and hand
        its tasks to the ``fail_tasks`` hook (outside the lock; without
        one, the failure is logged with its traceback)."""
        failed: List[PendingTask] = []
        with self._wake:
            for slot in np.asarray(ready_idx).tolist():
                if self._state[slot] != WAITING:
                    continue  # cancelled (and maybe reused) since snapshot
                task = self._tasks.get(slot)
                self._release_slot_locked(slot)
                if task is not None and not task.cancelled:
                    failed.append(task)
        if self.fail_tasks is None:
            logger.error("device assignment failed for %d tasks",
                         len(failed), exc_info=exc)
            return
        try:
            self.fail_tasks(failed, exc)
        except Exception:
            logger.exception("failing %d unassigned tasks failed",
                             len(failed))

    def _start_calibration(self, snapshot) -> None:
        """Warm + time the device path off-thread; switch ``auto`` to it
        only if a real assignment beats the measured numpy tick by 2x.
        Never stalls the tick loop: numpy serves until the verdict is in.
        A device error is the verdict "failed": it is kept, counted and
        logged with its traceback, and later large batches raise it."""
        self._calib_state = "warming"
        (ready_idx, ready_cls, demands, avail, cap, class_mask,
         class_spread) = snapshot[:7]
        threshold = GLOBAL_CONFIG.sched_hybrid_threshold

        def _calibrate() -> None:
            try:
                args = (ready_cls, demands, avail, cap, threshold,
                        class_mask, class_spread)
                self._device_assign(*args)          # build + warm
                t0 = time.perf_counter()
                self._device_assign(*args)          # steady-state cost
                self._device_cost = time.perf_counter() - t0
            except Exception as e:
                self._calib_error = e
                logger.error("sched auto backend: the device assignment "
                             "failed in calibration", exc_info=e)
                self._calib_state = "failed"
                return
            # require a decisive win: the numpy EWMA is noisy (early
            # ticks include warmup) and the device path's round trip
            # recurs every tick, so a marginal victory in one sample is
            # not worth switching for
            verdict = ("device"
                       if self._device_cost < 0.5 * max(self._np_cost, 1e-6)
                       else "numpy")
            logger.info("sched auto backend: %s (device %.3g s vs numpy "
                        "%.3g s per tick)", verdict, self._device_cost,
                        self._np_cost)
            self._calib_state = verdict

        threading.Thread(target=_calibrate, daemon=True,
                         name="ray_tpu_sched_calib").start()

    def _apply_locked(self, ready_idx, node_of_ready) -> List[PendingTask]:
        """Validate + apply out-of-lock decisions: a slot may have been
        cancelled and a node drained/removed since the snapshot."""
        out: List[PendingTask] = []
        # iterate ASSIGNED positions only: the unassigned tail can be the
        # whole backlog (tens of thousands), and a Python loop over it per
        # tick turns the apply step quadratic in the backlog size
        for pos in np.flatnonzero(np.asarray(node_of_ready) >= 0):
            node = int(node_of_ready[pos])
            slot = int(ready_idx[pos])
            if self._state[slot] != WAITING:
                continue  # cancelled (and maybe reused) since snapshot
            demand = self._demands[self._cls[slot]]
            # liveness first: a removed node zeroes its capacity, and a
            # zero-demand task would otherwise pass the fit check (0 >= 0)
            if not (self._cap[node] > 0).any():
                continue  # node removed since snapshot
            if self._node_states[node].defunct:
                continue  # bundle's group removed since snapshot
            if not (self._cap[node] >= demand).all():
                continue  # node shrunk since snapshot; next tick
            task = self._tasks.get(slot)
            if task is None or task.cancelled:
                self._release_slot_locked(slot)
                continue
            # per-NAME custom quantities are finer than the kernel's
            # aggregate CUSTOM dimension: re-validate + debit here (the
            # task waits a tick if its specific name is exhausted even
            # though the aggregate still fits)
            custom = self._class_custom[self._cls[slot]]
            ns = self._node_states[node]
            if custom and not ns.fits_custom(custom):
                # name exhausted though the aggregate fits: stay WAITING;
                # the completion that frees the name re-ticks the loop
                continue
            self._state[slot] = RUNNING
            self._node_of[slot] = node
            self._avail[node] -= demand
            self._outstanding[node] += 1
            task.node_index = node
            ns.allocate(tuple(demand.tolist()))
            ns.allocate_custom(custom)
            self._num_dispatched += 1
            out.append(task)
        self._window_pass_locked(ready_idx, node_of_ready, out)
        return out

    def _window_pass_locked(self, ready_idx, node_of_ready,
                            out: List[PendingTask]) -> None:
        """Dispatch-window leases (reference: the raylet's dispatch
        queue + worker backlog): ready tasks of simple CPU classes that
        found no free capacity may still lease onto a node whose
        OUTSTANDING count is under its window, queueing at the node's
        pool. No resources are charged (the pool's worker processes
        bound real concurrency); the slot is flagged so completion
        releases nothing."""
        if not self._win_cap.any():
            return
        room = self._win_cap - self._outstanding
        alive = self._cap[:, 0] > 0
        for i, ns in enumerate(self._node_states):
            if ns.defunct or ns.is_bundle:
                alive[i] = False
        room = np.where(alive, room, 0)
        total_room = int(room.sum())
        if total_room <= 0:
            return
        unassigned = np.flatnonzero(np.asarray(node_of_ready) < 0)
        if len(unassigned) == 0:
            return
        # node sequence with one entry per open window position
        nodes_seq = np.repeat(np.arange(len(room)), np.maximum(room, 0))
        taken = 0
        for pos in unassigned:
            if taken >= total_room:
                break
            slot = int(ready_idx[pos])
            if self._state[slot] != WAITING:
                continue
            if not self._class_window_ok[self._cls[slot]]:
                continue
            task = self._tasks.get(slot)
            if task is None or task.cancelled:
                self._release_slot_locked(slot)
                continue
            node = int(nodes_seq[taken])
            taken += 1
            self._state[slot] = RUNNING
            self._node_of[slot] = node
            self._windowed[slot] = True
            self._outstanding[node] += 1
            task.node_index = node
            self._num_dispatched += 1
            out.append(task)

    # -- slot lifecycle ----------------------------------------------------
    def _alloc_slot_locked(self) -> int:
        if not self._free:
            old = len(self._state)
            new = old * 2
            self._state = np.concatenate(
                [self._state, np.zeros(old, dtype=np.int8)])
            self._indeg = np.concatenate(
                [self._indeg, np.zeros(old, dtype=np.int32)])
            self._cls = np.concatenate(
                [self._cls, np.zeros(old, dtype=np.int32)])
            self._node_of = np.concatenate(
                [self._node_of, np.full(old, -1, dtype=np.int32)])
            self._windowed = np.concatenate(
                [self._windowed, np.zeros(old, dtype=bool)])
            self._free.extend(range(old, new))
        return self._free.popleft()

    def _release_slot_locked(self, slot: int) -> None:
        self._windowed[slot] = False
        self._argsz.pop(slot, None)
        self._tasks.pop(slot, None)
        tid = self._tid_of.pop(slot, None)
        if tid is not None and self._slot_of.get(tid) == slot:
            del self._slot_of[tid]
        for dep in self._deps_of.pop(slot, ()):
            lst = self._waiters.get(dep)
            if lst is not None:
                try:
                    lst.remove(slot)
                except ValueError:
                    pass
                if not lst:
                    self._waiters.pop(dep, None)
        self._state[slot] = FREE
        self._indeg[slot] = 0
        self._node_of[slot] = -1
        self._free.append(slot)
