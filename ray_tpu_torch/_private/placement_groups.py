"""Placement-group manager — bundle reservation over the scheduler.

Reference surfaces:
  - GcsPlacementGroupManager / GcsPlacementGroupScheduler
    (ray: src/ray/gcs/gcs_server/gcs_placement_group_manager.cc,
    gcs_placement_group_scheduler.cc): PG lifecycle FSM
    (PENDING -> CREATED -> REMOVED), 2-phase prepare/commit of bundles
    across nodes, retry queue for pending groups.
  - python/ray/util/placement_group.py: the user-facing API shapes.

TPU-native design: the bin-pack solve is the batched kernel
(scheduler/kernels.pack_bundles_np; kernels.pack_many on the card) per the
north star; committed bundles become VIRTUAL NODE ROWS in the same
scheduler arrays, so per-task placement lands in the existing batched
assignment kernel via class->node eligibility masks instead of a separate
bundle-resource accounting path.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.ids import ObjectID, PlacementGroupID
from ray_tpu_torch._private.scheduler import kernels
from ray_tpu_torch._private.task_spec import custom_resources, resources_to_vector
from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError

logger = logging.getLogger(__name__)

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class _Entry:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "state", "rows",
                 "ready_oid", "demands", "customs", "priority")

    def __init__(self, pg_id, bundles, strategy, name, priority=0):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        # QoS tier (config.qos / gang-aware autoscaler): higher-tier
        # pending gangs take freed or newly provisioned capacity first
        self.priority = int(priority)
        self.state = "PENDING"
        self.rows: List[int] = []
        self.ready_oid = ObjectID.from_random()
        self.demands = np.asarray(
            [resources_to_vector(b) for b in bundles], dtype=np.float32)
        # named demands per bundle: per-name node feasibility in the pack
        self.customs = [custom_resources(b) for b in bundles]


class PlacementGroupManager:
    """Owns the PG table; places pending groups against the scheduler."""

    def __init__(self, worker):
        self._worker = worker
        self._lock = threading.Lock()
        self._table: Dict[PlacementGroupID, _Entry] = {}
        self._pending: List[PlacementGroupID] = []
        self._retry_wake = threading.Event()
        self._retry_thread: Optional[threading.Thread] = None
        self._shutdown = False
        # set by the gang-aware autoscaler: groups infeasible under the
        # cluster's FULL current capacity park in the pending queue
        # (scale-up demand) instead of failing permanently
        self.hold_infeasible = False
        # gang scale-ups adding their nodes right now (provisioning())
        self._provisioning = 0

    # -- API ----------------------------------------------------------------
    def create(self, bundles: List[Dict[str, float]], strategy: str,
               name: str, priority: int = 0) -> _Entry:
        if strategy not in VALID_STRATEGIES:
            raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, "
                             f"got {strategy!r}")
        if not bundles:
            raise ValueError("placement group needs at least one bundle")
        for b in bundles:
            if not b or any(v < 0 for v in b.values()):
                raise ValueError(f"invalid bundle {b!r}")
        entry = _Entry(PlacementGroupID.from_random(), [dict(b) for b in
                                                        bundles],
                       strategy, name, priority=priority)
        with self._lock:
            self._table[entry.pg_id] = entry
        if not self._try_place(entry):
            self._on_placement_failure(entry)
        return entry

    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            entry = self._table.get(pg_id)
            if entry is None or entry.state == "REMOVED":
                return
            was = entry.state
            entry.state = "REMOVED"
            if pg_id in self._pending:
                self._pending.remove(pg_id)
        if was == "CREATED":
            self._worker.scheduler.remove_pg(pg_id)
            self._fail_group_tasks(entry)
            # freed capacity can make other pending groups placeable
            self.poke()
        else:
            self._worker.memory_store.put(
                entry.ready_oid,
                PlacementGroupUnschedulableError(
                    f"placement group {pg_id.hex()[:16]} removed before "
                    "it was placed"),
                is_exception=True)

    def _fail_group_tasks(self, entry: _Entry) -> None:
        """Resolve every queued task of a removed group with an error —
        their eligibility set is empty forever and get() would hang."""
        w = self._worker
        exc = PlacementGroupUnschedulableError(
            f"placement group {entry.pg_id.hex()[:16]} was removed")
        for pending in w.scheduler.drain_pg_tasks(entry.pg_id):
            spec = pending.spec
            return_ids = (getattr(spec, "_retry_return_ids", None)
                          or spec.return_ids())
            for oid in return_ids:
                w.memory_store.put(oid, exc, is_exception=True)
                w.scheduler.notify_object_ready(oid)
            w.task_manager.complete(spec.task_id)

    def get(self, pg_id: PlacementGroupID) -> Optional[_Entry]:
        with self._lock:
            return self._table.get(pg_id)

    def table(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                e.pg_id.hex(): {
                    "name": e.name, "strategy": e.strategy,
                    "state": e.state, "bundles": list(e.bundles),
                    "bundle_rows": list(e.rows),
                    "priority": e.priority,
                }
                for e in self._table.values()
            }

    def poke(self) -> None:
        """Resources changed: retry pending placements."""
        with self._lock:
            if not self._pending:
                return
        self._retry_wake.set()

    @contextlib.contextmanager
    def provisioning(self):
        """Hold the retry thread's placements while a gang scale-up adds
        its nodes. A node's capacity reaches the scheduler before the
        provider call that adds it returns, so without the hold a pending
        gang could land on the first nodes of a decision the autoscaler
        has not finished, and not yet counted. Pending groups are retried
        as the hold ends, whether the nodes all came up or not."""
        with self._lock:
            self._provisioning += 1
        try:
            yield
        finally:
            with self._lock:
                self._provisioning -= 1
            self.poke()

    def pending_gangs(self) -> List[Dict[str, Any]]:
        """Snapshot of unplaced groups for the gang-aware autoscaler:
        demand matrices + QoS tier, in submission order (the kernel
        applies the tier permutation itself)."""
        with self._lock:
            entries = [self._table[p] for p in self._pending
                       if self._table[p].state == "PENDING"]
            return [{"pg_id": e.pg_id, "name": e.name,
                     "priority": e.priority, "demands": e.demands,
                     "strategy": e.strategy}
                    for e in entries]

    def shutdown(self) -> None:
        self._shutdown = True
        self._retry_wake.set()

    # -- internals ----------------------------------------------------------
    def _eligibility(self, entry: _Entry, rows: List[int]) -> np.ndarray:
        """[B,N] per-name custom-resource feasibility of each bundle on
        each candidate node."""
        scheduler = self._worker.scheduler
        nodes = [scheduler.node_state(r) for r in rows]
        return np.asarray(
            [[ns is not None and ns.has_custom(c) for ns in nodes]
             for c in entry.customs], dtype=bool)

    def _try_place(self, entry: _Entry) -> bool:
        scheduler = self._worker.scheduler
        avail, cap, rows = scheduler.pack_snapshot()
        if avail.shape[0] == 0:
            return False
        sol = kernels.pack_bundles_np(entry.demands, avail, cap,
                                      entry.strategy,
                                      eligible=self._eligibility(entry, rows))
        if sol is None:
            return False
        placements = [(rows[int(n)], tuple(entry.demands[i].tolist()),
                       entry.customs[i])
                      for i, n in enumerate(sol)]
        got = scheduler.add_bundle_nodes(entry.pg_id, placements)
        if got is None:
            return False  # availability moved under us; retry
        with self._lock:
            if entry.state == "REMOVED":
                # removed while we were placing: roll back
                scheduler.remove_pg(entry.pg_id)
                return True
            entry.rows = got
            entry.state = "CREATED"
        self._worker.memory_store.put(entry.ready_oid, True)
        return True

    def _on_placement_failure(self, entry: _Entry) -> None:
        """No placement under current availability. Infeasible under FULL
        capacity -> permanent error; otherwise park for retry."""
        scheduler = self._worker.scheduler
        _avail, cap, rows = scheduler.pack_snapshot()
        feasible = cap.shape[0] > 0 and kernels.pack_bundles_np(
            entry.demands, cap, cap, entry.strategy,
            eligible=self._eligibility(entry, rows)) is not None
        if not feasible and not self.hold_infeasible:
            with self._lock:
                entry.state = "INFEASIBLE"
            self._worker.memory_store.put(
                entry.ready_oid,
                PlacementGroupUnschedulableError(
                    f"placement group {entry.pg_id.hex()[:16]} "
                    f"({entry.strategy}, {entry.bundles}) cannot fit the "
                    "cluster at any load"),
                is_exception=True)
            return
        with self._lock:
            self._pending.append(entry.pg_id)
            self._ensure_retry_thread_locked()
        self._retry_wake.set()

    def _ensure_retry_thread_locked(self) -> None:
        # ONE long-lived retry thread: an exit-when-empty design races
        # poke() (thread observed alive while exiting -> wake lost and
        # the pending group never retries), so the thread only exits
        # on shutdown and sleeps eventless while nothing is pending
        if self._retry_thread is None:
            self._retry_thread = threading.Thread(
                target=self._retry_loop, daemon=True,
                name="ray_tpu_pg_retry")
            self._retry_thread.start()

    def on_node_dead(self, node_index: int) -> None:
        """Node death: groups with bundles parented to the dead node lose
        their reservation and return to PENDING for re-placement on the
        survivors (reference: GcsPlacementGroupManager reschedules bundles
        of dead nodes; ready() stays fulfilled across the move).

        Order matters: the old rows are torn down while the group sits in
        RESCHEDULING — if it went PENDING first, the retry thread could
        re-place it and the deferred remove_pg would then destroy the NEW
        rows (same pg_id)."""
        scheduler = self._worker.scheduler
        with self._lock:
            affected = []
            for e in self._table.values():
                if e.state != "CREATED":
                    continue
                parents = [getattr(scheduler.node_state(r), "parent", -1)
                           for r in e.rows]
                if node_index in parents:
                    affected.append(e)
            for e in affected:
                e.state = "RESCHEDULING"
                e.rows = []
        for e in affected:
            scheduler.remove_pg(e.pg_id)
        with self._lock:
            for e in affected:
                if e.state == "RESCHEDULING":
                    e.state = "PENDING"
                    if e.pg_id not in self._pending:
                        self._pending.append(e.pg_id)
            if affected:
                self._ensure_retry_thread_locked()
        if affected:
            self._retry_wake.set()

    def _retry_loop(self) -> None:
        while not self._shutdown:
            with self._lock:
                has_pending = bool(self._pending)
            self._retry_wake.wait(timeout=0.05 if has_pending else None)
            self._retry_wake.clear()
            if self._shutdown:
                return
            with self._lock:
                if self._provisioning:
                    continue  # retried when the scale-up's hold ends
                pending = [self._table[p] for p in self._pending]
            # strict QoS tiers, FIFO within: a freed slice goes to the
            # highest-tier pending gang first (stable sort preserves
            # submission order inside a tier — same discipline as
            # kernels.pack_gangs_tiered_np)
            pending.sort(key=lambda e: -e.priority)
            for entry in pending:
                if entry.state != "PENDING":
                    with self._lock:
                        if entry.pg_id in self._pending:
                            self._pending.remove(entry.pg_id)
                    continue
                if self._try_place(entry):
                    with self._lock:
                        if entry.pg_id in self._pending:
                            self._pending.remove(entry.pg_id)
