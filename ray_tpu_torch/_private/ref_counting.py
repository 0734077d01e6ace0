"""Distributed reference counting + lineage ownership tables.

Reference surface: ray src/ray/core_worker/reference_count.cc
(ReferenceCounter) and task_manager.cc lineage pinning. Semantics kept:

  - Every object has an OWNER (the worker that created it). The owner row
    tracks: local refcount (python handles), submitted-task count (pending
    tasks that take the object as an arg), borrower set, lineage pin.
  - An object is eligible for deletion when local==0, submitted==0 and no
    borrowers remain.
  - Lineage: while an object is reachable, the spec of the task that
    created it is retained so the object can be reconstructed (bounded by
    max_lineage_bytes).

The single-process implementation keeps all rows in one table keyed by
ObjectID; in multi-node mode each worker holds rows for objects it owns
and borrow bookkeeping mirrors the WaitForRefRemoved protocol via the
control plane's pubsub.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.ids import ObjectID, TaskID, WorkerID


class _Ref:
    __slots__ = ("local", "submitted", "borrowers", "lineage_task",
                 "pinned", "on_delete")

    def __init__(self):
        self.local = 0
        self.submitted = 0
        self.borrowers: Set[WorkerID] = set()
        self.lineage_task: Optional[TaskID] = None
        self.pinned = False  # e.g. detached / named objects
        self.on_delete: List[Callable[[], None]] = []

    def out_of_scope(self) -> bool:
        return (self.local <= 0 and self.submitted <= 0
                and not self.borrowers and not self.pinned)


class ReferenceCounter:
    def __init__(self, on_object_out_of_scope: Callable[[ObjectID], None]):
        self._refs: Dict[ObjectID, _Ref] = {}
        self._lock = runtime_sanitizer.wrap_lock(
            threading.RLock(), "_private.ref_counting.ReferenceCounter._lock")
        self._on_out_of_scope = on_object_out_of_scope

    # -- local handles -----------------------------------------------------
    def add_owned_object(self, object_id: ObjectID,
                         lineage_task: Optional[TaskID] = None) -> None:
        with self._lock:
            ref = self._refs.setdefault(object_id, _Ref())
            ref.lineage_task = lineage_task

    def add_local_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, _Ref()).local += 1

    def num_local_references(self, object_id: ObjectID) -> int:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.local if ref is not None else 0

    def remove_local_reference(self, object_id: ObjectID) -> None:
        self._maybe_delete(object_id, "local")

    def register_submit_batch(self, owned, deps) -> None:
        """One lock hold for a whole submit batch: ``owned`` yields
        (object_id, lineage_task_id) pairs that ALSO take the caller's
        local handle (+1 local — the returned ObjectRefs are built
        pre-registered), ``deps`` yields argument ids to pin."""
        with self._lock:
            refs = self._refs
            for oid, lineage in owned:
                r = refs.setdefault(oid, _Ref())
                r.lineage_task = lineage
                r.local += 1
            for d in deps:
                refs.setdefault(d, _Ref()).submitted += 1

    # -- task-argument pins ------------------------------------------------
    def add_submitted_task_references(self, object_ids: List[ObjectID]) -> None:
        with self._lock:
            for o in object_ids:
                self._refs.setdefault(o, _Ref()).submitted += 1

    def remove_submitted_task_references(self, object_ids: List[ObjectID]) -> None:
        for o in object_ids:
            self._maybe_delete(o, "submitted")

    # -- borrowers (refs serialized into other objects / other workers) ----
    def add_borrower(self, object_id: ObjectID, borrower: WorkerID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, _Ref()).borrowers.add(borrower)

    def remove_borrower(self, object_id: ObjectID, borrower: WorkerID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.borrowers.discard(borrower)
            delete = ref.out_of_scope()
            if delete:
                del self._refs[object_id]
        if delete:
            self._fire_delete(object_id, ref)

    # -- pinning -----------------------------------------------------------
    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, _Ref()).pinned = True

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.pinned = False
        self._maybe_delete(object_id, None)

    # -- queries -----------------------------------------------------------
    def has_reference(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._refs

    def lineage_task(self, object_id: ObjectID) -> Optional[TaskID]:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.lineage_task if ref else None

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def snapshot(self) -> Dict[ObjectID, tuple]:
        """ObjectID -> (local, submitted, num_borrowers, pinned) for
        every live row — the runtime sanitizer's shutdown census."""
        with self._lock:
            return {oid: (r.local, r.submitted, len(r.borrowers),
                          r.pinned)
                    for oid, r in self._refs.items()}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "tracked": len(self._refs),
                "local_total": sum(r.local for r in self._refs.values()),
                "submitted_total": sum(r.submitted for r in self._refs.values()),
                "borrowed_total": sum(len(r.borrowers) for r in self._refs.values()),
            }

    # -- internals ---------------------------------------------------------
    def _maybe_delete(self, object_id: ObjectID, field: Optional[str]) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            if field == "local":
                ref.local -= 1
            elif field == "submitted":
                ref.submitted -= 1
            if not ref.out_of_scope():
                return
            del self._refs[object_id]
        self._fire_delete(object_id, ref)

    def _fire_delete(self, object_id: ObjectID, ref: _Ref) -> None:
        for cb in ref.on_delete:
            try:
                cb()
            except Exception:
                pass
        self._on_out_of_scope(object_id)
