"""Object recovery — lineage reconstruction.

Reference surface: ObjectRecoveryManager + TaskManager lineage
resubmission (ray: src/ray/core_worker/object_recovery_manager.cc,
task_manager.cc): when a needed object is lost, the OWNER resubmits the
task that produced it, recursively reconstructing lost dependencies
first. Reconstruction attempts count against the task's max_retries and
lineage is bounded by max_lineage_bytes (evicted specs are no longer
recoverable).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID

logger = logging.getLogger(__name__)


class ObjectRecoveryManager:
    def __init__(self, worker):
        self._worker = worker
        self._lock = threading.Lock()
        # producing tasks resubmitted and not yet completed: dedupes
        # concurrent recoveries of the same object/siblings
        self._in_flight: set = set()
        # tombstones: objects KNOWN to have been freed/evicted while
        # referenced. Distinguishes "lost" from "not yet produced" (an
        # actor-call result that hasn't arrived is missing but fine)
        self._freed: set = set()

    def note_freed(self, object_id: ObjectID) -> None:
        with self._lock:
            self._freed.add(object_id)

    def maybe_recover(self, object_id: ObjectID) -> bool:
        """If object_id is gone but its producing task is in the lineage
        table, resubmit that task (recursively recovering ITS lost
        dependencies). Returns True if recovery is underway — the caller
        should then wait on the store as usual.

        A KNOWN-freed object that cannot be reconstructed resolves to an
        ObjectLostError in the store, waking every blocked getter —
        otherwise a timeout-less get() would hang forever."""
        ok = self._recover(object_id, depth=0)
        if not ok:
            w = self._worker
            with self._lock:
                freed = object_id in self._freed
            if freed and not w.memory_store.contains(object_id):
                from ray_tpu_torch.exceptions import ObjectLostError

                w.memory_store.put(
                    object_id,
                    ObjectLostError(
                        f"object {object_id.hex()[:16]} was lost and "
                        "cannot be reconstructed (no lineage, or retries "
                        "exhausted)"),
                    is_exception=True)
                w.scheduler.notify_object_ready(object_id)
        return ok

    def _recover(self, object_id: ObjectID, depth: int) -> bool:
        w = self._worker
        if depth > 100:
            logger.warning("lineage reconstruction recursion cap hit")
            return False
        if w.memory_store.contains(object_id):
            return True
        if object_id.is_put():
            # put() objects have no producing task to re-run; a re-run of
            # the task that CALLED put would store under a fresh task id,
            # never this one
            return False
        producer: TaskID = object_id.task_id()
        with self._lock:
            if producer in self._in_flight:
                return True
        if w.task_manager.get_pending_spec(producer) is not None:
            return True  # still running; the result will arrive
        spec = w.task_manager.get_lineage(producer)
        if spec is None:
            # not in the head-path lineage table — but the producer may
            # have been a LOCALLY-dispatched nested task the head never
            # built a spec for; its retained lease record can still
            # reconstruct (even though the submitting owner died with
            # the same node)
            return self._recover_local_lease(object_id, producer)
        if spec.attempt_number >= spec.max_retries:
            logger.warning(
                "cannot reconstruct %s: task %s exhausted its %d retries",
                object_id.hex()[:16], spec.name, spec.max_retries)
            return False

        # recursively ensure the producer's own inputs exist (or are
        # being reconstructed) — the resubmitted task waits on them
        # through the normal dependency machinery
        from ray_tpu_torch._private.worker import _top_level_deps

        deps = _top_level_deps(spec.args, spec.kwargs)
        for dep in deps:
            if not w.memory_store.contains(dep):
                if not self._recover(dep, depth + 1):
                    logger.warning(
                        "cannot reconstruct %s: dependency %s is itself "
                        "unrecoverable", object_id.hex()[:16],
                        dep.hex()[:16])
                    return False

        original_returns = [ObjectID.for_task_return(producer, i)
                            for i in range(spec.num_returns)]
        with self._lock:
            if producer in self._in_flight:
                return True
            self._in_flight.add(producer)
        spec.attempt_number += 1
        w.task_manager.num_retries += 1
        spec.task_id = w.next_task_id()
        spec._retry_return_ids = original_returns  # type: ignore[attr-defined]
        logger.info("lineage reconstruction: resubmitting %s (attempt "
                    "%d/%d) to recover %s", spec.name, spec.attempt_number,
                    spec.max_retries, object_id.hex()[:16])

        # pending under the NEW id; the ORIGINAL id's lineage entry stays
        # (the spec object is shared, so attempt counts persist) — return
        # ids derive from the original id and future losses must still
        # resolve their producer. In-flight marker clears when the first
        # return lands.
        w.task_manager.add_pending(spec, deps)

        def _done() -> None:
            with self._lock:
                self._in_flight.discard(producer)
                self._freed.discard(object_id)

        # watch the object being RECOVERED (not returns[0], which may
        # still be present and would fire the callback synchronously,
        # clearing the dedup marker while the resubmission is queued)
        w.memory_store.add_ready_callback(object_id, _done)

        from ray_tpu_torch._private.scheduler.base import PendingTask

        unresolved = [d for d in deps if not w.memory_store.contains(d)]
        w.reference_counter.add_submitted_task_references(deps)
        w.scheduler.submit(PendingTask(spec=spec, deps=unresolved,
                                       execute=lambda t, n: None))
        return True

    def _recover_local_lease(self, object_id: ObjectID,
                             producer: TaskID) -> bool:
        """Reconstruct through a completed local-lease record: the
        node's LocalScheduler admitted the producer without a head
        round-trip, so no TaskSpec ever existed head-side — only the
        adopted lease's record (fn/args blobs, attempt token) did.
        Resubmitting through it re-derives the sole-copy returns under
        their ORIGINAL ids; once that completes, the rebuilt spec
        lands in the normal lineage table and future losses take the
        spec path above."""
        w = self._worker
        tid_bin = producer.binary()
        with self._lock:
            if producer in self._in_flight:
                return True
        rec = w.take_local_lease_lineage(tid_bin)
        if rec is None:
            return False  # never seen, evicted, or a put() object
        with self._lock:
            if producer in self._in_flight:
                return True
            self._in_flight.add(producer)
        w.task_manager.num_retries += 1
        logger.info(
            "lineage reconstruction: resubmitting local lease %s "
            "(attempt %d/%d) to recover %s", rec.get("name"),
            int(rec.get("attempt", 0)) + 1, int(rec.get("max_retries", 0)),
            object_id.hex()[:16])

        def _done() -> None:
            with self._lock:
                self._in_flight.discard(producer)
                self._freed.discard(object_id)

        w.memory_store.add_ready_callback(object_id, _done)
        if not w._resubmit_lease(tid_bin, dict(rec),
                                 why="lineage reconstruction"):
            _done()
            return False
        return True

    def recover_all(self, object_ids: List[ObjectID]) -> None:
        """Bulk entry (the get() path): ids whose producer is still
        PENDING are the overwhelmingly common case (get right after
        submit) and need no recovery — filter them under ONE
        task-manager lock hold instead of walking the full per-object
        recovery probe for each."""
        for oid in self._worker.task_manager.filter_not_pending(
                object_ids):
            self.maybe_recover(oid)
