"""In-process memory store + pluggable shared-memory backend.

Reference surfaces:
  - CoreWorkerMemoryStore (ray: src/ray/core_worker/store_provider/memory_store/)
    — small objects live in the owner process, get() without IPC.
  - Plasma store (ray: src/ray/object_manager/plasma/) — large objects in a
    per-node shared-memory arena with create→seal lifecycle and eviction.

Here the MemoryStore is the always-present in-process tier; a node-level
shared-memory store (``_private/runtime/shm_store.py``) holds large
objects for multi-process mode. Errors are stored as first-class values
so ray.get re-raises them (reference: RayError in the object store).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.ids import ObjectID


class ObjectStoreFullError(Exception):
    pass


class _Entry:
    __slots__ = ("value", "is_exception", "size", "insert_time")

    def __init__(self, value: Any, is_exception: bool, size: int):
        self.value = value
        self.is_exception = is_exception
        self.size = size
        self.insert_time = time.monotonic()


class MemoryStore:
    """Thread-safe in-process object store with readiness callbacks."""

    def __init__(self):
        self._objects: Dict[ObjectID, _Entry] = {}
        self._lock = threading.Lock()
        self._callbacks: Dict[ObjectID, List[Callable[[], None]]] = {}

    # -- write -------------------------------------------------------------
    def put(self, object_id: ObjectID, value: Any, *, is_exception: bool = False,
            size: int = 0) -> None:
        with self._lock:
            self._objects[object_id] = _Entry(value, is_exception, size)
            # waiters are callback-based (_await_count), nobody blocks
            # on this lock itself — no notify needed
            callbacks = self._callbacks.pop(object_id, None)
        if callbacks:
            for cb in callbacks:
                cb()

    # -- read --------------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def missing_of(self, object_ids: List[ObjectID]) -> List[ObjectID]:
        """Ids NOT present, under one lock hold (a batch get() of 50k
        refs would otherwise pay 50k lock acquisitions up front)."""
        with self._lock:
            objects = self._objects
            return [o for o in object_ids if o not in objects]

    def get_entry(self, object_id: ObjectID) -> Optional[_Entry]:
        with self._lock:
            return self._objects.get(object_id)

    def _await_count(self, object_ids: List[ObjectID], need: int,
                     timeout: Optional[float]) -> int:
        """Block until ``need`` of object_ids are present (or timeout).

        Counter-based: each missing id gets ONE decrement callback, so a
        batch get() of N refs costs O(N) total instead of O(N) rescans
        per arrival (O(N^2), which capped e2e throughput at ~600
        tasks/s). Returns the number still missing (0 = satisfied)."""
        done = threading.Event()
        state_lock = threading.Lock()
        with self._lock:
            pending = {o for o in object_ids if o not in self._objects}
            need_more = need - (len(set(object_ids)) - len(pending))
            if need_more <= 0:
                return 0
            counter = [need_more]  # arrivals still required

            def on_ready() -> None:
                with state_lock:
                    counter[0] -= 1
                    fire = counter[0] == 0
                if fire:
                    done.set()

            for o in pending:
                self._callbacks.setdefault(o, []).append(on_ready)
        satisfied = done.wait(timeout=timeout)
        # Deregister leftover callbacks: a timed-out waiter (or one
        # satisfied by a subset, num_returns < len) would otherwise leak
        # one closure per still-pending id on EVERY call — unbounded
        # growth under the canonical poll loop `while: wait(refs, 1, t)`.
        with self._lock:
            for o in pending:
                lst = self._callbacks.get(o)
                if lst is not None:
                    try:
                        lst.remove(on_ready)
                    except ValueError:
                        pass
                    if not lst:
                        del self._callbacks[o]
            if satisfied:
                return 0
            return sum(1 for o in set(object_ids) if o not in self._objects)

    def wait_and_get(self, object_ids: List[ObjectID],
                     timeout: Optional[float]) -> List[_Entry]:
        """Block until all ids present (or timeout); returns entries in order."""
        n_missing = self._await_count(object_ids, len(set(object_ids)), timeout)
        with self._lock:
            if n_missing:
                missing = [o for o in object_ids if o not in self._objects]
                raise TimeoutError(
                    f"{len(missing)} objects not ready within timeout: "
                    f"{[m.hex()[:16] for m in missing[:3]]}"
                )
            entries = []
            for o in object_ids:
                entry = self._objects.get(o)
                if entry is None:
                    # deleted between the readiness wait and this read
                    # (ref-count release racing a get)
                    from ray_tpu_torch.exceptions import ObjectLostError

                    raise ObjectLostError(
                        f"object {o.hex()[:16]} was freed while being read")
                entries.append(entry)
            return entries

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]) -> Set[ObjectID]:
        """Return the set of ready ids once num_returns are ready or timeout."""
        self._await_count(object_ids, num_returns, timeout)
        with self._lock:
            return {o for o in object_ids if o in self._objects}

    def add_ready_callback(self, object_id: ObjectID, cb: Callable[[], None]):
        fire = False
        with self._lock:
            if object_id in self._objects:
                fire = True
            else:
                self._callbacks.setdefault(object_id, []).append(cb)
        if fire:
            cb()

    # -- lifecycle ---------------------------------------------------------
    def delete(self, object_ids: List[ObjectID]) -> None:
        # Callbacks are NOT dropped: a waiter blocked on a not-yet-stored
        # object must still wake when the value (or its reconstruction)
        # arrives — delete-before-put would otherwise strand it forever.
        with self._lock:
            for o in object_ids:
                self._objects.pop(o, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)

    def entries(self) -> List[tuple]:
        """Snapshot of (object_id, entry) pairs (state observability)."""
        with self._lock:
            return list(self._objects.items())

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.size for e in self._objects.values())
