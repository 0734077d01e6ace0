"""ObjectRef — a future/handle for an object in the distributed store.

Reference surface: python/ray/_raylet.pyx ObjectRef + the ownership model
(each ref has an owner worker that holds refcount, locations, lineage).
Serializing a ref inside another object registers a borrow with the owner.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.ids import ObjectID, TaskID, WorkerID

if TYPE_CHECKING:
    from ray_tpu_torch._private.worker import Worker


class ObjectRef:
    # __weakref__ lets the runtime sanitizer census live instances
    # without extending their lifetime
    __slots__ = ("_id", "_owner_id", "_weak", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_id: Optional[WorkerID] = None,
                 *, _register: bool = True):
        self._id = object_id
        self._owner_id = owner_id
        self._weak = not _register
        if _register:
            _global_worker = _get_worker()
            if _global_worker is not None:
                _global_worker.reference_counter.add_local_reference(object_id)
                if runtime_sanitizer._ENABLED:
                    runtime_sanitizer.track_ref(self)

    # -- identity ----------------------------------------------------------
    def object_id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def task_id(self) -> TaskID:
        return self._id.task_id()

    def owner_id(self) -> Optional[WorkerID]:
        return self._owner_id

    # -- convenience -------------------------------------------------------
    def future(self):
        """Return a concurrent.futures.Future resolved with the value."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        worker = _get_worker()

        def _resolve():
            try:
                fut.set_result(worker.get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        worker.run_callback_when_ready(self._id, _resolve)
        return fut

    def __await__(self):
        """Support `await ref` inside async actors."""
        import asyncio

        loop = asyncio.get_event_loop()
        worker = _get_worker()
        afut = loop.create_future()

        def _resolve():
            def _set():
                if afut.cancelled():
                    return
                try:
                    afut.set_result(worker.get([self], timeout=0)[0])
                except BaseException as e:  # noqa: BLE001
                    afut.set_exception(e)

            loop.call_soon_threadsafe(_set)

        worker.run_callback_when_ready(self._id, _resolve)
        return afut.__await__()

    # -- lifecycle ---------------------------------------------------------
    def __del__(self):
        # GC can run __del__ inside ANY allocation, including while runtime
        # locks are held — defer the unref to the worker's drain thread.
        if not self._weak:
            try:
                worker = _get_worker()
                if worker is not None and worker.alive:
                    worker.defer_unref(self._id)
            except BaseException:  # interpreter teardown: globals/imports gone
                pass

    def __reduce__(self):
        # A deserialized copy registers itself as a borrower on unpickle.
        return (_deserialize_ref, (self._id.binary(),
                                   self._owner_id.binary() if self._owner_id else None))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"


def _deserialize_ref(id_binary: bytes, owner_binary: Optional[bytes]) -> ObjectRef:
    owner = WorkerID(owner_binary) if owner_binary else None
    return ObjectRef(ObjectID(id_binary), owner)


def _get_worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker
