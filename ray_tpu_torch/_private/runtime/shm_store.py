"""Shared-memory object store — the plasma analog.

Reference surface: ray src/ray/object_manager/plasma/ (PlasmaStore,
ObjectLifecycleManager, PlasmaClient): a per-node shared-memory arena,
objects written once through a create -> seal lifecycle, then read
zero-copy by any process on the node via mmap.

Differences from upstream: one mmap arena per node owned by the driver
process (the node owner); allocation decisions are made owner-side only
(workers request offsets over their pipe — the create/seal RPC), while
reads and writes go straight through each process's own mapping of the
arena, so object BYTES never cross a pipe. Deserialization wraps numpy
buffers and torch tensors around the arena memory (zero-copy views,
valid while the object is in scope, the same contract as plasma's
read-only buffers).
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreFullError
from ray_tpu_torch._private.serialization import SerializedObject

_ALIGN = 64  # cache-line align allocations


class PyFreeList:
    """Pure-Python first-fit free list: the plain version of the native
    C++ allocator (ray_tpu_torch/_native/allocator.cc), used when that
    cannot build or load; identical first-fit-by-offset semantics,
    parity-tested."""

    def __init__(self, size: int, align: int = _ALIGN):
        self._align = align
        self._free: List[Tuple[int, int]] = [(0, size)]

    def _round(self, nbytes: int) -> int:
        a = self._align
        return max(a, (nbytes + a - 1) & ~(a - 1))

    def allocate(self, nbytes: int) -> int:
        nbytes = self._round(nbytes)
        for i, (off, sz) in enumerate(self._free):
            if sz >= nbytes:
                if sz == nbytes:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + nbytes, sz - nbytes)
                return off
        return -1

    def free(self, offset: int, nbytes: int) -> None:
        nbytes = self._round(nbytes)
        free = self._free
        lo, hi = 0, len(free)
        while lo < hi:
            mid = (lo + hi) // 2
            if free[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        # overlap detection mirrors the native allocator: a double free
        # must raise, not silently corrupt the free list
        if lo < len(free) and offset + nbytes > free[lo][0]:
            raise ValueError(
                f"invalid free: [{offset}, {offset + nbytes}) overlaps "
                "an existing hole (double free?)")
        if lo > 0:
            po, ps = free[lo - 1]
            if po + ps > offset:
                raise ValueError(
                    f"invalid free: [{offset}, {offset + nbytes}) "
                    "overlaps an existing hole (double free?)")
        free.insert(lo, (offset, nbytes))
        if lo + 1 < len(free):
            o, s = free[lo]
            o2, s2 = free[lo + 1]
            if o + s == o2:
                free[lo] = (o, s + s2)
                free.pop(lo + 1)
        if lo > 0:
            o, s = free[lo - 1]
            o2, s2 = free[lo]
            if o + s == o2:
                free[lo - 1] = (o, s + s2)
                free.pop(lo)

    def free_bytes(self) -> int:
        return sum(s for _, s in self._free)

    def num_holes(self) -> int:
        return len(self._free)


def make_free_list(size: int, align: int = _ALIGN):
    """Native C++ allocator when buildable, Python fallback otherwise."""
    try:
        from ray_tpu_torch._native import NativeFreeList

        return NativeFreeList(size, align)
    except ImportError:
        return PyFreeList(size, align)


class _QuietSharedMemory(shared_memory.SharedMemory):
    """SharedMemory whose finalizer tolerates live zero-copy exports.

    A user legitimately holding an arena-backed array (Arrow column,
    numpy view) past store shutdown makes mmap.close() raise
    BufferError; stdlib __del__ re-raises it as an unraisable warning
    on every GC. The mapping simply stays until the views die (the OS
    reclaims at process exit either way) — that's the documented
    zero-copy contract, not an error."""

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


class ShmArena:
    """A named shared-memory segment + free-list allocator (native C++
    core via ray_tpu_torch/_native, Python fallback).

    The allocator lives ONLY in the owner process; attached clients
    (worker processes) are handed (offset, size) pairs and use views.
    """

    def __init__(self, size: int, name: Optional[str] = None,
                 create: bool = True):
        self._shm = _QuietSharedMemory(
            name=name, create=create, size=size if create else 0)
        if not create:
            # Python <=3.12 registers attached segments with the
            # resource_tracker, which UNLINKS them when the attaching
            # process exits — a worker exiting would destroy the node's
            # arena under the driver. The owner is responsible for unlink.
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(self._shm._name,  # noqa: SLF001
                                            "shared_memory")
            except Exception:
                pass
        self.name = self._shm.name
        self.size = self._shm.size
        self._owner = create
        self._alloc = make_free_list(self.size) if create else None
        self._lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.runtime.shm_store.ShmArena._lock")

    @classmethod
    def attach(cls, name: str) -> "ShmArena":
        return cls(0, name=name, create=False)

    # -- allocator (owner side only) ---------------------------------------
    def allocate(self, nbytes: int) -> int:
        if self._alloc is None:
            raise RuntimeError("allocate() on an ATTACHED arena: only "
                               "the owner process allocates; clients "
                               "request offsets over the create RPC")
        with self._lock:
            off = self._alloc.allocate(nbytes)
            if off >= 0:
                return off
            raise ObjectStoreFullError(
                f"shm arena full: requested {nbytes} bytes, "
                f"{self._alloc.free_bytes()} free (fragmented across "
                f"{self._alloc.num_holes()} holes)")

    def free(self, offset: int, nbytes: int) -> None:
        if self._alloc is None:
            raise RuntimeError("free() on an ATTACHED arena: only the "
                               "owner process manages allocations")
        with self._lock:
            self._alloc.free(offset, nbytes)

    def free_bytes(self) -> int:
        if self._alloc is None:
            return 0  # attached client: no allocator view
        with self._lock:
            return self._alloc.free_bytes()

    # -- data access (any process) -----------------------------------------
    def view(self, offset: int, nbytes: int) -> memoryview:
        return self._shm.buf[offset:offset + nbytes]

    def close(self) -> None:
        try:
            self._shm.close()
        except BufferError:
            # exported zero-copy views still alive (user holds arrays);
            # the mapping stays until they are collected
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


# one tag byte prefixes every ring slot so both directions stay
# self-describing (and the runtime wire sanitizer can reconstruct the
# tagged-tuple form a pipe would have carried)
RING_TAGS = {1: "env", 2: "cenv"}
RING_TAG_BYTE = {name: bytes([code]) for code, name in RING_TAGS.items()}


class ControlRing:
    """Fixed-slot SPSC ring over a region of the shm arena — the
    control-plane sibling of the data-plane object store.

    Reference surface: LMAX-disruptor-style sequence stamping. Layout:
    a 128-byte header (two cache lines: producer cursor at +0, consumer
    cursor at +64) followed by ``nslots`` slots of ``slot_bytes`` each;
    a slot is ``[seq u32][len u32][payload]``. The producer writes the
    payload and length first and publishes by storing the slot's
    sequence stamp LAST — a single aligned 4-byte store, so the
    consumer observes either the whole message or none of it (x86/ARM
    release-on-store is sufficient for SPSC; the pipe doorbell that
    follows every put provides the cross-core ordering hop anyway).

    Strictly single-producer / single-consumer: the owner serializes
    producers with the handle's send lock, the worker consumes from its
    main thread only. Messages never span slots — anything larger than
    ``max_msg`` is the caller's cue to fall back to the pipe.
    """

    HEADER = 128
    _U32 = struct.Struct("<I")

    def __init__(self, arena: "ShmArena", offset: int, nslots: int,
                 slot_bytes: int, create: bool = False):
        self.offset = offset
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.max_msg = slot_bytes - 8
        self._buf = arena.view(offset, self.region_bytes(nslots,
                                                         slot_bytes))
        self._wseq = 0  # producer-local cursor
        self._rseq = 0  # consumer-local cursor
        if create:
            # zero cursors AND every slot stamp: the region may be
            # recycled from the arena free list, and a stale stamp
            # equal to an expected sequence would replay garbage
            u32, buf = self._U32, self._buf
            u32.pack_into(buf, 0, 0)
            u32.pack_into(buf, 64, 0)
            for i in range(nslots):
                u32.pack_into(buf, self.HEADER + i * slot_bytes, 0)

    @classmethod
    def region_bytes(cls, nslots: int, slot_bytes: int) -> int:
        return cls.HEADER + nslots * slot_bytes

    def try_put(self, data) -> bool:
        """Publish one message; False = full or oversized (caller falls
        back to the pipe). Producer side only."""
        n = len(data)
        if n > self.max_msg:
            return False
        u32, buf = self._U32, self._buf
        w = self._wseq
        if ((w - u32.unpack_from(buf, 64)[0]) & 0xFFFFFFFF) >= self.nslots:
            return False  # consumer hasn't released the oldest slot
        off = self.HEADER + (w % self.nslots) * self.slot_bytes
        buf[off + 8:off + 8 + n] = data
        u32.pack_into(buf, off + 4, n)
        seq = (w + 1) & 0xFFFFFFFF
        u32.pack_into(buf, off, seq)       # publish: stamp goes last
        u32.pack_into(buf, 0, seq)         # advertised producer cursor
        self._wseq = seq
        return True

    def try_get(self) -> Optional[bytes]:
        """Pop the next message, or None when the ring is empty.
        Consumer side only."""
        u32, buf = self._U32, self._buf
        r = self._rseq
        off = self.HEADER + (r % self.nslots) * self.slot_bytes
        expect = (r + 1) & 0xFFFFFFFF
        if u32.unpack_from(buf, off)[0] != expect:
            return None
        n = u32.unpack_from(buf, off + 4)[0]
        data = bytes(buf[off + 8:off + 8 + n])
        self._rseq = expect
        u32.pack_into(buf, 64, expect)     # release the slot
        return data

    def drain(self) -> List[bytes]:
        out: List[bytes] = []
        msg = self.try_get()
        while msg is not None:
            out.append(msg)
            msg = self.try_get()
        return out

    def close(self) -> None:
        try:
            self._buf.release()
        except Exception:
            pass


class _Alloc:
    __slots__ = ("offset", "nbytes", "sealed", "accessed", "spilling")

    def __init__(self, offset: int, nbytes: int):
        self.offset = offset
        self.nbytes = nbytes
        self.sealed = False
        # a located/read object may be backing live zero-copy views in
        # some process; evicting its arena region would reuse the bytes
        # under those views. Never-accessed objects are safe to spill.
        self.accessed = False
        self.spilling = False  # selected for spill; write in progress


class ShmObjectStore:
    """Owner-side object table over a ShmArena: create/seal/locate/free,
    with a DISK SPILL tier under memory pressure.

    Reference: plasma's ObjectLifecycleManager (create->seal lifecycle)
    + the raylet's LocalObjectManager (spill primary copies to external
    storage when the store fills, restore on demand, delete spilled
    files when refs die — ray: src/ray/raylet/local_object_manager.cc).
    Eviction policy: FIFO over sealed objects that were never located/
    read (zero-copy safety, see _Alloc.accessed); the incoming object
    itself spills when eviction can't free enough.
    """

    def __init__(self, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self.arena = ShmArena(capacity_bytes)
        self._capacity = capacity_bytes
        # spill hysteresis: once the arena is forced to spill, keep
        # evicting until usage drops back under this fraction of
        # capacity so the very next create doesn't spill again.
        # >= 1.0 means purely reactive (free only what the allocation
        # needs)
        self._spill_threshold = float(
            getattr(GLOBAL_CONFIG, "object_spill_threshold", 1.0))
        self._table: Dict[ObjectID, _Alloc] = {}
        self._spilled: Dict[ObjectID, Tuple[str, int]] = {}
        configured = getattr(GLOBAL_CONFIG, "object_spill_dir", "")
        self._spill_dir = (spill_dir or configured
                           or tempfile.mkdtemp(prefix="ray_tpu_torch_spill_"))
        os.makedirs(self._spill_dir, exist_ok=True)
        self.num_spilled = 0
        self.num_restored = 0
        # zero-copy pins: object_id -> live-view count; freed-while-
        # pinned ranges wait in _deferred until their last unpin
        self._pins: Dict[ObjectID, int] = {}
        self._deferred: Dict[ObjectID, _Alloc] = {}
        self._lock = runtime_sanitizer.wrap_lock(
            threading.Lock(),
            "_private.runtime.shm_store.ShmObjectStore._lock")

    # -- create/seal lifecycle --------------------------------------------
    def create(self, object_id: ObjectID, nbytes: int) -> int:
        try:
            offset = self.arena.allocate(nbytes)
        except ObjectStoreFullError:
            self._spill_for(nbytes)
            offset = self.arena.allocate(nbytes)  # may raise again
        with self._lock:
            if object_id in self._table or object_id in self._spilled:
                self.arena.free(offset, nbytes)
                raise ValueError(f"object {object_id.hex()} already created")
            self._table[object_id] = _Alloc(offset, nbytes)
        runtime_sanitizer.ledger_alloc("arena", object_id, nbytes)
        return offset

    def seal(self, object_id: ObjectID) -> None:
        with self._lock:
            self._table[object_id].sealed = True

    def locate(self, object_id: ObjectID) -> Optional[Tuple[int, int]]:
        """(offset, nbytes) of a SEALED arena-resident object, else None
        (spilled objects read through get_serialized)."""
        with self._lock:
            alloc = self._table.get(object_id)
            if alloc is None or not alloc.sealed:
                return None
            alloc.accessed = True
            return alloc.offset, alloc.nbytes

    # -- spilling ----------------------------------------------------------
    def _spill_path(self, object_id: ObjectID) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def _spill_for(self, nbytes: int) -> None:
        """Evict sealed never-accessed objects (FIFO) to disk until
        ~nbytes could fit. Best effort: stops when nothing is safely
        evictable.

        The victim STAYS resident (flagged ``spilling``) until its file
        write commits, so concurrent readers never observe a window
        where the object is in neither table; the commit re-checks that
        the object wasn't freed or accessed while the write ran."""
        # object_spill_threshold adds hysteresis: a forced spill frees
        # down to that fraction of capacity (not just the bytes this
        # allocation needs), so a store hovering at the rim doesn't
        # re-spill on every create; >= 1.0 is purely reactive
        target = max(nbytes,
                     nbytes + int(self._capacity
                                  * (1.0 - self._spill_threshold)))
        while self.arena.free_bytes() < target:
            with self._lock:
                victim = next(
                    (oid for oid, a in self._table.items()
                     if a.sealed and not a.accessed and not a.spilling),
                    None)
                if victim is None:
                    return
                alloc = self._table[victim]
                alloc.spilling = True
            path = self._spill_path(victim)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                data = bytes(self.arena.view(alloc.offset, alloc.nbytes))
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError:
                # disk failure: the object simply stays resident
                with self._lock:
                    alloc.spilling = False
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return
            with self._lock:
                current = self._table.get(victim)
                if current is not alloc or alloc.accessed:
                    # freed or read mid-write: abandon the spill (a
                    # reader may hold zero-copy views of the region)
                    if current is alloc:
                        alloc.spilling = False
                    committed = False
                else:
                    del self._table[victim]
                    self._spilled[victim] = (path, alloc.nbytes)
                    self.num_spilled += 1
                    committed = True
            if committed:
                self.arena.free(alloc.offset, alloc.nbytes)
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass


    def contains(self, object_id: ObjectID) -> bool:
        if self.locate(object_id) is not None:
            return True
        with self._lock:
            return object_id in self._spilled

    # -- owner-process direct IO ------------------------------------------
    def put_serialized(self, object_id: ObjectID,
                       sobj: SerializedObject) -> Tuple[int, int]:
        """create + write + seal in the owner process (driver puts); an
        arena that stays full even after eviction spills the NEW object
        straight to disk."""
        nbytes = sobj.framed_nbytes()
        try:
            offset = self.create(object_id, nbytes)
        except ObjectStoreFullError:
            path = self._spill_path(object_id)
            tmp = f"{path}.{os.getpid()}.tmp"
            buf = bytearray(nbytes)
            sobj.write_into(memoryview(buf))
            with open(tmp, "wb") as f:
                f.write(buf)
            os.replace(tmp, path)
            with self._lock:
                self._spilled[object_id] = (path, nbytes)
                self.num_spilled += 1
            runtime_sanitizer.ledger_alloc("spill", object_id, nbytes)
            return (-1, nbytes)
        sobj.write_into(self.arena.view(offset, nbytes))
        self.seal(object_id)
        return offset, nbytes

    # -- peer transfer plane (chunked) ------------------------------------
    def acquire_raw(self, object_id: ObjectID) -> Optional[memoryview]:
        """Pinned raw framed-bytes view of a sealed arena-resident
        object, for zero-copy chunked sends; None when spilled/absent.
        The caller MUST release_raw() when done or the range never
        frees."""
        with self._lock:
            alloc = self._table.get(object_id)
            if alloc is None or not alloc.sealed:
                return None
            alloc.accessed = True
            self._pins[object_id] = self._pins.get(object_id, 0) + 1
            return self.arena.view(alloc.offset, alloc.nbytes)

    def release_raw(self, object_id: ObjectID) -> None:
        self.unpin(object_id)

    def spilled_path(self, object_id: ObjectID) -> Optional[Tuple[str, int]]:
        """(path, nbytes) of a spilled object's on-disk framed bytes."""
        with self._lock:
            return self._spilled.get(object_id)

    def begin_adopt(self, object_id: ObjectID, nbytes: int):
        """Start adopting an incoming peer object of `nbytes` framed
        bytes WITHOUT ever holding them all in anonymous memory:
        ("arena", view) when it fits (the caller fills the view chunk
        by chunk), else ("spill", file) streaming straight to the spill
        tier — how a >arena-sized object lands without OOM. Finish
        with finish_adopt / abort_adopt."""
        try:
            offset = self.create(object_id, nbytes)
            return ("arena", self.arena.view(offset, nbytes))
        except ObjectStoreFullError:
            path = self._spill_path(object_id)
            return ("spill", open(f"{path}.{os.getpid()}.adopt", "wb"))

    def finish_adopt(self, object_id: ObjectID, nbytes: int, kind: str,
                     f=None) -> None:
        if kind == "arena":
            self.seal(object_id)
            return
        f.close()
        path = self._spill_path(object_id)
        os.replace(f"{path}.{os.getpid()}.adopt", path)
        with self._lock:
            self._spilled[object_id] = (path, nbytes)
            self.num_spilled += 1
        runtime_sanitizer.ledger_alloc("spill", object_id, nbytes)

    def abort_adopt(self, object_id: ObjectID, kind: str, f=None) -> None:
        if kind == "arena":
            with self._lock:
                alloc = self._table.pop(object_id, None)
            if alloc is not None:
                self.arena.free(alloc.offset, alloc.nbytes)
            runtime_sanitizer.ledger_free(object_id)
            return
        try:
            f.close()
            os.unlink(f"{self._spill_path(object_id)}.{os.getpid()}.adopt")
        except OSError:
            pass

    def get_serialized_for_view(
            self, object_id: ObjectID
    ) -> Tuple[Optional[SerializedObject], bool]:
        """(sobj, pinned) for a caller that will hand out ZERO-COPY
        views. pinned=True only when served straight from the arena —
        the range is then atomically pinned against free_object reuse
        and the caller must unpin() once the views are collected (the
        plasma Release analog; without it, freeing a consumed block
        while an Arrow/numpy view is alive hands its bytes to the next
        allocation and the view silently mutates). Spill-tier reads
        copy off disk and need no pin."""
        with self._lock:
            alloc = self._table.get(object_id)
            if alloc is not None and alloc.sealed:
                alloc.accessed = True
                self._pins[object_id] = self._pins.get(object_id, 0) + 1
                loc = (alloc.offset, alloc.nbytes)
            else:
                loc = None
        if loc is not None:
            return SerializedObject.from_bytes(self.arena.view(*loc)), True
        return self.get_serialized(object_id), False

    def get_serialized(self, object_id: ObjectID
                       ) -> Optional[SerializedObject]:
        loc = self.locate(object_id)
        if loc is not None:
            offset, nbytes = loc
            return SerializedObject.from_bytes(
                self.arena.view(offset, nbytes))
        with self._lock:
            spilled = self._spilled.get(object_id)
        if spilled is None:
            return None
        # restore from disk (reference: spilled-object restore path); a
        # concurrent free may have unlinked the file -> treat as gone
        try:
            with open(spilled[0], "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        with self._lock:
            self.num_restored += 1
        return SerializedObject.from_bytes(data)

    def unpin(self, object_id: ObjectID) -> None:
        """Zero-copy views of the object were collected; recycle a
        deferred range once the last pin drops."""
        deferred = None
        with self._lock:
            count = self._pins.get(object_id, 0) - 1
            if count > 0:
                self._pins[object_id] = count
            else:
                self._pins.pop(object_id, None)
                deferred = self._deferred.pop(object_id, None)
        if deferred is not None:
            self.arena.free(deferred.offset, deferred.nbytes)

    def free_object(self, object_id: ObjectID) -> None:
        runtime_sanitizer.ledger_free(object_id)
        with self._lock:
            alloc = self._table.pop(object_id, None)
            spilled = self._spilled.pop(object_id, None)
            if alloc is not None and self._pins.get(object_id):
                # live zero-copy views: quarantine the range until the
                # last pin drops (unpin) instead of handing the bytes
                # to the next allocation under those views
                self._deferred[object_id] = alloc
                alloc = None
        if alloc is not None:
            self.arena.free(alloc.offset, alloc.nbytes)
        if spilled is not None:
            try:
                os.unlink(spilled[0])  # spilled files die with the ref
            except FileNotFoundError:
                pass

    # -- stats / lifecycle -------------------------------------------------
    def num_objects(self) -> int:
        with self._lock:
            return len(self._table) + len(self._spilled)

    def num_spilled_objects(self) -> int:
        with self._lock:
            return len(self._spilled)

    def spilled_bytes(self) -> int:
        with self._lock:
            return sum(n for _, n in self._spilled.values())

    def used_bytes(self) -> int:
        return self.arena.size - self.arena.free_bytes()

    def shutdown(self) -> None:
        self.arena.close()
        self.arena.unlink()
        with self._lock:
            self._spilled.clear()
        shutil.rmtree(self._spill_dir, ignore_errors=True)
