"""Binary ID types for the TPU-native runtime.

Mirrors the reference's structured-ID scheme (ray: src/ray/common/id.h —
BaseID/JobID/TaskID/ObjectID/ActorID/NodeID) but with a compact 16-byte
layout instead of 28 bytes: embedded structure lets the owner of an
ObjectRef be derived from the ID alone.

Layout (16 bytes, big-endian fields):
  JobID    = 4 random bytes
  ActorID  = JobID(4) + 8 random bytes                    -> 12 bytes
  TaskID   = JobID(4) + 8 unique bytes + 4-byte task seq  -> 16 bytes
  ObjectID = TaskID(16 with seq replaced) + 2-byte return index folded in

We keep ObjectID = TaskID bytes + 4-byte index, total 20 bytes, so that
``ObjectID.task_id()`` is a pure slice — the property the scheduler kernel
exploits to build dependency edges without a hash lookup.
"""

from __future__ import annotations

import os
import struct
import threading

_JOB_LEN = 4
_TASK_LEN = 16
_ACTOR_LEN = 12
_OBJECT_LEN = 20
_NODE_LEN = 16
_WORKER_LEN = 16
_PG_LEN = 12


class BaseID(bytes):
    """Immutable binary identifier; hashable, ordered, hex-printable.

    Subclasses ``bytes`` so that every dict/set operation keyed on an ID
    hashes and compares at C level — the previous Python ``__hash__``
    ran ~28 times per task across the submit/execute/complete path and
    was a measurable slice of the e2e task budget. Different ID kinds
    never collide in practice: lengths differ (ObjectID 20B vs TaskID
    16B) or the bytes are random. ``self`` IS the binary value, so the
    ``task_id()``-is-a-slice property the scheduler kernel exploits
    still holds.
    """

    __slots__ = ()
    _LENGTH = 16

    def __new__(cls, binary: bytes) -> "BaseID":
        if len(binary) != cls._LENGTH:
            raise ValueError(
                f"{cls.__name__} requires {cls._LENGTH} bytes, "
                f"got {len(binary)}"
            )
        return bytes.__new__(cls, binary)

    def __reduce__(self):
        # route unpickling through __new__ (bytes' default reduce would
        # bypass the length check)
        return (type(self), (bytes(self),))

    @property
    def _bytes(self) -> bytes:
        return bytes(self)

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls._LENGTH))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls._LENGTH)

    def is_nil(self) -> bool:
        return bytes(self) == b"\x00" * self._LENGTH

    def binary(self) -> bytes:
        return bytes(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"


class JobID(BaseID):
    __slots__ = ()
    _LENGTH = _JOB_LEN

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", bytes(self))[0]


class NodeID(BaseID):
    __slots__ = ()
    _LENGTH = _NODE_LEN


class WorkerID(BaseID):
    __slots__ = ()
    _LENGTH = _WORKER_LEN


class ActorID(BaseID):
    __slots__ = ()
    _LENGTH = _ACTOR_LEN

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(_ACTOR_LEN - _JOB_LEN))

    def job_id(self) -> JobID:
        return JobID(self[:_JOB_LEN])


class TaskID(BaseID):
    __slots__ = ()
    _LENGTH = _TASK_LEN

    @classmethod
    def of(cls, job_id: JobID, unique: bytes | None = None, seq: int = 0) -> "TaskID":
        if unique is None:
            unique = os.urandom(8)
        return cls(job_id.binary() + unique[:8] + struct.pack(">I", seq & 0xFFFFFFFF))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID, seq: int) -> "TaskID":
        # actor tasks embed the actor's unique bytes so lineage groups by actor
        return cls(actor_id.binary()[:12] + struct.pack(">I", seq & 0xFFFFFFFF))

    def job_id(self) -> JobID:
        return JobID(self[:_JOB_LEN])

    def seq(self) -> int:
        return struct.unpack(">I", self[12:16])[0]


class ObjectID(BaseID):
    """ObjectID = creating TaskID (16B) + big-endian return index (4B)."""

    __slots__ = ()
    _LENGTH = _OBJECT_LEN

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # put objects use the high bit of the index to avoid collision with
        # task returns (reference: ObjectID::FromIndex put/return split)
        return cls(task_id.binary() + struct.pack(">I", 0x80000000 | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self[:_TASK_LEN])

    def return_index(self) -> int:
        return struct.unpack(">I", self[16:20])[0] & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(struct.unpack(">I", self[16:20])[0] & 0x80000000)

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class PlacementGroupID(BaseID):
    __slots__ = ()
    _LENGTH = _PG_LEN

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + os.urandom(_PG_LEN - _JOB_LEN))

    def job_id(self) -> JobID:
        return JobID(self[:_JOB_LEN])


class _Counter:
    """Thread-safe monotonically increasing counter (itertools.count is
    a single C-level op: atomic under the GIL, no lock round trip)."""

    def __init__(self):
        import itertools
        self._it = itertools.count(1)

    def next(self) -> int:
        return next(self._it)
