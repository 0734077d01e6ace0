"""Object serialization with zero-copy out-of-band buffers.

Role of the reference's python/ray/_private/serialization.py: pickle
protocol 5 with out-of-band PickleBuffers so large numpy arrays and torch
tensors are serialized as (metadata, raw buffer list) and can be placed in
shared memory without a copy. A CUDA tensor becomes host bytes here and
only here: thread-mode ``put``/``get`` hand back the same device tensor,
and serializing is the seam where a value leaves the process. ObjectRefs found inside
values are recorded so the owner can track borrowers (reference:
ReferenceCounter borrower protocol).
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, Callable, Dict, List, Tuple

import numpy as np


class SerializedObject:
    """Pickled metadata + out-of-band buffers; total_bytes is the store cost."""

    __slots__ = ("meta", "buffers", "contained_refs")

    def __init__(self, meta: bytes, buffers: List[memoryview], contained_refs: list):
        self.meta = meta
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return len(self.meta) + sum(len(b) for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten to one contiguous blob: [meta_len][meta][nbuf][len,buf]*."""
        out = io.BytesIO()
        out.write(len(self.meta).to_bytes(8, "little"))
        out.write(self.meta)
        out.write(len(self.buffers).to_bytes(4, "little"))
        for b in self.buffers:
            out.write(len(b).to_bytes(8, "little"))
            out.write(b)
        return out.getvalue()

    def framed_nbytes(self) -> int:
        """Size of the to_bytes() framing without materializing it."""
        return 8 + len(self.meta) + 4 + sum(8 + len(b) for b in self.buffers)

    def write_into(self, view: memoryview) -> int:
        """Write the framed form straight into a caller-provided buffer
        (the shm arena) — single copy, no intermediate blob."""
        off = 0

        def put(b: bytes | memoryview):
            nonlocal off
            n = len(b)
            view[off:off + n] = b
            off += n

        put(len(self.meta).to_bytes(8, "little"))
        put(self.meta)
        put(len(self.buffers).to_bytes(4, "little"))
        for b in self.buffers:
            put(len(b).to_bytes(8, "little"))
            put(b)
        return off

    @classmethod
    def frame_complete(cls, blob: memoryview | bytes) -> bool:
        """Whether `blob` holds a whole to_bytes() frame. Wire fetches
        must check this before from_bytes: memoryview slicing past the
        end silently yields SHORT buffers, so a truncated transfer
        would otherwise deserialize into corrupt data instead of being
        retried as a lost object."""
        view = memoryview(blob)
        total = len(view)
        if total < 8:
            return False
        off = 8 + int.from_bytes(view[:8], "little")
        if off + 4 > total:
            return False
        nbuf = int.from_bytes(view[off:off + 4], "little")
        off += 4
        for _ in range(nbuf):
            if off + 8 > total:
                return False
            off += 8 + int.from_bytes(view[off:off + 8], "little")
        return off <= total

    @classmethod
    def from_bytes(cls, blob: memoryview | bytes) -> "SerializedObject":
        view = memoryview(blob)
        meta_len = int.from_bytes(view[:8], "little")
        off = 8
        meta = bytes(view[off : off + meta_len])
        off += meta_len
        nbuf = int.from_bytes(view[off : off + 4], "little")
        off += 4
        buffers = []
        for _ in range(nbuf):
            blen = int.from_bytes(view[off : off + 8], "little")
            off += 8
            buffers.append(view[off : off + blen])
            off += blen
        return cls(meta, buffers, [])


_custom_serializers: Dict[type, Tuple[Callable, Callable]] = {}


def register_serializer(cls: type, *, serializer: Callable, deserializer: Callable):
    """ray.util.register_serializer equivalent."""
    _custom_serializers[cls] = (serializer, deserializer)


def deregister_serializer(cls: type):
    _custom_serializers.pop(cls, None)


class _Pickler(pickle.Pickler):
    def __init__(self, file, contained_refs: list):
        super().__init__(file, protocol=5, buffer_callback=self._buffer_cb)
        self._oob: List[memoryview] = []
        self._contained_refs = contained_refs

    def _buffer_cb(self, buf: pickle.PickleBuffer):
        self._oob.append(buf.raw())
        return False  # out-of-band

    def reducer_override(self, obj):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if type(obj) in _custom_serializers:
            ser, deser = _custom_serializers[type(obj)]
            return (_reconstruct_custom, (type(obj), ser(obj)))
        if isinstance(obj, ObjectRef):
            self._contained_refs.append(obj)
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) is torch.Tensor
                and obj.device.type == "cpu"):
            # the bytes ride out-of-band as a uint8 numpy view (bf16 has
            # no numpy dtype); torch's own reducer copies them in-band
            flat = obj.detach().contiguous().reshape(-1)
            return (_rebuild_tensor,
                    (flat.view(torch.uint8).numpy(), str(obj.dtype),
                     tuple(obj.shape), obj.requires_grad))
        return NotImplemented


def _reconstruct_custom(cls, payload):
    return _custom_serializers[cls][1](payload)


def _rebuild_tensor(data: np.ndarray, dtype: str, shape, requires_grad):
    import torch

    if not data.flags.writeable:
        data = data.copy()  # torch tensors are writable
    t = torch.from_numpy(data).view(getattr(torch, dtype.split(".")[-1]))
    return t.reshape(shape).requires_grad_(requires_grad)


def serialize(value: Any) -> SerializedObject:
    contained_refs: list = []
    f = io.BytesIO()
    p = _Pickler(f, contained_refs)
    # device tensors: copy to the host once so the buffer is mmap-able
    value = _device_to_host(value)
    p.dump(value)
    return SerializedObject(f.getvalue(), p._oob, contained_refs)


def deserialize(obj: SerializedObject) -> Any:
    buffers = [pickle.PickleBuffer(b) for b in obj.buffers]
    return pickle.loads(obj.meta, buffers=buffers)


class _BufferAnchor(np.ndarray):
    """Weakref-able buffer-protocol re-exporter. Reconstructed views
    (numpy arrays, Arrow buffers — and anything sliced off them) keep
    their buffer EXPORTER alive through the C buffer protocol; plain
    memoryviews cannot take weakrefs, so re-exporting through this
    anchor is what lets a finalizer observe the true last-view death.
    An ndarray view (not a class with ``__buffer__``, which only
    Python 3.12+ honours) so the anchor exports the buffer protocol
    on every supported interpreter."""


def _anchor(buf) -> _BufferAnchor:
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return np.frombuffer(mv, dtype=np.uint8).view(_BufferAnchor)


def deserialize_with_release(obj: SerializedObject,
                             release: Callable[[], None]) -> Any:
    """deserialize(), with `release()` called when the LAST object
    aliasing obj's out-of-band buffers is garbage-collected — including
    sub-views extracted later (an Arrow column taken off a Table, a
    numpy slice). Used by the shm store's zero-copy read path to hold
    the arena pin for exactly the views' lifetime."""
    import weakref

    if not obj.buffers:
        try:
            return deserialize(obj)  # plain pickle: nothing aliases
        finally:
            release()
    anchors = [_anchor(b) for b in obj.buffers]
    remaining = [len(anchors)]

    def _one_done():
        remaining[0] -= 1
        if remaining[0] == 0:
            release()

    for a in anchors:
        weakref.finalize(a, _one_done)
    rewrapped = SerializedObject(obj.meta,
                                 [memoryview(a) for a in anchors],
                                 obj.contained_refs)
    return deserialize(rewrapped)


def _device_to_host(value: Any) -> Any:
    """Copy device tensor leaves to the host (host tensors pass as they
    are): the port's counterpart of the reference's jax.Array -> numpy.
    A process that never imported torch holds no tensor, so torch is
    looked up here and in the pickler, never imported: a node daemon
    moves objects without paying torch's import."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return value if value.device.type == "cpu" else value.cpu()
    if isinstance(value, tuple):
        return tuple(_device_to_host(v) for v in value)
    if isinstance(value, list):
        return [_device_to_host(v) for v in value]
    if isinstance(value, dict):
        return {k: _device_to_host(v) for k, v in value.items()}
    return value


# ---------------------------------------------------------------------------
# completion-envelope codec: batched worker -> owner results
# ---------------------------------------------------------------------------
# The worker's buffered completions (the ``_done_buf`` the pipe used to
# carry as per-message pickles) pack into one struct-framed envelope for
# the shared-memory completion ring. Item shapes are exactly the pipe
# messages: ("done", task_id, entries, (t0, t1)) with entries of
# ("inline", blob) | ("shm", offset, nbytes), and
# ("err", task_id, exc_blob, traceback_str, (t0, t1)).
#
# Layout (little-endian):
#   u8 version, u16 nitems
#   item: u8 kind (0 done / 1 err), 16s task_id, d t0, d t1
#     done: u8 nentries; entry: u8 etype
#           etype 0: u32 len, inline blob
#           etype 1: u64 offset, u64 nbytes
#     err:  u32 len, exc blob; u32 len, utf-8 traceback

import struct as _struct

COMPLETION_VERSION = 1
_C_U8 = _struct.Struct("<B")
_C_U16 = _struct.Struct("<H")
_C_U32 = _struct.Struct("<I")
_C_FIX = _struct.Struct("<B16sdd")
_C_SHM = _struct.Struct("<QQ")


def encode_completion_envelope(items) -> "bytes | None":
    """Pack a completion batch; None = an item has a shape the codec
    doesn't know (caller keeps it on the pipe)."""
    parts = [_C_U8.pack(COMPLETION_VERSION), _C_U16.pack(len(items))]
    ap = parts.append
    try:
        for it in items:
            kind = it[0]
            if kind == "done":
                _, tid, entries, (t0, t1) = it
                ap(_C_FIX.pack(0, tid, t0, t1))
                ap(_C_U8.pack(len(entries)))
                for e in entries:
                    if e[0] == "inline":
                        ap(b"\x00")
                        ap(_C_U32.pack(len(e[1])))
                        ap(e[1])
                    elif e[0] == "shm":
                        ap(b"\x01")
                        ap(_C_SHM.pack(e[1], e[2]))
                    else:
                        return None
            elif kind == "err":
                _, tid, blob, tb, (t0, t1) = it
                tbb = tb.encode("utf-8", "replace")
                ap(_C_FIX.pack(1, tid, t0, t1))
                ap(_C_U32.pack(len(blob)))
                ap(blob)
                ap(_C_U32.pack(len(tbb)))
                ap(tbb)
            else:
                return None
    except Exception:
        return None
    return b"".join(parts)


def decode_completion_envelope(data) -> list:
    """Unpack back into the pipe-shaped completion tuples (tags
    restored, so downstream handling is transport-agnostic)."""
    mv = memoryview(data)
    if mv[0] != COMPLETION_VERSION:
        raise ValueError(f"unknown completion-envelope version {mv[0]}")
    n = _C_U16.unpack_from(mv, 1)[0]
    off = 3
    out = []
    for _ in range(n):
        kind, tid, t0, t1 = _C_FIX.unpack_from(mv, off)
        off += 33
        if kind == 0:
            ne = mv[off]
            off += 1
            entries = []
            for _ in range(ne):
                et = mv[off]
                off += 1
                if et == 0:
                    ln = _C_U32.unpack_from(mv, off)[0]
                    off += 4
                    entries.append(("inline", bytes(mv[off:off + ln])))
                    off += ln
                else:
                    o, nb = _C_SHM.unpack_from(mv, off)
                    off += 16
                    entries.append(("shm", o, nb))
            out.append(("done", tid, entries, (t0, t1)))
        else:
            ln = _C_U32.unpack_from(mv, off)[0]
            off += 4
            blob = bytes(mv[off:off + ln])
            off += ln
            ln = _C_U32.unpack_from(mv, off)[0]
            off += 4
            tb = str(mv[off:off + ln], "utf-8")
            off += ln
            out.append(("err", tid, blob, tb, (t0, t1)))
    return out


# the framed serialization of None, precomputed: workers return it for
# no-result tasks by reference and the owner recognizes it by bytes,
# so the dominant fan-out shape never touches a pickler on either side
NONE_FRAMED = serialize(None).to_bytes()
