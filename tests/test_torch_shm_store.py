"""The port's shm object store against the reference's, on the CPU with no
worker processes: the native first-fit allocator and its plain version
(``PyFreeList``) give the reference allocator's offsets exactly; the
control ring and both envelope codecs write the reference's bytes; the
arena's create / seal / pin / spill / restore lifecycle; a tensor read from
the arena is a view of its bytes there, holding the pin while it lives.

Mirrors tests/test_native_allocator.py, tests/test_control_ring.py
(TestControlRing, TestTaskEnvelope, TestCompletionEnvelope) and
tests/test_process_mode.py (TestShmArena, TestSpilling).
"""

import ctypes
import gc
import os

import numpy as np
import pytest
import torch

from ray_tpu._native import NativeFreeList as RefNativeFreeList
from ray_tpu._private.ids import JobID as RefJobID
from ray_tpu._private.ids import ObjectID as RefObjectID
from ray_tpu._private.ids import TaskID as RefTaskID
from ray_tpu._private.runtime import shm_store as ref_shm
from ray_tpu._private import serialization as ref_ser
from ray_tpu._private import task_spec as ref_spec
from ray_tpu_torch import _native
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import task_spec as spec
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_store import ObjectStoreFullError
from ray_tpu_torch._private.runtime import shm_store
from ray_tpu_torch._private.runtime.shm_store import (ControlRing, PyFreeList,
                                                      ShmArena,
                                                      ShmObjectStore)


def _oid(i, job=1):
    """A fixed object id per (job, i): the return of task i."""
    return ObjectID.for_task_return(
        TaskID.of(JobID.from_int(job), unique=bytes(8), seq=i), 0)


def _ref_oid(i, job=1):
    """The reference's id for the same (job, i)."""
    return RefObjectID.for_task_return(
        RefTaskID.of(RefJobID.from_int(job), unique=bytes(8), seq=i), 0)


# ----------------------------------------------------------------------
# allocators: the port's native and plain versions against the reference
# ----------------------------------------------------------------------

def test_native_allocator_builds_into_the_build_dir():
    a = _native.NativeFreeList(1 << 20)
    assert a.free_bytes() == 1 << 20 and a.num_holes() == 1
    so = _native.target("allocator")
    assert so.exists() and so.parent == _native.BUILD_DIR
    assert isinstance(shm_store.make_free_list(4096),
                      _native.NativeFreeList)


@pytest.mark.parametrize("make", [_native.NativeFreeList, PyFreeList],
                         ids=["native", "plain"])
def test_alloc_free_coalesce(make):
    a = make(4096, align=64)
    o1, o2, o3 = a.allocate(100), a.allocate(100), a.allocate(100)
    assert (o1, o2, o3) == (0, 128, 256)
    a.free(o2, 100)
    assert a.num_holes() == 2
    a.free(o1, 100)                 # coalesces with o2's hole
    assert a.num_holes() == 2
    a.free(o3, 100)                 # everything back to one hole
    assert a.num_holes() == 1 and a.free_bytes() == 4096
    b = make(256, align=64)
    assert b.allocate(256) == 0 and b.allocate(1) == -1


@pytest.mark.parametrize("make", [_native.NativeFreeList, PyFreeList],
                         ids=["native", "plain"])
def test_double_free_detected(make):
    a = make(1024, align=64)
    off = a.allocate(128)
    a.free(off, 128)
    with pytest.raises(ValueError, match="double free"):
        a.free(off, 128)
    assert a.free_bytes() == 1024 and a.num_holes() == 1


@pytest.mark.parametrize("seed", range(4))
def test_allocators_match_the_reference_exactly(seed):
    """One seeded alloc/free stream through the port's native allocator,
    its plain version and the reference's native allocator: identical
    offsets (including -1 when full), free bytes and hole counts."""
    size = 1 << 16
    allocs = [_native.NativeFreeList(size, align=64),
              PyFreeList(size, align=64), RefNativeFreeList(size, align=64)]
    rng = np.random.default_rng(seed)
    live = []
    for step in range(1500):
        if live and (rng.random() < 0.45 or len(live) > 200):
            off, n = live.pop(int(rng.integers(len(live))))
            for a in allocs:
                a.free(off, n)
        else:
            n = int(rng.integers(1, 2000))
            got = [a.allocate(n) for a in allocs]
            assert got[0] == got[1] == got[2], (step, n, got)
            if got[0] >= 0:
                live.append((got[0], n))
        assert len({a.free_bytes() for a in allocs}) == 1, step
        assert len({a.num_holes() for a in allocs}) == 1, step


# ----------------------------------------------------------------------
# the control ring and the envelope codecs: the reference's bytes
# ----------------------------------------------------------------------

def _ring_pair(nslots=8, slot_bytes=64):
    """A port ring and a reference ring over fresh arenas, each at the
    arena's first offset."""
    arenas = (ShmArena(1 << 16), ref_shm.ShmArena(1 << 16))
    rb = ControlRing.region_bytes(nslots, slot_bytes)
    assert rb == ref_shm.ControlRing.region_bytes(nslots, slot_bytes)
    rings = (ControlRing(arenas[0], arenas[0].allocate(rb), nslots,
                         slot_bytes, create=True),
             ref_shm.ControlRing(arenas[1], arenas[1].allocate(rb), nslots,
                                 slot_bytes, create=True))
    return arenas, rings, rb


def _close(arenas, rings):
    for r in rings:
        r.close()
    for a in arenas:
        a.close()
        a.unlink()


@pytest.mark.parametrize("seed", range(3))
def test_control_ring_writes_the_reference_bytes(seed):
    """The same seeded puts and gets (wrapping the slots many times,
    filling the ring, refusing oversized messages): every call answers
    as the reference's does and the two regions hold the same bytes."""
    arenas, rings, rb = _ring_pair()
    rng = np.random.default_rng(seed)
    try:
        for _ in range(400):
            if rng.random() < 0.55:
                msg = rng.bytes(int(rng.integers(0, 64)))
                assert rings[0].try_put(msg) == rings[1].try_put(msg)
            else:
                assert rings[0].try_get() == rings[1].try_get()
            assert bytes(arenas[0].view(0, rb)) == \
                bytes(arenas[1].view(0, rb))
        assert rings[0].drain() == rings[1].drain()
    finally:
        _close(arenas, rings)


def test_control_ring_roundtrip_full_and_oversized():
    arenas, (ring, _ref), _rb = _ring_pair(nslots=4, slot_bytes=64)
    try:
        assert ring.max_msg == 56
        msgs = [bytes([i]) * (i + 1) for i in range(4)]
        assert all(ring.try_put(m) for m in msgs)
        assert not ring.try_put(b"x")            # full: consumer behind
        assert ring.try_get() == msgs[0]
        assert ring.try_put(b"a" * 56)           # slot released
        assert not ring.try_put(b"a" * 57)       # never fits a slot
        assert ring.drain() == msgs[1:] + [b"a" * 56]
        assert ring.try_get() is None
    finally:
        _close(arenas, [ring, _ref])


def test_control_ring_create_zeroes_a_recycled_region():
    a = ShmArena(1 << 16)
    try:
        nslots, sb = 8, 64
        rb = ControlRing.region_bytes(nslots, sb)
        off = a.allocate(rb)
        r1 = ControlRing(a, off, nslots, sb, create=True)
        for _ in range(3):
            assert r1.try_put(b"stale")
        r1.close()
        a.free(off, rb)
        r2 = ControlRing(a, a.allocate(rb), nslots, sb, create=True)
        assert r2.try_get() is None
        assert r2.try_put(b"fresh") and r2.try_get() == b"fresh"
        r2.close()
    finally:
        a.close()
        a.unlink()


def _payload(mod, tid, name="f", fn_id=b"F" * 16, fn_blob=b"<fn>",
             num_returns=1, **extra):
    p = {"task_id": tid, "name": name, "fn_id": fn_id, "fn_blob": fn_blob,
         "args_blob": mod.EMPTY_ARGS_BLOB, "num_returns": num_returns,
         "return_ids": [tid + i.to_bytes(4, "big")
                        for i in range(num_returns)],
         "attempt": 0}
    p.update(extra)
    return p


def _envelope_cases(mod):
    """Two envelopes per case, encoded with shared dedupe caches (the
    second one reuses the cached header and the delivered fn blob)."""
    key1, key2 = (b"F" * 16, "f", 1), (b"G" * 16, "g", 2)
    retry = _payload(mod, b"\x07" * 16, num_returns=2, fn_id=b"G" * 16,
                     name="g")
    retry["return_ids"], retry["attempt"] = [b"\xaa" * 20, b"\xbb" * 20], 3
    args = _payload(mod, b"\x05" * 16, timeout_s=1.5)
    args["args_blob"] = b"ARGS"
    return [
        [(key1, [_payload(mod, bytes([i]) * 16) for i in range(3)])],
        [(key1, [_payload(mod, b"\x09" * 16,
                          trace=("a" * 16, "b" * 16, None, True),
                          trace_mark=True), args]),
         (key2, [retry])],
    ]


def test_task_envelope_writes_the_reference_bytes():
    caches = [(set(), {}, {}), (set(), {}, {})]
    hdr_cache = {}
    for groups, ref_groups in zip(_envelope_cases(spec),
                                  _envelope_cases(ref_spec)):
        got = spec.encode_task_envelope(groups, *caches[0])
        want = ref_spec.encode_task_envelope(ref_groups, *caches[1])
        assert got == want
        out = spec.decode_task_envelope(got, hdr_cache)
        assert [p["task_id"] for p in out] == [
            p["task_id"] for _k, ps in groups for p in ps]
    assert caches[0][1] == caches[1][1]          # header ids assigned alike


def test_completion_envelope_writes_the_reference_bytes():
    items = [("done", b"\x01" * 16, [("inline", b"payload")], (1.0, 2.0)),
             ("done", b"\x02" * 16, [("shm", 4096, 512), ("inline", b"x")],
              (2.0, 3.0)),
             ("err", b"\x03" * 16, b"<exc>", "Traceback: boom", (3.0, 4.0))]
    blob = ser.encode_completion_envelope(items)
    assert blob == ref_ser.encode_completion_envelope(items)
    assert ser.decode_completion_envelope(blob) == items
    assert ser.encode_completion_envelope([("weird", 1)]) is None


# ----------------------------------------------------------------------
# the arena: create, seal, pin, zero-copy read, spill, restore
# ----------------------------------------------------------------------

def test_arena_full_raises_and_frees_coalesce():
    a = ShmArena(1 << 12)
    try:
        o1 = a.allocate(3000)
        with pytest.raises(ObjectStoreFullError):
            a.allocate(3000)
        a.free(o1, 3000)
        assert a.free_bytes() == a.size and a._alloc.num_holes() == 1
    finally:
        a.close()
        a.unlink()


def test_create_seal_locate_and_free():
    store = ShmObjectStore(1 << 20)
    try:
        oid = _oid(0)
        off = store.create(oid, 1000)
        assert store.locate(oid) is None          # not sealed yet
        store.seal(oid)
        assert store.locate(oid) == (off, 1000)
        with pytest.raises(ValueError, match="already created"):
            store.create(oid, 10)
        store.free_object(oid)
        assert not store.contains(oid) and store.used_bytes() == 0
    finally:
        store.shutdown()


def _arena_base(store):
    return ctypes.addressof(ctypes.c_char.from_buffer(store.arena._shm.buf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_tensor_read_is_a_view_holding_the_pin(dtype):
    """A tensor read from the arena is a view of its bytes there (not a
    copy); its pin holds while any view of it lives, sub-views included,
    so a freed object's range is not reused under them."""
    store = ShmObjectStore(1 << 20)
    try:
        oid = _oid(0)
        t = torch.arange(4096).to(dtype).reshape(64, 64)
        store.put_serialized(oid, ser.serialize(t))
        released = []
        sobj, pinned = store.get_serialized_for_view(oid)
        assert pinned
        view = ser.deserialize_with_release(
            sobj, lambda: (released.append(oid), store.unpin(oid)))
        base = _arena_base(store)
        nbytes = view.numel() * view.element_size()
        assert base <= view.data_ptr() and \
            view.data_ptr() + nbytes <= base + store.arena.size
        assert view.dtype == dtype and torch.equal(view, t)
        sub = view[10:20]
        del view
        gc.collect()
        assert not released                       # the sub-view holds it
        store.free_object(oid)                    # deferred: still pinned
        for i in range(8):
            store.put_serialized(_oid(i + 1), ser.serialize(
                torch.full((64, 64), -1).to(dtype)))
        assert torch.equal(sub, t[10:20])         # bytes not reused
        del sub
        gc.collect()
        assert released == [oid] and not store._pins
    finally:
        store.shutdown()


def test_inline_bytes_come_back_as_a_writable_copy():
    """Bytes that do not lie in the arena (inline blobs are read-only
    bytes) come back as a tensor of their own."""
    t = torch.arange(16, dtype=torch.float32)
    back = ser.deserialize(ser.SerializedObject.from_bytes(
        ser.serialize(t).to_bytes()))
    assert torch.equal(back, t)
    back += 1                                     # writable
    assert torch.equal(back, t + 1)


def test_eviction_spills_and_restores():
    store = ShmObjectStore(1 << 20)
    try:
        oids, values = [], []
        for i in range(4):                        # ~320 KB each, never read
            oid = _oid(i, job=3)
            v = torch.full((40_000,), float(i), dtype=torch.float64)
            store.put_serialized(oid, ser.serialize({"a": v}))
            oids.append(oid)
            values.append(v)
        assert store.num_spilled_objects() >= 1
        for oid, v in zip(oids, values):
            back = ser.deserialize(store.get_serialized(oid))
            assert torch.equal(back["a"], v)
        assert store.num_restored >= 1
        spilled = next(iter(store._spilled))
        path = store._spilled[spilled][0]
        assert os.path.exists(path)
        store.free_object(spilled)
        assert not os.path.exists(path)
    finally:
        store.shutdown()


def test_accessed_objects_never_evicted():
    store = ShmObjectStore(1 << 20)
    try:
        oid1 = _oid(0, job=4)
        v = torch.arange(40_000, dtype=torch.float64)
        store.put_serialized(oid1, ser.serialize({"a": v}))
        view = ser.deserialize(store.get_serialized(oid1))
        for i in range(1, 5):
            store.put_serialized(_oid(i, job=4), ser.serialize(
                {"a": torch.zeros(40_000, dtype=torch.float64)}))
        assert store.locate(oid1) is not None
        assert torch.equal(view["a"], v)
        del view
    finally:
        store.shutdown()


@pytest.mark.parametrize("seed", range(2))
def test_store_places_objects_as_the_reference_does(seed):
    """The same seeded puts and frees of numpy arrays (out-of-band
    buffers of equal framing in both packages) through both stores: the
    same offsets, the same objects spilled, equal values back."""
    cap = 1 << 20
    mine, ref = ShmObjectStore(cap), ref_shm.ShmObjectStore(cap)
    rng = np.random.default_rng(seed)
    try:
        live = []
        for i in range(40):
            if live and rng.random() < 0.3:
                j, _v = live.pop(int(rng.integers(len(live))))
                mine.free_object(_oid(j, job=5))
                ref.free_object(_ref_oid(j, job=5))
                continue
            v = rng.standard_normal(int(rng.integers(1_000, 60_000)))
            a = mine.put_serialized(_oid(i, job=5), ser.serialize(v))
            b = ref.put_serialized(_ref_oid(i, job=5), ref_ser.serialize(v))
            assert a == b, i
            live.append((i, v))
        assert mine.num_spilled_objects() == ref.num_spilled_objects()
        for j, v in live:
            back = ser.deserialize(mine.get_serialized(_oid(j, job=5)))
            np.testing.assert_array_equal(back, v)
    finally:
        mine.shutdown()
        ref.shutdown()
