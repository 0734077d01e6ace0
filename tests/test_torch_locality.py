"""The port's locality-aware scheduling: the cases of
``tests/test_locality.py`` on ``ray_tpu_torch``, and parity with the
reference on the same seeded inputs (bounds: equal, exactly):

- ``kernels.assign_np`` with a locality matrix, on this file's cases and
  on 200 seeded random batches: node choices and avail;
- ``TensorScheduler._locality_matrix_locked`` on the same arg sizes and
  copy locations;
- the event scheduler's preferred node (``_preferred_node_locked``).

Also the port's rule for the device path: a tick whose batch carries a
locality matrix runs ``assign_np`` on the host (``kernels.assign`` has
no locality column, nor has the reference's device kernel), decided
before the tick and counted in ``locality_host_assigns``; a device error
never leads to a host assign.

Object and task rows come from ``util.state``, as in the reference. Its
bench guard's check
of ``bench.py`` is left out (the port has no bench script yet); the
locality A/B it guards runs through ``perf.locality_ab``. Workers
unpickle this module's functions by value (registered below).

Locality-aware scheduling: multi-copy object directory, arg-resident
node scoring, dispatch-time staging, and the peer chunk protocol edges.

Reference pattern: the raylet's hybrid scheduling policy consults the
object directory for task-argument locality (ray: src/ray/raylet/
scheduling/policy/hybrid_scheduling_policy.cc) and the object manager
registers secondary copies as pulls complete. Here the directory lives
in the head's GcsService, the scoring is a pre-pass in the assignment
kernel, and staging ships known locations with the lease so the target
daemon's pull manager overlaps transfers with queue wait.
"""

import sys
import threading
import time
import types

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.gcs import GcsService
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.scheduler import kernels
from ray_tpu_torch._private.scheduler.local import EventScheduler, NodeState
from ray_tpu_torch.cluster_utils import Cluster

cloudpickle.register_pickle_by_value(sys.modules[__name__])

SYSTEM = {"sched_device": "cpu"}


def wait_for(cond, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def cluster():
    ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True,
                head_node_args=dict(num_cpus=2, num_workers=2,
                                    scheduler="tensor",
                                    _system_config=dict(SYSTEM)))
    yield c
    c.shutdown()


BIG = 512 * 1024  # > inline_object_max_bytes: forces the arena path


# ======================================================================
# GCS multi-location object directory
# ======================================================================

class TestObjectDirectory:
    def _gcs(self):
        return GcsService(worker=None)

    def test_primary_add_get_pop(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        assert gcs.object_location_get(oid) is None
        assert gcs.object_locations(oid) == []
        gcs.object_location_add(oid, 2)
        assert gcs.object_location_get(oid) == 2
        assert gcs.object_locations(oid) == [2]
        assert gcs.object_location_pop(oid) == 2
        assert gcs.object_locations(oid) == []

    def test_secondary_registers_only_when_tracked(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        # untracked oid: the primary was freed, the copy is moot
        gcs.object_location_add_secondary(oid, 1)
        assert gcs.object_locations(oid) == []
        gcs.object_location_add(oid, 1)
        gcs.object_location_add_secondary(oid, 3)
        gcs.object_location_add_secondary(oid, 3)  # duplicate: no-op
        assert gcs.object_locations(oid) == [1, 3]
        assert gcs.object_location_get(oid) == 1  # primary unchanged

    def test_primary_add_moves_existing_secondary_to_front(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        gcs.object_location_add(oid, 1)
        gcs.object_location_add_secondary(oid, 2)
        gcs.object_location_add(oid, 2)  # secondary becomes primary
        assert gcs.object_locations(oid) == [2, 1]

    def test_locations_pop_returns_every_copy(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        gcs.object_location_add(oid, 0)
        gcs.object_location_add_secondary(oid, 4)
        assert gcs.object_locations_pop(oid) == [0, 4]
        assert gcs.object_locations(oid) == []

    def test_objects_on_node_is_primary_only(self):
        gcs = self._gcs()
        a, b = ObjectID.from_random(), ObjectID.from_random()
        gcs.object_location_add(a, 1)
        gcs.object_location_add(b, 2)
        gcs.object_location_add_secondary(b, 1)
        assert gcs.objects_on_node(1) == [a]

    def test_drop_node_promotes_surviving_secondary(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        gcs.object_location_add(oid, 1)
        gcs.object_location_add_secondary(oid, 2)
        lost, promoted = gcs.drop_node_locations(1)
        assert lost == []
        assert promoted == {oid: 2}
        assert gcs.object_locations(oid) == [2]

    def test_drop_node_loses_sole_copy(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        gcs.object_location_add(oid, 1)
        lost, promoted = gcs.drop_node_locations(1)
        assert lost == [oid]
        assert promoted == {}
        assert gcs.object_locations(oid) == []

    def test_drop_node_secondary_death_keeps_primary(self):
        gcs = self._gcs()
        oid = ObjectID.from_random()
        gcs.object_location_add(oid, 1)
        gcs.object_location_add_secondary(oid, 2)
        lost, promoted = gcs.drop_node_locations(2)
        assert lost == [] and promoted == {}
        assert gcs.object_locations(oid) == [1]


# ======================================================================
# assignment-kernel locality pre-pass
# ======================================================================

class TestAssignKernelLocality:
    def _cluster(self, n_nodes=3, cpus=4.0):
        avail = np.full((n_nodes, 1), cpus)
        return avail, avail.copy()

    def test_none_locality_is_byte_for_byte_default(self):
        avail, cap = self._cluster()
        cls = np.zeros(6, dtype=np.int32)
        demands = np.array([[1.0]])
        ready = np.arange(6)
        base_out, base_av = kernels.assign_np(
            ready, cls, demands, avail.copy(), cap, 0.5)
        out, av = kernels.assign_np(
            ready, cls, demands, avail.copy(), cap, 0.5,
            locality=None, outstanding=None, spill_depth=7)
        assert np.array_equal(base_out, out)
        assert np.array_equal(base_av, av)

    def test_prefers_node_with_most_resident_bytes(self):
        avail, cap = self._cluster()
        cls = np.zeros(2, dtype=np.int32)
        demands = np.array([[1.0]])
        loc = np.array([[0.0, 100.0, 900.0],
                        [0.0, 100.0, 900.0]])
        out, av = kernels.assign_np(
            np.arange(2), cls, demands, avail, cap, 0.5, locality=loc)
        assert list(out) == [2, 2]
        assert av[2, 0] == 2.0  # both leases debited from node 2

    def test_bounded_wait_when_preferred_node_full(self):
        avail, cap = self._cluster()
        avail[2] = 0.0  # node 2 momentarily full, capacity intact
        loc = np.array([[0.0, 0.0, 500.0]] * 2)
        out, av = kernels.assign_np(
            np.arange(2), np.zeros(2, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, locality=loc,
            outstanding=np.zeros(3, np.int64), spill_depth=4)
        assert list(out) == [-1, -1]  # waiting for the data-resident node
        assert (av == avail).all()

    def test_partial_fit_assigns_then_waits(self):
        avail, cap = self._cluster()
        avail[2] = 1.0  # room for exactly one lease
        loc = np.array([[0.0, 0.0, 500.0]] * 2)
        out, _ = kernels.assign_np(
            np.arange(2), np.zeros(2, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, locality=loc,
            outstanding=np.zeros(3, np.int64), spill_depth=4)
        assert list(out) == [2, -1]

    def test_spillback_past_queue_depth(self):
        avail, cap = self._cluster()
        avail[2] = 0.0
        loc = np.array([[0.0, 0.0, 500.0]] * 2)
        out, _ = kernels.assign_np(
            np.arange(2), np.zeros(2, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, locality=loc,
            outstanding=np.array([0, 0, 4], np.int64), spill_depth=4)
        assert (out >= 0).all()
        assert (out != 2).all()  # spilled to the normal fill

    def test_spread_overrides_locality(self):
        avail, cap = self._cluster()
        loc = np.array([[0.0, 0.0, 500.0]] * 3)
        out, _ = kernels.assign_np(
            np.arange(3), np.zeros(3, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, class_spread=np.array([True]), locality=loc)
        assert sorted(out) == [0, 1, 2]  # round-robin, not all on node 2

    def test_placement_mask_overrides_locality(self):
        avail, cap = self._cluster()
        mask = np.array([[True, True, False]])
        loc = np.array([[0.0, 0.0, 500.0]] * 2)
        out, _ = kernels.assign_np(
            np.arange(2), np.zeros(2, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, class_mask=mask, locality=loc)
        assert (out >= 0).all()
        assert (out != 2).all()

    def test_capacity_infeasible_preference_spills_immediately(self):
        avail, cap = self._cluster()
        avail[2] = cap[2] = 0.5  # alive, but a 1-cpu lease can never fit
        loc = np.array([[0.0, 0.0, 500.0]] * 2)
        out, _ = kernels.assign_np(
            np.arange(2), np.zeros(2, np.int32), np.array([[1.0]]),
            avail, cap, 0.5, locality=loc,
            outstanding=np.zeros(3, np.int64), spill_depth=4)
        assert (out >= 0).all()
        assert (out != 2).all()


# ======================================================================
# EventScheduler locality preference (the semantics oracle)
# ======================================================================

class TestEventSchedulerLocality:
    def _sched(self, n_nodes=2, cpus=4.0):
        nodes = [NodeState((cpus,)) for _ in range(n_nodes)]
        return EventScheduler(nodes, dispatcher=lambda t: None)

    def test_preferred_node_by_resident_bytes(self):
        sched = self._sched()
        a, b = ObjectID.from_random(), ObjectID.from_random()
        locs = {a: [1], b: [0, 1]}
        sched.locations_of = lambda oid: locs.get(oid, [])
        # node 1 holds a (100) + b copy (300) = 400; node 0 holds 300
        assert sched._preferred_node_locked(((a, 100), (b, 300))) == 1
        # unknown-size copies still attract (weigh 1 byte)
        assert sched._preferred_node_locked(((a, 0),)) == 1
        # nothing located anywhere -> no preference
        c = ObjectID.from_random()
        assert sched._preferred_node_locked(((c, 50),)) is None

    def test_preferred_node_tie_breaks_low(self):
        sched = self._sched()
        a = ObjectID.from_random()
        sched.locations_of = lambda oid: [1, 0]
        assert sched._preferred_node_locked(((a, 100),)) == 0

    def test_pick_node_honors_preference(self):
        sched = self._sched()
        # without preference the least-loaded tie breaks to node 0
        assert sched._pick_node((1.0,), 0.0) == 0
        assert sched._pick_node((1.0,), 0.0, prefer=1, spill_depth=4) == 1

    def test_pick_node_bounded_wait_then_spill(self):
        sched = self._sched()
        sched._nodes[1].allocate((4.0,))  # node 1 full
        # under the spillback depth: wait for the data-resident node
        assert sched._pick_node((1.0,), 0.0, prefer=1,
                                spill_depth=4) is None
        # at/over the depth: spill back to the normal fill
        sched._outstanding[1] = 4
        assert sched._pick_node((1.0,), 0.0, prefer=1, spill_depth=4) == 0

    def test_pick_node_infeasible_preference_falls_through(self):
        sched = self._sched()
        # a demand node 1 can never hold ignores the preference entirely
        sched._nodes[1].capacity = [0.5]
        sched._nodes[1].available = [0.5]
        assert sched._pick_node((1.0,), 0.0, prefer=1, spill_depth=4) == 0


# ======================================================================
# peer chunk protocol: short reads, timeouts, mid-stream failure
# ======================================================================

class _FrameConn:
    """A fake multiprocessing connection delivering scripted frames."""

    def __init__(self, frames, poll_ok=True):
        self._frames = list(frames)
        self._poll_ok = poll_ok

    def poll(self, timeout):
        return self._poll_ok and bool(self._frames)

    def recv_bytes(self, maxlength=None):
        return self._frames.pop(0)

    def recv_bytes_into(self, view):
        chunk = self._frames.pop(0)
        view[:len(chunk)] = chunk
        return len(chunk)


class TestPeerChunkProtocol:
    def test_timeout_raises(self):
        from ray_tpu_torch._private.runtime.node_daemon import _drain_frames
        buf = bytearray(16)
        with pytest.raises(OSError, match="peer chunk timed out"):
            _drain_frames(_FrameConn([], poll_ok=False), 16, 0.01,
                          sink_view=memoryview(buf))

    def test_short_first_frame_raises(self):
        from ray_tpu_torch._private.runtime.node_daemon import _drain_frames
        buf = bytearray(10)
        with pytest.raises(OSError, match="short peer chunk: 3 != 10"):
            _drain_frames(_FrameConn([b"abc"]), 10, 1.0,
                          sink_view=memoryview(buf))

    def test_short_mid_stream_frame_raises_at_offset(self):
        from ray_tpu_torch._private.runtime.node_daemon import (PEER_CHUNK,
                                                          _drain_frames)
        total = PEER_CHUNK + 10
        buf = bytearray(total)
        conn = _FrameConn([bytes(PEER_CHUNK), b"xy"])
        with pytest.raises(OSError,
                           match=f"short peer chunk: 2 != 10 at {PEER_CHUNK}"):
            _drain_frames(conn, total, 1.0, sink_view=memoryview(buf))

    def test_sink_write_mode_checks_frames_too(self):
        from ray_tpu_torch._private.runtime.node_daemon import _drain_frames
        got = []
        with pytest.raises(OSError, match="short peer chunk"):
            _drain_frames(_FrameConn([b"ab"]), 8, 1.0, sink_write=got.append)
        assert got == [b"ab"]  # the bad frame was seen, then rejected

    def test_mid_stream_failure_aborts_adopt_then_retry_succeeds(self):
        """A pull that dies mid-stream must leave no trace in the store
        (abort_adopt), and a later complete pull of the same oid must
        land cleanly in the slot the failed one released."""
        from ray_tpu_torch._private.runtime.node_daemon import (
            PEER_CHUNK, recv_object_into_store)
        from ray_tpu_torch._private.runtime.shm_store import ShmObjectStore

        store = ShmObjectStore(4 * 1024 * 1024)
        try:
            oid = ObjectID.from_random()
            total = PEER_CHUNK + 100
            payload = bytes(range(256)) * (total // 256) + b"\0" * (total % 256)
            bad = _FrameConn([payload[:PEER_CHUNK], b"zz"])
            with pytest.raises(OSError, match="short peer chunk"):
                recv_object_into_store(bad, store, oid, total, 1.0)
            assert not store.contains(oid)
            good = _FrameConn([payload[:PEER_CHUNK], payload[PEER_CHUNK:]])
            assert recv_object_into_store(good, store, oid, total, 1.0)
            assert store.contains(oid)
            assert store.locate(oid)[1] == total
        finally:
            store.shutdown()


# ======================================================================
# PullManager staging: prefetch coalescing + pulled reporting
# ======================================================================

class TestPullManagerStaging:
    def test_prefetch_coalesces_and_reports(self):
        from ray_tpu_torch._private.runtime.node_daemon import PullManager

        calls = []
        started = threading.Event()
        release = threading.Event()
        pulled = []

        def transfer(address, oid_bin):
            calls.append((address, oid_bin))
            started.set()
            release.wait(10)
            return True

        pm = PullManager(transfer, num_threads=1, on_pulled=pulled.append)
        try:
            pm.prefetch(("h", 1), b"x" * 20, PullManager.PRIO_ARG)
            assert started.wait(10)
            # a second prefetch of the in-flight object is a no-op
            pm.prefetch(("h", 1), b"x" * 20, PullManager.PRIO_ARG)
            # a blocking pull joins the staged transfer's waiters
            res = []
            t = threading.Thread(
                target=lambda: res.append(
                    pm.pull(("h", 1), b"x" * 20, PullManager.PRIO_GET)))
            t.start()
            time.sleep(0.05)
            release.set()
            t.join(10)
            assert res == [True]
            assert len(calls) == 1  # one transfer served all three
            assert pulled == [b"x" * 20]
        finally:
            release.set()
            pm.stop()

    def test_on_pulled_not_fired_on_failure(self):
        from ray_tpu_torch._private.runtime.node_daemon import PullManager

        pulled = []
        pm = PullManager(lambda a, o: False, num_threads=1,
                         on_pulled=pulled.append)
        try:
            assert pm.pull(("h", 1), b"y" * 20, PullManager.PRIO_GET) is False
            assert pulled == []
        finally:
            pm.stop()


# ======================================================================
# staging + directory integration over real node daemons
# ======================================================================

def _produce_consume(cluster):
    """2 remote nodes; a big object produced on node 1, consumed on
    node 2 so dispatch stages a copy there. Returns (worker, oid, ref,
    src_node, dst_node, expected_sum)."""
    n1 = cluster.add_node(num_cpus=2, remote=True, resources={"a": 10.0})
    n2 = cluster.add_node(num_cpus=2, remote=True, resources={"b": 10.0})
    cluster.wait_for_nodes()
    w = worker_mod.get_worker()

    @ray_tpu_torch.remote(resources={"a": 1.0})
    def produce():
        return np.arange(BIG // 8, dtype=np.float64)

    @ray_tpu_torch.remote(resources={"b": 1.0})
    def consume(x):
        return float(x.sum())

    ref = produce.remote()
    ray_tpu_torch.wait([ref], timeout=60.0)
    oid = ref.object_id()
    assert w.gcs.object_locations(oid) == [n1.index]
    expected = float(np.arange(BIG // 8, dtype=np.float64).sum())
    got = ray_tpu_torch.get(consume.remote(ref), timeout=60.0)
    assert got == expected
    # the staged (or exec-time) pull reports the new copy asynchronously
    assert wait_for(lambda: len(w.gcs.object_locations(oid)) == 2,
                    timeout=30.0), w.gcs.object_locations(oid)
    assert w.gcs.object_locations(oid) == [n1.index, n2.index]
    return w, oid, ref, n1, n2, expected


class TestStagingIntegration:
    def test_staging_registers_secondary_and_promotes_on_death(self, cluster):
        w, oid, ref, n1, n2, expected = _produce_consume(cluster)
        ts = w.transfer_stats
        assert ts["locality_misses"] >= 1  # arg was remote at dispatch
        assert ts["bytes_pulled"] > 0

        # state API surfaces the multi-location rows, primary first
        from ray_tpu_torch.util import state
        rows = {r["object_id"]: r
                for r in state.list_objects(locations=True)}
        assert rows[oid.hex()]["locations"] == [n1.index, n2.index]

        # the consume attempt carries the staged transition
        staged = [r for r in state.list_tasks(detail=True, state="FINISHED")
                  if r["name"].endswith("consume") and r.get("staged_at")]
        assert staged, "no finished task recorded a staged_at timestamp"

        # primary node dies -> the staged secondary is promoted and the
        # object survives WITHOUT lineage reconstruction
        cluster.remove_node(n1)
        assert wait_for(
            lambda: w.gcs.object_locations(oid) == [n2.index], timeout=30.0)
        assert ray_tpu_torch.get(ref, timeout=60.0).sum() == expected

    def test_secondary_invalidated_when_its_node_dies(self, cluster):
        w, oid, ref, n1, n2, expected = _produce_consume(cluster)
        cluster.remove_node(n2)
        assert wait_for(
            lambda: w.gcs.object_locations(oid) == [n1.index], timeout=30.0)
        assert ray_tpu_torch.get(ref, timeout=60.0).sum() == expected


# ======================================================================
# bench guard: the locality A/B must exist and actually pay off
# ======================================================================

class TestLocalityBenchGuard:
    def test_ab_moves_fewer_bytes_with_equal_results(self):
        """The acceptance A/B at smoke size: locality-on must move at
        most half the cross-node bytes of locality-off on a 2-node
        large-arg fanout, with byte-identical task results."""
        from ray_tpu_torch._private import perf

        on = perf.locality_ab(True, n_consumers=2, arg_mb=0.25,
                              system_config=SYSTEM)
        off = perf.locality_ab(False, n_consumers=2, arg_mb=0.25,
                               system_config=SYSTEM)
        assert on["sum"] == off["sum"]  # equal task results
        assert off["bytes_pulled"] > 0  # the off arm really crossed nodes
        assert on["bytes_pulled"] * 2 <= off["bytes_pulled"]
        assert on["bytes_saved"] > 0
        assert on["hits"] >= 1

    def test_small_arg_lane_not_slower(self):
        """Locality-on must not slow the no-op lane: without remote
        nodes no arg sizes are stamped, so the hot path is identical and
        only scheduler-tick noise separates the arms (generous bound)."""

        def rate(locality):
            ray_tpu_torch.shutdown()
            ray_tpu_torch.init(num_cpus=4,
                         _system_config={**SYSTEM,
                                         "scheduler_locality": locality})

            @ray_tpu_torch.remote
            def nop(i):
                return i

            ray_tpu_torch.get([nop.remote(i) for i in range(50)])  # warm up
            best = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                ray_tpu_torch.get([nop.remote(i) for i in range(200)],
                            timeout=60.0)
                best = max(best, 200.0 / (time.perf_counter() - t0))
            ray_tpu_torch.shutdown()
            return best

        # the arms in turns (on, off, on, off, ...), each arm's best
        # taken over all its turns: a burst of load from other processes
        # then falls on both arms instead of on whichever ran second
        on = off = 0.0
        for _ in range(3):
            on, off = max(on, rate(True)), max(off, rate(False))
        assert on >= off * 0.6, (on, off)


# ======================================================================
# parity with the reference on the same seeded inputs
# ======================================================================

def _ref_kernels():
    from ray_tpu._private.scheduler import kernels as ref
    return ref


def _assign_both(*args, **kwargs):
    """assign_np of both packages on copies of the same inputs."""
    def fresh():
        return ([a.copy() if isinstance(a, np.ndarray) else a
                 for a in args],
                {k: v.copy() if isinstance(v, np.ndarray) else v
                 for k, v in kwargs.items()})

    a, k = fresh()
    port = kernels.assign_np(*a, **k)
    a, k = fresh()
    ref = _ref_kernels().assign_np(*a, **k)
    return port, ref


def _assert_same(port, ref):
    assert np.array_equal(np.asarray(port[0]), np.asarray(ref[0]))
    assert np.array_equal(np.asarray(port[1]), np.asarray(ref[1]))


class TestLocalityParity:
    CASES = {
        "no_locality": dict(n=6, loc=None),
        "most_bytes": dict(n=2, loc=[[0.0, 100.0, 900.0]] * 2),
        "bounded_wait": dict(n=2, loc=[[0.0, 0.0, 500.0]] * 2,
                             full=2, outstanding=[0, 0, 0], depth=4),
        "partial_fit": dict(n=2, loc=[[0.0, 0.0, 500.0]] * 2,
                            one_slot=2, outstanding=[0, 0, 0], depth=4),
        "spillback": dict(n=2, loc=[[0.0, 0.0, 500.0]] * 2, full=2,
                          outstanding=[0, 0, 4], depth=4),
        "spread": dict(n=3, loc=[[0.0, 0.0, 500.0]] * 3, spread=True),
        "mask": dict(n=2, loc=[[0.0, 0.0, 500.0]] * 2,
                     mask=[[True, True, False]]),
        "infeasible": dict(n=2, loc=[[0.0, 0.0, 500.0]] * 2, tiny=2,
                           outstanding=[0, 0, 0], depth=4),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_kernel_cases_match_reference(self, case):
        c = self.CASES[case]
        avail = np.full((3, 1), 4.0)
        cap = avail.copy()
        if "full" in c:
            avail[c["full"]] = 0.0
        if "one_slot" in c:
            avail[c["one_slot"]] = 1.0
        if "tiny" in c:
            avail[c["tiny"]] = cap[c["tiny"]] = 0.5
        kw = {}
        if c["loc"] is not None:
            kw["locality"] = np.asarray(c["loc"])
        if "outstanding" in c:
            kw["outstanding"] = np.asarray(c["outstanding"], np.int64)
            kw["spill_depth"] = c["depth"]
        if c.get("spread"):
            kw["class_spread"] = np.array([True])
        if "mask" in c:
            kw["class_mask"] = np.asarray(c["mask"])
        n = c["n"]
        port, ref = _assign_both(np.arange(n), np.zeros(n, np.int32),
                                 np.array([[1.0]]), avail, cap, 0.5, **kw)
        _assert_same(port, ref)

    @pytest.mark.parametrize("block", range(4))
    def test_random_batches_match_reference(self, block):
        """200 seeded batches (50 a block): several classes with masks
        and SPREAD flags, a sparse locality matrix, outstanding counts
        around the spillback depth; node choices and avail equal."""
        for seed in range(block * 50, block * 50 + 50):
            rng = np.random.default_rng(seed)
            k = int(rng.integers(1, 40))
            K = int(rng.integers(1, 5))
            N = int(rng.integers(2, 7))
            R = 2
            demands = np.zeros((K, R))
            demands[:, 0] = rng.choice([0.5, 1.0, 2.0], K)
            demands[:, 1] = rng.choice([0.0, 0.0, 1.0], K)
            cap = np.zeros((N, R))
            cap[:, 0] = rng.integers(0, 8, N)
            cap[:, 1] = rng.integers(0, 3, N)
            avail = np.maximum(cap - rng.integers(0, 4, (N, R)), 0.0)
            ready = np.sort(rng.choice(4 * k, size=k, replace=False))
            cls = np.zeros(int(ready.max()) + 1, np.int32)
            cls[ready] = rng.integers(0, K, k)
            mask = rng.random((K, N)) < 0.8
            spread = rng.random(K) < 0.2
            loc = np.where(rng.random((k, N)) < 0.3,
                           rng.integers(0, 5000, (k, N)), 0).astype(
                               np.float64)
            outstanding = rng.integers(0, 6, N).astype(np.int64)
            depth = int(rng.integers(0, 6))
            port, ref = _assign_both(
                ready, cls, demands, avail, cap, 0.5, mask, spread,
                locality=loc, outstanding=outstanding, spill_depth=depth)
            _assert_same(port, ref)

    @pytest.mark.parametrize("seed", range(4))
    def test_locality_matrix_matches_reference(self, seed):
        """_locality_matrix_locked of both packages' TensorScheduler on
        the same per-slot arg sizes and copy locations (rows out of the
        node range, unknown sizes and slots without args included)."""
        from ray_tpu._private.scheduler.tensor import \
            TensorScheduler as RefTS
        from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

        rng = np.random.default_rng(seed)
        n_nodes = int(rng.integers(2, 6))
        oids = [ObjectID.from_random() for _ in range(12)]
        locs = {o: [int(x) for x in rng.choice(n_nodes + 2,
                                               size=int(rng.integers(0, 3)),
                                               replace=False)]
                for o in oids}
        argsz = {}
        for slot in range(20):
            if rng.random() < 0.6:
                picks = rng.choice(len(oids), size=int(rng.integers(1, 4)),
                                   replace=False)
                argsz[slot] = tuple((oids[i], int(rng.integers(0, 1 << 20)))
                                    for i in picks)
        ready = np.sort(rng.choice(20, size=int(rng.integers(1, 20)),
                                   replace=False))
        state = types.SimpleNamespace(
            _argsz=argsz, locations_of=lambda o: locs.get(o, []),
            _node_states=[None] * n_nodes)
        want = RefTS._locality_matrix_locked(state, ready)
        got = TensorScheduler._locality_matrix_locked(state, ready)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)

    @pytest.mark.parametrize("seed", range(4))
    def test_preferred_node_matches_reference(self, seed):
        from ray_tpu._private.scheduler.local import \
            EventScheduler as RefEvent
        from ray_tpu._private.scheduler.local import NodeState as RefNode

        rng = np.random.default_rng(100 + seed)
        n_nodes = int(rng.integers(2, 6))
        port = EventScheduler([NodeState((4.0,)) for _ in range(n_nodes)],
                              dispatcher=lambda t: None)
        ref = RefEvent([RefNode((4.0,)) for _ in range(n_nodes)],
                       dispatcher=lambda t: None)
        oids = [ObjectID.from_random() for _ in range(10)]
        locs = {o: [int(x) for x in rng.choice(n_nodes,
                                               size=int(rng.integers(0, 3)),
                                               replace=False)]
                for o in oids}
        port.locations_of = ref.locations_of = lambda o: locs.get(o, [])
        for _ in range(50):
            picks = rng.choice(len(oids), size=int(rng.integers(1, 4)),
                               replace=False)
            sizes = tuple((oids[i], int(rng.choice([0, 1, 100, 4096])))
                          for i in picks)
            assert port._preferred_node_locked(sizes) \
                == ref._preferred_node_locked(sizes)


# ======================================================================
# the device path and the locality column
# ======================================================================

class _CountingAssign:
    """Stands in for kernels.assign: counts calls, then runs the plain
    version (or raises)."""

    def __init__(self, raise_error=False):
        self.calls = 0
        self.raise_error = raise_error
        self._real = kernels.assign

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.raise_error:
            raise RuntimeError("device assign broke")
        return self._real(*args, **kwargs)


def _locality_snapshot(with_locality):
    """A 4-task batch on 3 nodes, one class; with a locality matrix
    pointing at node 2 or none."""
    cap = np.zeros((3, 4), dtype=np.float32)
    cap[:, 0] = 4.0
    loc = np.zeros((4, 3))
    loc[:, 2] = 1000.0
    return (np.arange(4), np.zeros(4, np.int32),
            np.array([[1.0, 0, 0, 0]], dtype=np.float32), cap.copy(), cap,
            np.ones((1, 3), bool), np.zeros(1, bool),
            loc if with_locality else None,
            np.zeros(3, np.int64) if with_locality else None, None)


class TestDeviceAssignAndLocality:
    @pytest.fixture
    def sched(self, monkeypatch):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

        GLOBAL_CONFIG.set("sched_backend", "cuda")
        GLOBAL_CONFIG.set("sched_device", "cpu")
        s = TensorScheduler([NodeState((4.0, 0, 1e18, 0))] * 3,
                            lambda t: None)
        yield s
        s.shutdown()
        GLOBAL_CONFIG.reset()

    def test_locality_tick_runs_on_host_and_is_counted(self, sched,
                                                       monkeypatch):
        stub = _CountingAssign()
        monkeypatch.setattr(kernels, "assign", stub)
        _, node_of, _ = sched._assign(_locality_snapshot(True))
        assert stub.calls == 0
        assert list(node_of) == [2, 2, 2, 2]  # the data-resident node
        st = sched.stats()
        assert st["locality_host_assigns"] == 1
        assert st["device_assigns"] == 0
        _, node_of, _ = sched._assign(_locality_snapshot(False))
        assert stub.calls == 1
        st = sched.stats()
        assert st["device_assigns"] == 1
        assert st["locality_host_assigns"] == 1

    def test_device_error_never_falls_back_to_the_host(self, sched,
                                                       monkeypatch):
        stub = _CountingAssign(raise_error=True)
        monkeypatch.setattr(kernels, "assign", stub)
        with pytest.raises(RuntimeError, match="device assign broke"):
            sched._assign(_locality_snapshot(False))
        st = sched.stats()
        assert st["device_assign_errors"] == 1
        assert st["locality_host_assigns"] == 0

    def test_remote_cluster_counts_its_locality_ticks(self, monkeypatch):
        """End to end on two remote nodes under sched_backend "cuda": a
        consumer of an object resident on a remote node makes a tick with
        a locality matrix; every such tick ran assign_np (counted), and
        every other tick the device path."""
        from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

        seen = []
        orig = TensorScheduler._assign

        def _assign(sched, snapshot):
            seen.append(snapshot[7] is not None)
            return orig(sched, snapshot)

        monkeypatch.setattr(TensorScheduler, "_assign", _assign)
        ray_tpu_torch.shutdown()
        c = Cluster(initialize_head=True,
                    head_node_args=dict(num_cpus=2, num_workers=2,
                                        scheduler="tensor",
                                        _system_config={
                                            **SYSTEM,
                                            "sched_backend": "cuda"}))
        try:
            c.add_node(num_cpus=2, remote=True, resources={"a": 4.0})
            c.add_node(num_cpus=2, remote=True, resources={"a": 4.0,
                                                           "src": 4.0})
            c.wait_for_nodes()
            w = worker_mod.get_worker()

            @ray_tpu_torch.remote(resources={"src": 1.0})
            def produce():
                return np.ones(BIG // 8)

            @ray_tpu_torch.remote(resources={"a": 1.0})
            def consume(x):
                return float(x.sum())

            ref = produce.remote()
            ray_tpu_torch.wait([ref], timeout=60.0)
            assert ray_tpu_torch.get(consume.remote(ref),
                                     timeout=60.0) == BIG // 8
            st = w.scheduler.stats()
            assert st["locality_host_assigns"] == sum(seen) >= 1
            assert st["device_assigns"] == len(seen) - sum(seen)
            assert st["device_assign_errors"] == 0
        finally:
            c.shutdown()
