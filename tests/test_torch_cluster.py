"""The port's local virtual cluster (``ray_tpu_torch.cluster_utils``) and
autoscaler (``ray_tpu_torch.autoscaler``) on the CPU: the cases of
``tests/test_cluster.py`` and ``tests/test_ops_layer.py::TestAutoscaler``
run on the port, with the same ``slow`` marks, plus fast cases of node
death (``remove_node`` mid-run with every assignment around it held
against ``assign_np``, ``kill_worker_processes``), the autoscaler's
upscale and downscale, a gang scale-up that never shows a partial
placement group, and the scheduler's node table as it grows and shrinks.

The head runs the TensorScheduler with its device path on the host
(``sched_device`` "cpu"); each added node is a pool of exec'd worker
processes. Workers unpickle this module's functions by value (registered
below) and must never load jax, flax or ray_tpu.
"""

import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.cluster_utils import Cluster

cloudpickle.register_pickle_by_value(sys.modules[__name__])

SYSTEM = {"sched_backend": "cuda", "sched_device": "cpu"}
HEAD = dict(num_cpus=2, num_workers=2, scheduler="tensor",
            _system_config=SYSTEM)


def wait_for(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def cluster():
    ray.shutdown()
    c = Cluster(initialize_head=True, head_node_args=dict(HEAD))
    yield c
    c.shutdown()


class _Snapshots:
    """Every (snapshot, node_of, avail) the TensorScheduler's _assign
    returns while installed."""

    def __init__(self, monkeypatch):
        from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

        self.seen = []
        orig = TensorScheduler._assign

        def _assign(sched, snapshot):
            out = orig(sched, snapshot)
            self.seen.append((snapshot, np.asarray(out[1]).copy(),
                              np.asarray(out[2]).copy()))
            return out

        monkeypatch.setattr(TensorScheduler, "_assign", _assign)

    def check_after(self, dead_rows):
        """(snapshots taken after the removal — those whose dead rows
        have zero capacity —, how many differ from assign_np, how many
        place a task on a dead row)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.scheduler import kernels as sk

        rows = list(dead_rows)
        later = [s for s in self.seen if not s[0][4][rows].any()]
        differ = on_dead = 0
        for snap, node_of, avail in later:
            ready_idx, ready_cls, demands, avail0, cap, mask, spread = \
                snap[:7]
            cls_full = np.zeros(int(ready_idx.max()) + 1, dtype=np.int32)
            cls_full[ready_idx] = ready_cls
            want_nodes, want_avail = sk.assign_np(
                ready_idx, cls_full, demands, avail0, cap,
                GLOBAL_CONFIG.sched_hybrid_threshold, mask, spread)
            differ += not (np.array_equal(node_of, want_nodes)
                           and np.array_equal(avail, want_avail))
            on_dead += bool(np.isin(node_of, list(dead_rows)).any())
        return len(later), differ, on_dead


# -- tests/test_cluster.py: TestGcsTables --------------------------------------

class TestGcsTables:
    def test_node_table(self, cluster):
        w = worker_mod.get_worker()
        assert len(w.gcs.node_table()) == 1
        n1 = cluster.add_node(num_cpus=4)
        n2 = cluster.add_node(num_cpus=4)
        table = {e.node_id: e for e in w.gcs.node_table()}
        assert len(table) == 3
        assert table[n1.node_id].state == "ALIVE"
        assert ray.cluster_resources()["CPU"] == 10
        cluster.remove_node(n2)
        assert wait_for(lambda: n2.state == "DEAD")
        assert ray.cluster_resources()["CPU"] == 6

    def test_job_table(self, cluster):
        w = worker_mod.get_worker()
        jobs = w.gcs.job_table()
        assert w.job_id in jobs and jobs[w.job_id]["state"] == "RUNNING"

    def test_kv_store(self, cluster):
        kv = worker_mod.get_worker().gcs
        kv.kv_put(b"k1", b"v1")
        kv.kv_put(b"k2", b"v2", namespace="ns")
        assert kv.kv_get(b"k1") == b"v1"
        assert kv.kv_get(b"k1", namespace="ns") is None
        assert kv.kv_get(b"k2", namespace="ns") == b"v2"
        assert set(kv.kv_keys(b"k")) == {b"k1"}
        assert kv.kv_del(b"k1") is True
        assert kv.kv_get(b"k1") is None

    def test_pubsub(self, cluster):
        w = worker_mod.get_worker()
        seen = []
        sub = w.gcs.subscribe("NODE", seen.append)
        n = cluster.add_node(num_cpus=1)
        assert any(m["event"] == "ALIVE" and m["node_id"] == n.node_id
                   for m in seen)
        cluster.remove_node(n)
        assert wait_for(lambda: any(m["event"] == "DEAD" for m in seen))
        w.gcs.unsubscribe("NODE", sub)

    def test_actor_table(self, cluster):
        w = worker_mod.get_worker()

        @ray.remote
        class A:
            def ping(self):
                return "pong"

        a = A.options(name="tabled").remote()
        assert ray.get(a.ping.remote(), timeout=10) == "pong"
        # ALIVE is published by the boot thread right after start();
        # the first method reply can race it by a few microseconds
        assert wait_for(
            lambda: {e.name: e for e in
                     w.gcs.actor_table()}["tabled"].state == "ALIVE")
        assert w.gcs.get_actor_by_name("tabled", "default") is not None
        ray.kill(a)
        assert wait_for(
            lambda: {e.name: e for e in
                     w.gcs.actor_table()}["tabled"].state == "DEAD")
        assert w.gcs.get_actor_by_name("tabled", "default") is None


@ray.remote(max_retries=3)
def sq(x):
    return x * x


# -- tests/test_cluster.py: TestMultiNodeExecution -----------------------------

class TestMultiNodeExecution:
    @pytest.mark.slow
    def test_tasks_run_across_nodes(self, cluster):
        cluster.add_node(num_cpus=4, num_workers=2)
        cluster.add_node(num_cpus=4, num_workers=2)
        cluster.wait_for_nodes()
        out = ray.get([sq.remote(i) for i in range(40)], timeout=60)
        assert out == [i * i for i in range(40)]

    @pytest.mark.slow
    def test_remove_node_mid_run_reschedules(self, cluster):
        """Killing a node mid-run re-schedules its queued tasks onto
        survivors and the job completes."""
        n1 = cluster.add_node(num_cpus=4, num_workers=2)
        cluster.add_node(num_cpus=4, num_workers=2)
        cluster.wait_for_nodes()

        @ray.remote(max_retries=5)
        def slow(i):
            time.sleep(0.15)
            return i

        refs = [slow.remote(i) for i in range(30)]
        time.sleep(0.2)  # let tasks land on both nodes
        cluster.remove_node(n1)
        out = ray.get(refs, timeout=90)
        assert out == list(range(30))
        assert n1.state == "DEAD"

    def test_health_check_detects_killed_processes(self, cluster):
        """Chaos: SIGKILL a node's workers without telling anyone; the GCS
        health checker must mark it dead and work must still finish."""
        n1 = cluster.add_node(num_cpus=4, num_workers=2)
        cluster.wait_for_nodes()

        @ray.remote(max_retries=5)
        def slow(i):
            time.sleep(0.1)
            return i

        refs = [slow.remote(i) for i in range(20)]
        time.sleep(0.15)
        n1.kill_worker_processes()
        out = ray.get(refs, timeout=90)
        assert out == list(range(20))
        assert wait_for(lambda: n1.state == "DEAD", timeout=15)

    @pytest.mark.slow
    def test_actor_restarts_on_surviving_node(self, cluster):
        n1 = cluster.add_node(num_cpus=4, num_workers=1)
        cluster.add_node(num_cpus=4, num_workers=1)
        cluster.wait_for_nodes()
        w = worker_mod.get_worker()

        @ray.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        # pin creation to n1 via node affinity
        from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

        a = Counter.options(
            max_restarts=2, max_task_retries=2,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=n1.node_id, soft=True)).remote()
        assert ray.get(a.incr.remote(), timeout=30) == 1
        rt = w.actors[a._actor_id]
        assert rt._pool.node_index == n1.index

        cluster.remove_node(n1)
        # restart elsewhere: state resets (fresh __init__); the call rides
        # max_task_retries across the restart
        assert ray.get(a.incr.remote(), timeout=60) == 1
        assert w.actors[a._actor_id]._pool.node_index != n1.index
        assert w.actors[a._actor_id].state.name == "ALIVE"

    def test_pg_bundles_reschedule_on_node_death(self, cluster):
        from ray_tpu_torch.util import placement_group, placement_group_table

        n1 = cluster.add_node(num_cpus=4, num_workers=1)
        cluster.add_node(num_cpus=4, num_workers=1)
        cluster.wait_for_nodes()
        w = worker_mod.get_worker()

        # head has 2 CPUs: a 4-CPU bundle only fits an added node
        pg = placement_group([{"CPU": 4}], strategy="PACK")
        assert pg.wait(10)
        entry = w.placement_groups.get(pg.id)
        nodes = getattr(w.scheduler, "_node_states", None) or \
            w.scheduler._nodes
        parent0 = nodes[entry.rows[0]].parent
        victim = n1 if parent0 == n1.index else \
            next(n for n in cluster.list_all_nodes if n.index == parent0)
        cluster.remove_node(victim)
        assert wait_for(
            lambda: placement_group_table()[pg.id.hex()]["state"]
            == "CREATED"
            and nodes[w.placement_groups.get(pg.id).rows[0]].parent
            != victim.index,
            timeout=15)


# -- fast node-death cases on the port ------------------------------------------

def test_remove_node_mid_run_is_exact_and_never_uses_the_dead_row(
        cluster, monkeypatch):
    """remove_node while 50 ms tasks run on two process nodes: every
    result exact, the node DEAD, and every assignment made after the
    removal equals assign_np's on the same snapshot and puts no task on
    the dead row."""
    snaps = _Snapshots(monkeypatch)
    n1 = cluster.add_node(num_cpus=2, num_workers=2)
    cluster.add_node(num_cpus=2, num_workers=2)
    w = worker_mod.get_worker()
    assert wait_for(lambda: all(h.ready for n in cluster.list_all_nodes
                                for h in n._entry.pool._handles), 60)

    @ray.remote(max_retries=5)
    def slow(i):
        time.sleep(0.05)
        return i

    refs = [slow.remote(i) for i in range(60)]
    assert wait_for(lambda: any(
        row["node_index"] == n1.index and row["state"] == "RUNNING"
        for row in w.scheduler.task_table()), 30)
    cluster.remove_node(n1)
    assert ray.get(refs, timeout=90) == list(range(60))
    assert n1.state == "DEAD"
    # the retried tasks and some of their own: all on live rows
    assert ray.get([slow.remote(i) for i in range(20)],
                   timeout=60) == list(range(20))
    n, differ, on_dead = snaps.check_after({n1.index})
    assert n > 0 and differ == 0 and on_dead == 0
    assert w.scheduler.stats()["device_assign_errors"] == 0


def test_simulate_machine_death_kills_and_stops_respawning(cluster):
    """ProcessWorkerPool.simulate_machine_death: every worker process
    dies and none comes back; the GCS is not told, and its health check
    marks the node DEAD within health_check_timeout_s plus a few
    periods."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    n1 = cluster.add_node(num_cpus=2, num_workers=2)
    pool = n1._entry.pool
    assert wait_for(lambda: all(h.ready for h in pool._handles), 60)
    pids = n1.worker_pids()
    assert len(pids) == 2
    t0 = time.monotonic()
    n1.kill_worker_processes()
    assert pool._respawn_disabled and not pool._node_dead
    assert wait_for(lambda: pool.live_process_count() == 0, 10)
    assert wait_for(lambda: n1.state == "DEAD", 10)
    detect = time.monotonic() - t0
    # the probes' budget, plus slack for a loaded test host (the card's
    # phase holds the health loop to the budget alone)
    assert detect < (GLOBAL_CONFIG.health_check_timeout_s
                     + 5 * GLOBAL_CONFIG.health_check_period_s + 3.0)
    time.sleep(0.3)
    assert pool.live_process_count() == 0
    assert set(n1.worker_pids()) == set(pids)   # no replacement spawned
    assert ray.get(sq.remote(3), timeout=30) == 9


def test_soft_pinned_actor_restarts_off_a_removed_node(cluster):
    """A max_restarts=2 actor soft-pinned to a node answers again from
    a surviving node after remove_node."""
    from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

    n1 = cluster.add_node(num_cpus=2, num_workers=1)
    cluster.add_node(num_cpus=2, num_workers=1)
    w = worker_mod.get_worker()

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    a = Counter.options(
        max_restarts=2, max_task_retries=2,
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=n1.node_id, soft=True)).remote()
    assert ray.get(a.incr.remote(), timeout=60) == 1
    assert w.actors[a._actor_id]._pool.node_index == n1.index
    cluster.remove_node(n1)
    assert ray.get(a.incr.remote(), timeout=60) == 1
    assert w.actors[a._actor_id]._pool.node_index != n1.index
    assert w.actors[a._actor_id].state.name == "ALIVE"


def test_shutdown_leaves_no_worker_process(cluster):
    import os

    nodes = [cluster.add_node(num_cpus=2, num_workers=2) for _ in range(2)]
    assert wait_for(lambda: all(h.ready for n in nodes
                                for h in n._entry.pool._handles), 60)
    pids = [p for n in nodes for p in n.worker_pids()]
    assert len(pids) == 4
    cluster.shutdown()

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True

    assert wait_for(lambda: not any(alive(p) for p in pids), 10)


def test_remote_nodes_raise_until_the_multi_node_plane(cluster):
    """The multi-node plane is ported: add_node(remote=True) starts a
    node daemon (tests/test_torch_remote_node.py). A node of either kind
    that declares GPUs its workers cannot see is still refused, and
    leaves no node behind."""
    with pytest.raises(ValueError, match="worker_gpu_access"):
        cluster.add_node(num_cpus=2, num_gpus=1, remote=True)
    with pytest.raises(ValueError, match="worker_gpu_access"):
        cluster.add_node(num_cpus=2, num_gpus=1)
    assert cluster.list_all_nodes == []
    node = cluster.add_node(num_cpus=2, num_workers=1, remote=True,
                            resources={"away": 1.0})
    assert node._entry.kind == "remote"

    @ray.remote(resources={"away": 1.0})
    def where():
        import os
        return os.getpid()

    assert ray.get(where.remote(), timeout=60) in node.worker_pids()


def test_dead_rows_never_reach_the_kernel(monkeypatch):
    """Rows of removed nodes stay in the node table (indices are never
    reused), but the device assign drops them: with 1100 rows of which
    1000 are dead, kernels.assign sees at most MAX_NODES rows, and the
    result (mapped back to table rows) equals assign_np's."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.local import NodeState
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

    GLOBAL_CONFIG.set("sched_device", "cpu")
    sched = TensorScheduler([NodeState((2.0, 0.0, 1e18, 0.0))],
                            lambda task: None)
    try:
        g = np.random.default_rng(0)
        for i in range(1099):
            sched.add_node(NodeState((float(g.integers(1, 5)), 0.0, 1e18,
                                      0.0)), wake=False)
        dead = set(g.choice(np.arange(1, 1100), 1000, replace=False)
                   .tolist())
        for row in dead:
            sched.remove_node(row)
        seen = []
        orig = sk.assign

        def assign(*args, **kwargs):
            seen.append(args[3].shape[0])
            return orig(*args, **kwargs)

        monkeypatch.setattr(sk, "assign", assign)
        K, k = 3, 500
        ready_cls = g.integers(0, K, k).astype(np.int32)
        demands = np.zeros((K, 4), np.float32)
        demands[:, 0] = [1.0, 0.5, 0.0]
        avail, cap = sched._avail.copy(), sched._cap.copy()
        mask = np.ones((K, 1100), bool)
        spread = np.array([False, True, False])
        threshold = GLOBAL_CONFIG.sched_hybrid_threshold
        node_of, new_avail = sched._device_assign(
            ready_cls, demands, avail, cap, threshold, mask, spread)
        assert seen == [100] and seen[0] <= sk.MAX_NODES
        ready_idx = np.arange(k)
        want = sk.assign_np(ready_idx, ready_cls, demands, avail, cap,
                            threshold, mask, spread)
        assert np.array_equal(new_avail, want[1])
        assert not np.isin(node_of, list(dead)).any()
        # SPREAD tasks are interchangeable: the same count a node
        for c in range(K):
            sel = ready_cls == c
            if spread[c]:
                assert np.array_equal(
                    np.bincount(node_of[sel] + 1, minlength=1101),
                    np.bincount(want[0][sel] + 1, minlength=1101))
            else:
                assert np.array_equal(node_of[sel], want[0][sel])
    finally:
        sched.shutdown()
        GLOBAL_CONFIG.reset()


# -- tests/test_ops_layer.py::TestAutoscaler, and fast autoscaler cases ---------

def _autoscaled_runtime(**knobs):
    ray.shutdown()
    ray.init(num_cpus=1, num_workers=2, scheduler="tensor",
             _system_config=dict(SYSTEM, **knobs))
    return ray._worker.get_worker()


class TestAutoscaler:
    @pytest.mark.slow
    def test_scales_up_under_pressure_and_down_when_idle(self):
        from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                              VirtualNodeProvider)

        w = _autoscaled_runtime()
        try:
            provider = VirtualNodeProvider(w, num_cpus=4, num_workers=2)
            scaler = Autoscaler(w, provider, AutoscalerConfig(
                min_nodes=0, max_nodes=2, upscale_ticks=2,
                idle_timeout_s=0.6, poll_interval_s=0.1))
            scaler.start()

            @ray.remote
            def slow(i):
                time.sleep(0.4)
                return i

            # 12 tasks against 1 CPU: backlog forces an upscale
            refs = [slow.remote(i) for i in range(12)]
            out = ray.get(refs, timeout=90)
            assert out == list(range(12))
            assert scaler.num_upscales >= 1
            # demand gone: idle nodes return to the provider
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline \
                    and scaler.num_downscales == 0:
                time.sleep(0.1)
            assert scaler.num_downscales >= 1
            scaler.stop()
        finally:
            ray.shutdown()


def test_autoscaler_upscale_then_downscale_fast():
    """A backlog against 1 CPU adds a node; once idle it goes back, its
    row dead, and work after the downscale still runs exactly."""
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                          VirtualNodeProvider)

    w = _autoscaled_runtime()
    try:
        provider = VirtualNodeProvider(w, num_cpus=2, num_workers=2)
        scaler = Autoscaler(w, provider, AutoscalerConfig(
            min_nodes=0, max_nodes=1, upscale_ticks=2,
            idle_timeout_s=0.3, poll_interval_s=0.05))
        scaler.start()

        @ray.remote
        def slow(i):
            time.sleep(0.3)
            return i

        assert ray.get([slow.remote(i) for i in range(8)],
                       timeout=90) == list(range(8))
        assert scaler.num_upscales >= 1
        assert wait_for(lambda: scaler.num_downscales >= 1, 20)
        scaler.stop()
        dead = [e for e in w.gcs.node_table() if e.state == "DEAD"]
        assert dead and all(not w.scheduler._cap[e.index].any()
                            for e in dead)
        assert scaler.stats() == {"provider_nodes": 0,
                                  "upscales": scaler.num_upscales,
                                  "downscales": scaler.num_downscales}
        assert ray.get([sq.remote(i) for i in range(5)],
                       timeout=30) == [i * i for i in range(5)]
        assert w.scheduler.stats()["device_assign_errors"] == 0
    finally:
        ray.shutdown()


def test_gang_autoscaler_strict_spread_never_partial():
    """tests/test_qos.py::TestGangAtomicScaleup, with the QoS plane on as
    there: a STRICT_SPREAD group of two 2-CPU bundles that a 1-CPU head
    cannot host is provisioned in one decision on two new nodes, and at
    no observed instant does it show a partial placement."""
    from ray_tpu_torch.autoscaler import (GangAutoscaler,
                                          GangAutoscalerConfig,
                                          VirtualNodeProvider)
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    placement_group_table)

    w = _autoscaled_runtime(qos=True)
    try:
        assert w.qos_plane is not None
        provider = VirtualNodeProvider(w, num_cpus=4, num_workers=2)
        scaler = GangAutoscaler(w, provider, GangAutoscalerConfig(
            min_nodes=0, max_nodes=2, upscale_ticks=3,
            idle_timeout_s=60.0, poll_interval_s=0.1))
        scaler.start()
        assert w.placement_groups.hold_infeasible is True

        pg = placement_group([{"CPU": 2}, {"CPU": 2}],
                             strategy="STRICT_SPREAD", name="gang",
                             priority=1)
        ready = pg.ready()
        deadline = time.monotonic() + 60.0
        created = False
        while time.monotonic() < deadline and not created:
            row = placement_group_table()[pg.id.hex()]
            placed = len(row["bundle_rows"])
            # the atomicity observation: never a partial gang
            assert placed in (0, 2), row
            assert (row["state"] == "CREATED") == (placed == 2), row
            created = row["state"] == "CREATED"
            time.sleep(0.02)
        assert created, placement_group_table()
        ray.get(ready, timeout=10.0)

        row = placement_group_table()[pg.id.hex()]
        assert row["priority"] == 1
        assert len(set(row["bundle_rows"])) == 2, row
        parents = {w.scheduler._node_states[r].parent
                   for r in row["bundle_rows"]}
        assert len(parents) == 2 and 0 not in parents
        assert scaler.num_gang_upscales >= 1
        assert scaler.stats()["gang_upscales"] >= 1
        assert scaler.stats()["provider_nodes"] == 2

        @ray.remote(num_cpus=2, placement_group=pg)
        def inside():
            return 7

        assert ray.get(inside.remote(), timeout=60.0) == 7
        scaler.stop()
        assert w.placement_groups.hold_infeasible is False
    finally:
        ray.shutdown()


def test_gang_lands_only_after_its_scaleup_is_counted():
    """A node's capacity reaches the scheduler before the provider call
    that adds it returns. A provider that is slow to return (as a loaded
    host makes spawning a node's workers) opened the window in which the
    placement retry thread put the pending gang on the decision's first
    two nodes while the autoscaler had neither returned from the second
    nor counted the decision. The manager now holds its retries for the
    whole scale-up: at the first instant the gang shows CREATED, the
    decision is counted and both nodes are the provider's."""
    from ray_tpu_torch.autoscaler import (GangAutoscaler,
                                          GangAutoscalerConfig,
                                          VirtualNodeProvider)
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    placement_group_table)

    class SlowProvider(VirtualNodeProvider):
        def create_node(self):
            entry = super().create_node()
            time.sleep(1.0)   # the node's capacity is already visible
            return entry

    w = _autoscaled_runtime(qos=True)
    try:
        scaler = GangAutoscaler(w, SlowProvider(w, num_cpus=4,
                                                num_workers=2),
                                GangAutoscalerConfig(
                                    min_nodes=0, max_nodes=2,
                                    upscale_ticks=3, idle_timeout_s=60.0,
                                    poll_interval_s=0.1))
        scaler.start()
        pg = placement_group([{"CPU": 2}, {"CPU": 2}],
                             strategy="STRICT_SPREAD", name="gang")
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            row = placement_group_table()[pg.id.hex()]
            if row["state"] == "CREATED":
                # read at once, before anything else can catch up
                counted = scaler.num_gang_upscales
                nodes = scaler.stats()["provider_nodes"]
                break
            time.sleep(0.005)
        else:
            raise AssertionError(placement_group_table())
        assert (counted, nodes) == (1, 2)
        assert len(set(row["bundle_rows"])) == 2, row
        scaler.stop()
    finally:
        ray.shutdown()


def test_late_first_node_keeps_the_head_alive():
    """The GCS health loop records heartbeats and starts with the first
    remote node: a node that joins more than node_heartbeat_timeout_s
    after init must not find the head's own node 0 stale and declare it
    DEAD (the drive of `start --head`, then `start --address` later). The
    head keeps running tasks pinned to it."""
    from ray_tpu_torch.util import state

    ray.shutdown()
    ray.init(num_workers=1, resources={"at_head": 1.0},
             _system_config=dict(SYSTEM, worker_mode="process",
                                 node_heartbeat_timeout_s=1.0))
    try:
        w = ray._worker.get_worker()
        time.sleep(1.5)           # older than the timeout at the join
        w.add_remote_cluster_node(num_cpus=1, num_workers=1)
        time.sleep(1.0)           # the loop's probes have run
        rows = state.list_nodes()
        assert [r["state"] for r in rows] == ["ALIVE", "ALIVE"], rows

        @ray.remote(resources={"at_head": 1.0})
        def on_head():
            return 1

        assert ray.get(on_head.remote(), timeout=60) == 1
    finally:
        ray.shutdown()


def test_a_stalled_health_loop_declares_no_live_node_dead():
    """Only the GCS health loop records heartbeats, so while it is late
    no node can record one. A probe that stalls the loop past
    node_heartbeat_timeout_s must not make the other live nodes look
    stale: every node keeps answering, none is declared DEAD."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.gcs import GcsService
    from ray_tpu_torch._private.ids import NodeID

    class Pool:
        def __init__(self, stall_s=0.0):
            self.stall_s, self.probes = stall_s, 0

        def live_process_count(self):
            self.probes += 1
            if self.probes == 3:
                time.sleep(self.stall_s)     # the loop's one long stall
            return 2

    class FakeWorker:
        def __init__(self):
            self.deaths = []

        def on_node_failure(self, node_id, reason=""):
            self.deaths.append(reason)
            gcs.mark_node_dead(node_id, reason)

    GLOBAL_CONFIG.set("node_heartbeat_timeout_s", 0.5)
    w = FakeWorker()
    gcs = GcsService(w)
    try:
        slow, other = Pool(stall_s=1.2), Pool()
        gcs.register_node(NodeID.from_random(), 1, {"CPU": 1},
                          kind="process", pool=slow)
        gcs.register_node(NodeID.from_random(), 2, {"CPU": 1},
                          kind="process", pool=other)
        gcs.start_health_checks(interval=0.05)
        assert wait_for(lambda: other.probes >= 10, timeout=10)
        assert slow.probes > 3            # the stall happened and ended
        assert w.deaths == []
        assert [e.state for e in gcs.node_table()] == ["ALIVE", "ALIVE"]
    finally:
        gcs.shutdown()
        GLOBAL_CONFIG.reset()
