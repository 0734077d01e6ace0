"""The port's node-loss fault domain: the cases of
``tests/test_node_loss.py`` on ``ray_tpu_torch``. The head's
TensorScheduler runs its device path on the host (``sched_device``
"cpu"); node rows come from ``util.state.list_nodes``, as in the
reference.

Node-loss fault domain: whole-node SIGKILL under default dispatch.

The tentpole drill set: a remote node dies WHOLE (daemon SIGKILLed
with its entire worker process group via the seeded chaos ``node``
site, or declared dead after a link partition) while the default
two-level plane has locally-dispatched leases, p2p actor calls, and
sole-copy objects in flight on it. Guarded here:

- seeded ``node``-site kill mid-flight: retry-carrying locally
  dispatched leaves resubmit head-side under their ORIGINAL return
  ids (exactly-once side effects, bit-correct results), the
  non-retriable driver fails with a terminal error, and the death is
  visible end-to-end (two_level_stats, chaos counters,
  ``state.list_nodes`` death_reason, metrics families);
- sole-copy lineage: an object produced by a LOCALLY-dispatched
  nested task (no head-side TaskSpec ever existed) reconstructs
  through the retained lease record even though its submitting owner
  died with the same node;
- actors restart elsewhere and cached p2p routes repoint: a caller on
  a surviving node keeps calling through the death and lands on the
  restarted incarnation;
- rejoin-after-declared-dead is FENCED: a node that comes back after
  the reconciler already resubmitted its leases gets its dead-era
  completions dropped (``orphan_fenced``), never double-resolved.
"""

import hashlib
import os
import re
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch._private import metrics as metrics_mod
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util import state


def _poll(fn, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    return fn()


# Leaves are defined from SOURCE and exec'd so the daemon's workers
# (which cannot import the test module) receive them as cloudpickle
# blobs — same idiom as test_head_bypass_default. The sleep comes
# BEFORE the mark: an attempt SIGKILLed mid-sleep leaves no trace, so
# the marks file counts completions, not starts.
_MARK_LEAF_SRC = """
def mark_leaf(key, path, sleep_s):
    import hashlib
    import os
    import time
    time.sleep(sleep_s)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\\n").encode())
    finally:
        os.close(fd)
    return hashlib.sha256(key.encode()).hexdigest()
"""

_PRODUCE_SRC = """
def produce_blob():
    # deterministic and > the inline threshold, so the bytes live in
    # the producing node's shm arena (the sole copy) and only a
    # placeholder travels to the head
    return bytes(range(256)) * 2048
"""


def _load_src(src, name):
    ns: dict = {}
    exec(src, ns)
    return ns[name]


def _expected_blob():
    return bytes(range(256)) * 2048


def _read_marks(path):
    try:
        with open(path) as fh:
            return fh.read().split()
    except FileNotFoundError:
        return []


@pytest.fixture
def node_loss_ray():
    """Default two-level knobs (the fault domain under test is the
    DEFAULT plane) with the soak fixture's 1-core-host-friendly
    liveness budgets: node death in these drills is detected by the
    daemon link EOF (SIGKILL closes the socket), so relaxing the
    heartbeat only prevents FALSE deaths from scheduler starvation,
    never delays a real one."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                 _system_config={"worker_mode": "process",
                                 "sched_device": "cpu",
                                 "node_heartbeat_timeout_s": 20.0,
                                 "health_check_timeout_s": 5.0})
    w = worker_mod.get_worker()
    ea = w.add_remote_cluster_node(num_cpus=4.0, num_workers=3,
                                   resources={"a": 4})
    eb = w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                                   resources={"b": 2})
    yield w, ea, eb
    chaos.disarm()
    ray_tpu_torch.shutdown()


def _dead_remote_rows():
    return [r for r in state.list_nodes()
            if r["kind"] == "remote" and r["state"] == "DEAD"]


@pytest.mark.chaos
class TestSeededNodeKillSoak:
    def test_node_kill_mid_flight_exactly_once(self, node_loss_ray,
                                               tmp_path):
        """The headline drill: the chaos ``node`` site SIGKILLs node
        a's daemon (whole process group — the simulated machine) while
        retry-carrying locally-dispatched leaves sleep mid-flight.
        The reconciler must resubmit them under their original return
        ids (marks exactly-once, hashes bit-correct), the max_retries=0
        driver must fail terminally, and the death must show up in
        stats, chaos counters, node state, and the metrics families."""
        w, ea, eb = node_loss_ray
        marks = str(tmp_path / "marks")
        mark_leaf = _load_src(_MARK_LEAF_SRC, "mark_leaf")
        fast = ray_tpu_torch.remote(mark_leaf)  # default retries
        slow = ray_tpu_torch.remote(mark_leaf).options(max_retries=3)

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def warm(path, keys):
            import ray_tpu_torch
            return ray_tpu_torch.get(
                [fast.remote(k, path, 0.0) for k in keys], timeout=60.0)

        fast_keys = [f"fast-{i}" for i in range(4)]
        vals = ray_tpu_torch.get(warm.remote(marks, fast_keys), timeout=120.0)
        assert vals == [hashlib.sha256(k.encode()).hexdigest()
                        for k in fast_keys]

        # the doomed phase: a NON-retriable driver on node a submits
        # two slow retry-carrying leaves (node a has 3 workers: driver
        # + 2 leaves saturate it, so both admit locally). Chaos arms
        # only AFTER both local admissions are confirmed — the kill
        # must land while the leaves genuinely sleep mid-flight.
        base_ld = w.two_level_stats["local_dispatch"]

        @ray_tpu_torch.remote(resources={"a": 1.0}, max_retries=0)
        def doomed(path, keys, sleep_s):
            import ray_tpu_torch
            return ray_tpu_torch.get(
                [slow.remote(k, path, sleep_s) for k in keys],
                timeout=180.0)

        slow_keys = ["slow-0", "slow-1"]
        ref = doomed.remote(marks, slow_keys, 4.0)
        assert _poll(lambda: (w.two_level_stats["local_dispatch"]
                              >= base_ld + 2)), w.two_level_stats

        chaos.arm(chaos.FaultPlan(20817, faults=[
            ("node", 2, "kill", {"node": ea.index})]))
        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=120.0)
        chaos.disarm()

        # both orphaned leaves re-run to completion elsewhere — and
        # NOTHING ran twice: the killed attempts died mid-sleep,
        # before their marks
        def both_slow_marked():
            ks = _read_marks(marks)
            return ks if set(slow_keys) <= set(ks) else None

        ks = _poll(both_slow_marked, timeout=90.0)
        assert ks and sorted(ks) == sorted(fast_keys + slow_keys), (
            f"completions not exactly-once after node kill: {ks}")

        s = w.two_level_stats
        assert s.get("node_deaths", 0) >= 1, s
        assert s.get("orphan_retried", 0) >= 1, s

        ctr = chaos.counters()
        assert ctr["injected"].get("node", 0) >= 1, ctr

        rows = _dead_remote_rows()
        assert rows and any(r.get("death_reason") for r in rows), (
            state.list_nodes())

        text = "\n".join(metrics_mod._render_core(w))
        for fam in ("ray_tpu_node_deaths_total",
                    "ray_tpu_orphan_leases_retried_total"):
            m = re.search(rf"^{fam} (\d+)", text, re.M)
            assert m and int(m.group(1)) >= 1, f"{fam} not >=1:\n{text}"


class TestSoleCopyLineage:
    def test_local_lease_producer_reconstructs_after_node_death(
            self, node_loss_ray):
        """A nested task locally dispatched on node a produces the
        SOLE copy of its return (the head holds a placeholder only)
        and then the whole node dies — submitting owner included. The
        retained lease record is the only lineage there is; get() must
        reconstruct through it, bit-correct."""
        w, ea, eb = node_loss_ray
        producer = ray_tpu_torch.remote(
            _load_src(_PRODUCE_SRC, "produce_blob")).options(max_retries=2)

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def make():
            import ray_tpu_torch
            ref = producer.remote()
            # worker-side get: proves the producer COMPLETED on the
            # node (its record migrated to the lineage table) before
            # the ref escapes to the head
            assert len(ray_tpu_torch.get(ref, timeout=60.0)) == 512 * 1024
            return ref

        inner = ray_tpu_torch.get(make.remote(), timeout=120.0)
        oid = inner.object_id()
        # the bytes were never fetched head-side: the directory knows
        # a location, and the completed lease is retained as lineage
        assert w.gcs.object_location_get(oid) is not None
        assert _poll(lambda: len(w._local_lease_lineage) >= 1), (
            "producer spilled to the head instead of dispatching "
            "locally — the drill needs a record-only lineage path")

        base_retries = w.task_manager.num_retries
        ea.pool.simulate_machine_death()
        assert _poll(_dead_remote_rows, timeout=30.0)

        val = ray_tpu_torch.get(inner, timeout=90.0)
        assert val == _expected_blob()
        assert w.task_manager.num_retries > base_retries


class TestActorRestartAndRouteRepoint:
    def test_actor_restarts_elsewhere_and_caller_reroutes(
            self, node_loss_ray):
        """An actor pinned (softly) to node a dies with the machine;
        a caller task on node b keeps calling through the death. The
        actor must restart on a surviving node (fresh pid), the
        caller's cached p2p route must sweep away (node_dead
        broadcast), and the loop must observe BOTH incarnations."""
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)

        w, ea, eb = node_loss_ray

        @ray_tpu_torch.remote(max_restarts=1)
        class Pid:
            def ping(self):
                import os
                return os.getpid()

        a = Pid.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            ea.node_id, soft=True)).remote()
        pid0 = ray_tpu_torch.get(a.ping.remote(), timeout=60.0)
        assert pid0 in ea.pool.pids(), "actor did not land on node a"

        @ray_tpu_torch.remote(resources={"b": 1.0})
        def pid_loop(h, deadline_s):
            import time
            import ray_tpu_torch
            pids = []
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                try:
                    pids.append(ray_tpu_torch.get(h.ping.remote(),
                                            timeout=10.0))
                except Exception:
                    time.sleep(0.3)
                    continue
                if len(set(pids)) >= 2:
                    return pids
                time.sleep(0.1)
            return pids

        # the loop self-synchronizes: it cannot see a second pid until
        # the kill lands, and it keeps retrying until the restarted
        # incarnation answers
        ref = pid_loop.remote(a, 90.0)
        time.sleep(1.2)  # let some pre-kill calls land on incarnation 0
        ea.pool.simulate_machine_death()

        pids = ray_tpu_torch.get(ref, timeout=120.0)
        assert pids, "caller never reached the actor"
        assert pids[0] == pid0
        assert len(set(pids)) >= 2, (
            f"actor never restarted on a survivor: pids={set(pids)}")
        assert pids[-1] != pid0
        assert _poll(_dead_remote_rows, timeout=30.0)
        # the surviving caller exercised the p2p plane around the
        # death (direct calls, then the sweep to the head path)
        s = w.two_level_stats
        assert s.get("p2p", 0) + s.get("head_fallback", 0) >= 1, s


class TestRejoinFencing:
    def test_rejoin_after_declared_dead_is_fenced(self, node_loss_ray,
                                                  tmp_path):
        """The stale-replay drill: node a is PARTITIONED (link severed,
        daemon and workers alive) and the head declares it dead and
        resubmits its leases. When the isolated node rejoins, it must
        come back FENCED — its dead-era completions are counted and
        dropped, never double-resolved — and then serve fresh work as
        a fresh node."""
        w, ea, eb = node_loss_ray
        marks = str(tmp_path / "marks")
        leaf = ray_tpu_torch.remote(
            _load_src(_MARK_LEAF_SRC, "mark_leaf")).options(max_retries=2)

        @ray_tpu_torch.remote(resources={"a": 1.0}, max_retries=0)
        def doomed(path, keys, sleep_s):
            import ray_tpu_torch
            return ray_tpu_torch.get(
                [leaf.remote(k, path, sleep_s) for k in keys],
                timeout=120.0)

        base_ld = w.two_level_stats["local_dispatch"]
        keys = ["fence-0", "fence-1"]
        ref = doomed.remote(marks, keys, 2.5)
        assert _poll(lambda: (w.two_level_stats["local_dispatch"]
                              >= base_ld + 2)), w.two_level_stats

        # sever the link, then declare the node dead in the same
        # breath — the partitioned daemon survives (the pool's "exit"
        # frame can't cross the severed link) and will redial into a
        # head that has already moved on
        ea.pool.sever_link()
        w.on_node_failure(ea.node_id, "declared dead by partition drill")

        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=60.0)

        # head side: the reconciler resubmitted the in-flight leaves...
        assert _poll(lambda: w.two_level_stats.get("orphan_retried", 0)
                     >= 1, timeout=30.0), w.two_level_stats
        # ...and the rejoined node was fenced: its dead-era results
        # (outbox replays and/or late fresh completions) were dropped
        assert _poll(lambda: w.two_level_stats.get("orphan_fenced", 0)
                     >= 1, timeout=60.0), w.two_level_stats

        # at-least-once during a partition is the contract: the
        # isolated node may legitimately finish a leaf before the
        # fence lands, and the head's resubmission runs it again —
        # but never more than once per side, and never a LOST key
        def all_marked():
            ks = _read_marks(marks)
            return ks if set(keys) <= set(ks) else None

        ks = _poll(all_marked, timeout=90.0)
        assert ks and set(ks) == set(keys), ks
        assert all(ks.count(k) <= 2 for k in keys), (
            f"a fenced lease still double-executed per side: {ks}")

        # the node is back as a FRESH node and serves fresh work
        def rejoined():
            rows = [r for r in state.list_nodes()
                    if r["kind"] == "remote" and r["state"] == "ALIVE"
                    and r.get("resources", {}).get("a")]
            return rows or None

        assert _poll(rejoined, timeout=60.0), state.list_nodes()

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def fresh():
            return 11

        assert ray_tpu_torch.get(fresh.remote(), timeout=60.0) == 11
        # the dead incarnation's row stays DEAD next to the fresh one
        assert _dead_remote_rows(), state.list_nodes()
