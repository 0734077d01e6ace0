"""The port's two-level scheduler and p2p actor plane: the cases of
``tests/test_two_level.py`` on ``ray_tpu_torch``. The head's
TensorScheduler runs its device path on the host (``sched_device``
"cpu"). Node and actor rows come from ``util.state``, as in the
reference. Workers unpickle this module's
functions by value (registered below) and never load jax or ray_tpu.

Two-level scheduler + p2p actor plane (the head-bypass tentpole).

A 2-remote-node cluster with ``local_dispatch`` + ``actor_p2p`` on:
worker-originated actor calls ship worker -> caller daemon -> peer
daemon over the peer lane (the head sees only sequenced completion
receipts), and worker-submitted nested tasks admit on the node's
LocalScheduler against the head-refreshed resource view. Covered here:

- the >=90% steady-state head-skip soak, with the trace plane showing
  a worker -> peer-exec-lane "p2p" flow arrow and NO head-lane span
  for purely-p2p calls;
- seeded chaos ``peer_link`` sever mid-flight: the in-flight call
  falls back to the head path with the same attempt token and the
  executing worker's completion cache keeps it exactly-once
  (bit-correct accumulator, one logical span per retried call);
- ``state.list_nodes`` / ``state.list_actors`` surfacing
  local_queue_depth / local_dispatched / resolved_address;
- the four metric families as schema-stable zeros while the knobs are
  off, and zero two-level traffic on the knobs-off wire (the
  byte-for-byte pre-PR guard).
"""

import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch._private import metrics as metrics_mod
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util import state

cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _poll(fn, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    return fn()


@pytest.fixture
def two_level_ray():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                 _system_config={"worker_mode": "process",
                                 "sched_device": "cpu",
                                 "local_dispatch": True,
                                 "actor_p2p": True})
    w = worker_mod.get_worker()
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"a": 2})
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"b": 2})
    yield w
    chaos.disarm()
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(resources={"b": 1.0})
class Acc:
    def __init__(self):
        self.total = 0

    def bump(self, x):
        self.total += x
        return self.total

    def apply(self, f, v):
        return f(v)


def _drive_calls(w, n_calls, timeout=120.0):
    """Actor on node b, caller task on node a issuing ``n_calls``
    sequential bumps; returns the final accumulator value."""
    actor = Acc.remote()
    ray_tpu_torch.get(actor.bump.remote(0), timeout=60.0)  # placed + live

    @ray_tpu_torch.remote(resources={"a": 1.0})
    def caller(h, n):
        import ray_tpu_torch
        out = 0
        for _ in range(n):
            out = ray_tpu_torch.get(h.bump.remote(1), timeout=60.0)
        return out

    return actor, ray_tpu_torch.get(caller.remote(actor, n_calls),
                              timeout=timeout)


class TestP2PSoak:
    def test_90pct_skip_head_and_trace_arrow(self, two_level_ray):
        w = two_level_ray
        n = 20
        _, total = _drive_calls(w, n)
        assert total == n

        # sequenced receipts drain through the outbox asynchronously
        assert _poll(lambda: w.two_level_stats["p2p"] >= 0.9 * n - 1), \
            w.two_level_stats
        assert w.two_level_stats["head_fallback"] == 0

        tp = w.trace_plane
        assert tp is not None

        def bump_trace():
            for row in tp.list_traces():
                evs = tp.trace(row["trace_id"])
                if any("caller" in e.get("name", "") for e in evs) \
                        and any("bump" in e.get("name", "")
                                for e in evs):
                    return evs
            return None

        events = _poll(bump_trace, timeout=30)
        assert events, "no trace linking caller -> Acc.bump"

        # p2p exec spans land on the actor's node lane, flagged p2p
        p2p_execs = [e for e in events if e.get("cat") == "exec"
                     and e["args"].get("lane") == "p2p"]
        assert p2p_execs, "no p2p-lane exec spans in the export"
        # ...with NO head-lane logical/sched span for those calls: a
        # purely peer-to-peer call never touched the head
        p2p_spans = {e["args"]["parent_span_id"] for e in p2p_execs}
        for e in events:
            if e.get("cat") in ("span", "sched"):
                assert e["args"].get("span_id") not in p2p_spans, e

        # >=1 flow arrow worker exec lane -> peer exec lane, named
        # "p2p", crossing pids (caller node -> actor node)
        arrows = {}
        for e in events:
            if e.get("cat") == "flow" and e.get("name") == "p2p":
                arrows.setdefault(e["id"], {})[e["ph"]] = e
        pairs = [p for p in arrows.values() if set(p) == {"s", "f"}]
        assert pairs, "no worker->peer p2p flow arrows"
        assert any(p["s"]["pid"] != p["f"]["pid"] for p in pairs), \
            "p2p arrow does not cross node lanes"


class TestPeerLinkChaos:
    def test_sever_mid_flight_is_exactly_once(self, two_level_ray):
        """Seeded soak: the 4th and 9th p2p dispatches hit a chaos
        ``peer_link sever`` — the lane drops with the call in flight,
        the daemon sweeps it into the head fallback carrying the same
        attempt token, and the executing worker's completion cache
        replays (never re-runs) anything it already finished. The
        accumulator total is the bit-exact proof: a lost call or a
        double execution both break it."""
        w = two_level_ray
        chaos.arm(chaos.FaultPlan(1234, faults=[
            ("peer_link", 3, "sever"), ("peer_link", 8, "sever")]))
        # the plan reaches the daemons via the 0.5s resview mirror
        time.sleep(1.2)
        n = 15
        _, total = _drive_calls(w, n, timeout=180.0)
        chaos.disarm()
        assert total == n, f"lost or double-executed calls: {total}"

        # the severed calls recovered through the head path
        assert _poll(lambda: w.two_level_stats["head_fallback"] >= 1), \
            w.two_level_stats
        assert w.two_level_stats["p2p"] >= 1
        ctr = chaos.counters()
        assert ctr["injected"].get("peer_link", 0) >= 1

        # one logical span per retried call: the fallback reuses the
        # p2p attempt's TaskID, so no span id (and no task id) shows up
        # under two logical spans
        tp = w.trace_plane
        for row in tp.list_traces():
            evs = tp.trace(row["trace_id"])
            seen = set()
            for e in evs:
                if e.get("cat") == "span":
                    sid = e["args"]["span_id"]
                    assert sid not in seen, f"duplicated span {sid}"
                    seen.add(sid)

    def test_sever_with_delay_plan_still_exact(self, two_level_ray):
        """Same invariant under a mixed plan (delay then sever): the
        delayed call completes on the lane, the severed one falls
        back."""
        w = two_level_ray
        chaos.arm(chaos.FaultPlan(77, faults=[
            ("peer_link", 2, "delay", {"delay_s": 0.05}),
            ("peer_link", 5, "sever")]))
        time.sleep(1.2)
        n = 10
        _, total = _drive_calls(w, n, timeout=180.0)
        chaos.disarm()
        assert total == n
        assert _poll(lambda: w.two_level_stats["head_fallback"] >= 1), \
            w.two_level_stats


class TestStateSurfacing:
    def test_list_nodes_and_actors_carry_two_level_fields(
            self, two_level_ray):
        w = two_level_ray

        @ray_tpu_torch.remote(max_retries=0)
        def leaf():
            return 1

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def submitter(k):
            import ray_tpu_torch
            return sum(ray_tpu_torch.get(
                [leaf.remote() for _ in range(k)], timeout=60.0))

        actor = Acc.remote()
        ray_tpu_torch.get(actor.bump.remote(0), timeout=60.0)
        assert ray_tpu_torch.get(submitter.remote(6), timeout=120.0) == 6

        def dispatched():
            rows = [r for r in state.list_nodes()
                    if r["kind"] == "remote"]
            return rows if any(r.get("local_dispatched", 0) > 0
                               for r in rows) else None

        rows = _poll(dispatched)
        assert rows, "no remote node reported local dispatches"
        for r in rows:
            assert r["local_queue_depth"] >= 0
            assert r["local_dispatched"] >= 0

        arow = next(r for r in state.list_actors()
                    if r["class_name"].endswith("Acc")
                    and r["state"] == "ALIVE")
        addr = arow["resolved_address"]
        assert addr is not None, arow
        assert addr["node_index"] >= 1
        assert len(addr["peer"]) == 2 and addr["worker_num"] >= 0
        # head-resident rows still carry the key (schema stability)
        assert all("resolved_address" in r for r in state.list_actors())


class TestMarkRefsPickler:
    """The ref-marking pickler rides EVERY worker-originated submit and
    actor call once the daemon advertises two-level — it must keep
    cloudpickle's full reduction (lambdas, closures, __main__ classes),
    not just detect refs."""

    def test_closures_pickle_by_value(self):
        import cloudpickle as cp

        from ray_tpu_torch._private.runtime.worker_process import \
            _dumps_mark_refs

        k = 41
        blob, refs = _dumps_mark_refs(
            ((lambda: k + 1,), {"f": lambda v: v * 2}))
        assert refs == []
        args, kwargs = cp.loads(blob)
        assert args[0]() == 42
        assert kwargs["f"](3) == 6

    def test_ref_flag_still_set(self):
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.runtime.worker_process import \
            _dumps_mark_refs

        ref = ObjectRef(ObjectID(b"\x01" * 20), None, _register=False)
        _, refs = _dumps_mark_refs(((ref,), {}))
        assert [r.object_id().binary() for r in refs] == [b"\x01" * 20]

    def test_closure_args_over_both_two_level_lanes(self, two_level_ray):
        """E2E: a closure arg rides (a) the p2p actor-call blob and
        (b) a nested submit's marked args blob without PicklingError."""

        @ray_tpu_torch.remote(max_retries=0)
        def use(f, v):
            return f(v)

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def caller(h):
            import ray_tpu_torch
            k = 40
            a = ray_tpu_torch.get(h.apply.remote(lambda v: v + k, 2),
                            timeout=60.0)
            b = ray_tpu_torch.get(use.remote(lambda v: v * 2, 21),
                            timeout=60.0)
            return a, b

        actor = Acc.remote()
        ray_tpu_torch.get(actor.bump.remote(0), timeout=60.0)
        assert ray_tpu_torch.get(caller.remote(actor),
                           timeout=120.0) == (42, 42)


class TestPoisonP2PBlob:
    def test_corrupt_blob_errors_the_call_not_the_worker(self):
        """A p2p blob that fails to unpickle in the actor process must
        become a normal ('err', ...) completion — raising out of
        actor_call would kill the dedicated actor worker and all its
        state."""
        from ray_tpu_torch._private.runtime.worker_process import _WorkerRunner

        class _FakeConn:
            def __init__(self):
                self.sent = []

            def send(self, msg):
                self.sent.append(msg)

        runner = _WorkerRunner(_FakeConn(), None, "", 1024)
        runner.actor_instance = object()
        payload = {"task_id": b"\x07" * 16, "method": "nope",
                   "p2p_blob": b"\x80not a pickle", "args_blob": None,
                   "num_returns": 1, "name": "Acc.nope", "dedup": True}
        runner.actor_call(payload)
        msg = runner.conn.sent[-1]
        assert msg[0] == "err" and msg[1] == payload["task_id"]
        # the dedup cache recorded the error: a head-fallback retry of
        # the same attempt replays it bit-for-bit instead of re-running
        runner.actor_call(payload)
        assert runner.conn.sent[-1] == msg


class TestKnobsOff:
    def test_knobs_off_emits_zero_two_level_traffic(self):
        """local_dispatch=False + actor_p2p=False (the escape hatch —
        no longer the default) must be the pre-two-level wire: no
        resview pushes, no p2p adverts, zero two-level counters after
        a workload that WOULD use both lanes, and the four metric
        families rendered as schema-stable zeros."""
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2,
                     _system_config={"worker_mode": "process",
                                     "sched_device": "cpu",
                                     "local_dispatch": False,
                                     "actor_p2p": False})
        w = worker_mod.get_worker()
        w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                                  resources={"a": 2})
        w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                                  resources={"b": 2})
        try:
            _, total = _drive_calls(w, 5)
            assert total == 5
            # the push loop may exist (it starts with the first remote
            # node so mid-session knob toggles work) but with both
            # knobs off it must send nothing and nothing two-level may
            # happen downstream of it:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            assert not GLOBAL_CONFIG.local_dispatch
            assert not GLOBAL_CONFIG.actor_p2p
            assert w.two_level_stats == {"local_dispatch": 0,
                                         "spillback": 0, "p2p": 0,
                                         "head_fallback": 0,
                                         "node_deaths": 0,
                                         "orphan_retried": 0,
                                         "orphan_fenced": 0}
            lines = metrics_mod._render_core(w)
            for fam in ("ray_tpu_sched_local_dispatch_total",
                        "ray_tpu_sched_spillback_total",
                        "ray_tpu_actor_calls_p2p_total",
                        "ray_tpu_actor_calls_head_fallback_total"):
                val = [ln for ln in lines
                       if ln.startswith(fam + " ")
                       or ln.startswith(fam + "{")]
                assert val, f"{fam} missing from /metrics render"
                assert all(ln.split()[-1] in ("0", "0.0")
                           for ln in val), val
            # every actor row still carries the resolved_address key —
            # None, since no daemon advertises a peer route
            for r in state.list_actors():
                assert r["resolved_address"] is None
        finally:
            ray_tpu_torch.shutdown()
