"""The port's two-level defaults: the cases of
``tests/test_head_bypass_default.py`` on ``ray_tpu_torch``, plus the new
knobs' defaults read against the reference's ``GLOBAL_CONFIG``. The
head's TensorScheduler runs its device path on the host
(``sched_device`` "cpu"); node rows come from ``util.state.list_nodes``,
as in the reference.

Default-on decentralized dispatch: the head-bypass acceptance guards.

This PR flips ``local_dispatch`` and ``actor_p2p`` to True and closes
the remaining spill-to-head gaps (retry-carrying tasks, resident-ref
args, remote lease envelopes, resource-view gossip). Guarded here:

- the knob defaults themselves (a silent un-flip fails fast);
- the knobs-off wire: ``local_dispatch=False`` submit blobs carry no
  two-level keys at all — byte-for-byte the pre-change shape;
- default config (NO knob overrides) steady-state head-skip >= 90%
  for worker-submitted tasks, including retry-carrying ones and
  ref-carrying ones whose args are node-resident;
- a dead worker's locally-dispatched lease retries LOCALLY with
  per-attempt accounting, exactly-once;
- ``state.list_nodes`` per-node spill-reason counters + resview age;
- the combined chaos soak: ``peer_link`` severs plus a ``head``
  link blackout while retry-carrying tasks dispatch locally —
  exactly-once side effects, bit-correct results.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util import state
from ray_tpu_torch._private.config import GLOBAL_CONFIG


def _poll(fn, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    return fn()


class TestDefaultsFlipped:
    def test_decentralized_dispatch_is_the_default(self):
        """The tentpole flip, asserted against the knob table itself
        (not a live config, which tests may have overridden)."""
        defs = GLOBAL_CONFIG._entries
        assert defs["local_dispatch"].default is True
        assert defs["actor_p2p"].default is True
        assert defs["control_ring"].default is True
        assert defs["resview_gossip_s"].default == 1.0


class TestKnobsOffWireShape:
    """``local_dispatch=False`` must put the exact pre-change bytes on
    the wire: no has_refs / arg_refs keys in the submit blob."""

    def test_unmarked_spec_blob_has_no_two_level_keys(self):
        import cloudpickle

        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.runtime.worker_process import _dump_spec
        from ray_tpu_torch._private.task_spec import TaskSpec

        spec = TaskSpec(task_id=TaskID(b"\x05" * 16), name="leaf",
                        func=None, func_descriptor="leaf",
                        args=(1, 2), kwargs={},
                        serialized_func=b"\x80\x04N.")
        d = cloudpickle.loads(_dump_spec(spec, mark_refs=False))
        assert "has_refs" not in d
        assert "arg_refs" not in d

        # ...while the marked blob carries exactly the admission keys
        d2 = cloudpickle.loads(_dump_spec(spec, mark_refs=True))
        assert d2["has_refs"] is False
        assert "arg_refs" not in d2  # no refs -> key elided

    def test_marked_spec_blob_lists_arg_ref_ids(self):
        import cloudpickle

        from ray_tpu_torch._private.ids import ObjectID, TaskID
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.runtime.worker_process import _dump_spec
        from ray_tpu_torch._private.task_spec import TaskSpec

        ref = ObjectRef(ObjectID(b"\x09" * 20), None, _register=False)
        spec = TaskSpec(task_id=TaskID(b"\x06" * 16), name="leaf",
                        func=None, func_descriptor="leaf",
                        args=(ref,), kwargs={},
                        serialized_func=b"\x80\x04N.")
        d = cloudpickle.loads(_dump_spec(spec, mark_refs=True))
        assert d["has_refs"] is True
        assert d["arg_refs"] == [b"\x09" * 20]


@pytest.fixture
def default_config_ray():
    """A 2-remote-node cluster with NO two-level knob overrides: this
    is exactly what a user gets out of the box."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                 _system_config={"sched_device": "cpu",
                                 "worker_mode": "process"})
    w = worker_mod.get_worker()
    w.add_remote_cluster_node(num_cpus=4.0, num_workers=3,
                              resources={"a": 4})
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"b": 2})
    yield w
    chaos.disarm()
    ray_tpu_torch.shutdown()


class TestDefaultConfigHeadSkip:
    def test_steady_state_head_skip_at_least_90pct(
            self, default_config_ray):
        """The acceptance bar: >= 90% of worker-submitted tasks admit
        on their node under the DEFAULT config. The submit mix
        deliberately includes the two previously-spilling shapes —
        retry-carrying tasks (default task_max_retries=3) and
        ref-carrying args resident on the node."""
        w = default_config_ray

        @ray_tpu_torch.remote  # default max_retries: retry-carrying
        def leaf(x):
            return x + 1

        @ray_tpu_torch.remote
        def ref_leaf(blob):
            return len(blob)

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def driver(n):
            import ray_tpu_torch
            # over inline_object_max_bytes: sealed into THIS node's
            # arena, so the daemon's residency check sees it directly
            data = ray_tpu_torch.put(b"x" * (256 * 1024))
            plain = sum(ray_tpu_torch.get(
                [leaf.remote(i) for i in range(n)], timeout=60.0))
            withref = sum(ray_tpu_torch.get(
                [ref_leaf.remote(data) for _ in range(n)], timeout=60.0))
            return plain, withref

        n = 10
        plain, withref = ray_tpu_torch.get(driver.remote(n), timeout=120.0)
        assert plain == sum(range(n)) + n
        assert withref == 256 * 1024 * n

        def settled():
            s = w.two_level_stats
            return s if s["local_dispatch"] + s["spillback"] >= 2 * n \
                else None

        stats = _poll(settled)
        assert stats, w.two_level_stats
        ld, sb = stats["local_dispatch"], stats["spillback"]
        assert ld / (ld + sb) >= 0.9, (
            f"head-skip {ld}/{ld + sb} below 90%: {stats}")


_CRASH_ONCE_SRC = """
def crash_once(key, path):
    import hashlib, os
    attempt_mark = path + "." + key + ".attempts"
    fd = os.open(attempt_mark, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, b"a\\n")
    finally:
        os.close(fd)
    with open(attempt_mark) as fh:
        attempts = len(fh.read().split())
    if attempts == 1:
        os._exit(1)  # first attempt: die mid-task, no completion
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\\n").encode())
    finally:
        os.close(fd)
    return hashlib.sha256(key.encode()).hexdigest()
"""


def _load_crash_once():
    ns: dict = {}
    exec(_CRASH_ONCE_SRC, ns)
    return ns["crash_once"]


class TestLocalRetry:
    def test_dead_worker_lease_retries_locally_exactly_once(
            self, default_config_ray, tmp_path):
        """Tentpole gap (a): a locally-dispatched retry-carrying task
        whose worker dies re-leases on a SIBLING worker of the same
        node — the head sees a ("local_retry", ...) receipt, not a
        spill — and the side-effect file proves single completion."""
        import hashlib

        w = default_config_ray
        marks = str(tmp_path / "marks")
        crash_once = _load_crash_once()

        inner = ray_tpu_torch.remote(crash_once).options(max_retries=2)

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def driver(key, path):
            import ray_tpu_torch
            return ray_tpu_torch.get(inner.remote(key, path), timeout=90.0)

        val = ray_tpu_torch.get(driver.remote("lr-0", marks), timeout=120.0)
        assert val == hashlib.sha256(b"lr-0").hexdigest()
        with open(marks) as fh:
            assert fh.read().split() == ["lr-0"]  # exactly once
        with open(marks + ".lr-0.attempts") as fh:
            assert len(fh.read().split()) == 2  # crash + success

        # the retry stayed on the node: per-attempt accounting rode the
        # daemon's local_retry receipt, not a head re-dispatch
        assert _poll(
            lambda: w.two_level_stats.get("local_retry", 0) >= 1), \
            w.two_level_stats


class TestSpillReasonSurfacing:
    def test_list_nodes_carries_spill_reasons_and_resview_age(
            self, default_config_ray):
        """Satellite: per-node spill accounting. A nested submit whose
        demand cannot fit the submitting node must spill with reason
        'resources', visible per-node via state.list_nodes alongside
        the node's resource-view age."""
        w = default_config_ray

        @ray_tpu_torch.remote(resources={"b": 1.0})
        def elsewhere():
            return 7

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def driver():
            import ray_tpu_torch
            return ray_tpu_torch.get(elsewhere.remote(), timeout=60.0)

        assert ray_tpu_torch.get(driver.remote(), timeout=120.0) == 7

        def spilled_rows():
            rows = [r for r in state.list_nodes()
                    if r["kind"] == "remote"]
            return rows if any(r.get("spill_reasons")
                               for r in rows) else None

        rows = _poll(spilled_rows)
        assert rows, "no remote node surfaced spill_reasons"
        reasons = {}
        for r in rows:
            assert "spill_reasons" in r and "resview_age_s" in r
            if r["resview_age_s"] is not None:
                assert r["resview_age_s"] >= 0.0
            for k, v in r["spill_reasons"].items():
                reasons[k] = reasons.get(k, 0) + v
        assert reasons.get("resources", 0) >= 1, reasons

        # the same counters aggregate into the labeled metric series
        from ray_tpu_torch._private import metrics as metrics_mod
        lines = metrics_mod._render_core(w)
        series = [ln for ln in lines if ln.startswith(
            'ray_tpu_sched_spillback_total{reason="resources"}')]
        assert series and series[0].split()[-1] not in ("0", "0.0"), \
            series


@pytest.fixture
def soak_ray():
    """Default two-level knobs (the point: dispatch decentralizes out
    of the box) but 1-core-host-friendly liveness budgets: the link
    blackout plus 5 worker processes can hold rejoin past the 0.6s
    probe window / 5s heartbeat default and turn a chaos drill into a
    node death the drill never intended."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                 _system_config={"worker_mode": "process",
                                 "sched_device": "cpu",
                                 "node_heartbeat_timeout_s": 20.0,
                                 "health_check_timeout_s": 5.0})
    w = worker_mod.get_worker()
    w.add_remote_cluster_node(num_cpus=4.0, num_workers=3,
                              resources={"a": 4})
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"b": 2})
    yield w
    chaos.disarm()
    ray_tpu_torch.shutdown()


@pytest.mark.chaos
class TestCombinedChaosSoak:
    def test_sever_and_head_blackout_with_local_retries(
            self, soak_ray, tmp_path):
        """The combined drill: seeded ``peer_link`` severs (dropping
        lanes that now also carry resview gossip) plus a ``head`` link
        blackout, while retry-carrying tasks dispatch locally and one
        of them crashes its worker mid-task. Outbox sequencing +
        journaled local leases must keep every completion exactly-once
        and bit-correct; the local retry must survive the blackout."""
        import hashlib

        w = soak_ray
        marks = str(tmp_path / "marks")
        crash_once = _load_crash_once()

        @ray_tpu_torch.remote(resources={"b": 1.0})
        class Acc:
            def __init__(self):
                self.total = 0

            def bump(self, x):
                self.total += x
                return self.total

        actor = Acc.remote()
        ray_tpu_torch.get(actor.bump.remote(0), timeout=60.0)  # placed

        # armed AFTER actor placement so every arrival lands on
        # steady-state traffic; the leaves sleep so the faults fire
        # while work is genuinely in flight (an idle-cluster flap
        # drills nothing)
        chaos.arm(chaos.FaultPlan(4242, faults=[
            ("peer_link", 2, "sever"),
            ("head", 12, "flap"),
            ("peer_link", 6, "sever")]))
        time.sleep(1.2)  # plan reaches the daemons via the resview push

        crashing = ray_tpu_torch.remote(crash_once).options(max_retries=2)

        @ray_tpu_torch.remote  # default retries: every leaf carries them
        def leaf(key, path):
            import hashlib as h
            import os
            import time as t
            t.sleep(0.25)
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
            try:
                os.write(fd, (key + "\n").encode())
            finally:
                os.close(fd)
            return h.sha256(key.encode()).hexdigest()

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def driver(h, path, n):
            import ray_tpu_torch
            out = [ray_tpu_torch.get(crashing.remote("boom", path),
                               timeout=120.0)]
            bumps = 0
            for i in range(n):
                bumps = ray_tpu_torch.get(h.bump.remote(1), timeout=120.0)
                out.append(ray_tpu_torch.get(
                    leaf.remote(f"soak-{i}", path), timeout=120.0))
            return out, bumps

        n = 8
        vals, bumps = ray_tpu_torch.get(driver.remote(actor, marks, n),
                                  timeout=300.0)
        chaos.disarm()

        keys = ["boom"] + [f"soak-{i}" for i in range(n)]
        expected = [hashlib.sha256(k.encode()).hexdigest()
                    for k in keys]
        assert vals == expected, "results not bit-correct under chaos"
        # the accumulator is the p2p exactly-once proof: a lost or
        # double-applied bump (severed lane -> head fallback replay)
        # both break it
        assert bumps == n, f"p2p bumps not exactly-once: {bumps}"
        with open(marks) as fh:
            lines = sorted(fh.read().split())
        assert lines == sorted(keys), (
            f"completions not exactly-once: {lines}")

        ctr = chaos.counters()
        assert ctr["injected"].get("peer_link", 0) >= 1, ctr
        assert ctr["injected"].get("head", 0) >= 1, ctr
        # the crashing task recovered through the LOCAL retry path
        assert _poll(
            lambda: w.two_level_stats.get("local_retry", 0) >= 1), \
            w.two_level_stats


# the knobs the multi-node plane and the client bring, with the
# reference's defaults
NEW_KNOBS = ("local_dispatch", "actor_p2p", "scheduler_locality",
             "locality_spillback_queue_depth", "local_queue_depth",
             "resview_gossip_s", "object_transfer_timeout_s",
             "daemon_rejoin_timeout_s", "daemon_rejoin_grace_s",
             "client_reconnect_timeout_s")


@pytest.mark.parametrize("knob", NEW_KNOBS)
def test_new_knob_default_matches_reference(knob):
    from ray_tpu._private.config import GLOBAL_CONFIG as REF_CONFIG

    port = GLOBAL_CONFIG._entries[knob]
    ref = REF_CONFIG._entries[knob]
    assert port.default == ref.default
    assert type(port.default) is type(ref.default)
