"""The port's QoS plane: the cases of ``tests/test_qos.py`` on
``ray_tpu_torch``, with its deterministic parts held to the reference's
exactly, and the slice's completion order against the reference's run.

Parity with the reference (``ray_tpu._private.qos``), exact:
``parse_tenant_quotas`` (the same weights, the same errors);
``QosPlane.order`` over seeded (tier, tenant) sequences with persistent
served counters across drains; ``check_preempt`` over a scripted clock
(the same victims at the same ticks); ``stats``.

The slice as a whole: one worker held by a gate, 12 prod tasks (tier 1,
weight 3) and 12 batch tasks (tier 0, weight 1) submitted in a seeded
order, then the gate opens: the completion order of the port's run
equals the reference's run of the same script, exactly.

The reference's preemption test bounds the starved tier's latency by the
wall clock (under 2.9 s), which fails on a loaded host. Here the
contract is proved by order alone: the victim sleeps until a gate that
opens only after the preempting task's result has arrived, so that
result can only have come from the kill; each key is marked once, the
preempting task's first.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import qos as ref_qos
from ray_tpu_torch import chaos
from ray_tpu_torch._private import metrics as metrics_mod
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.qos import QosPlane, parse_tenant_quotas
from ray_tpu_torch.util import state

CPU = {"sched_device": "cpu"}


def _poll(fn, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    return fn()


def _read_marks(path):
    try:
        with open(path) as fh:
            return fh.read().split()
    except FileNotFoundError:
        return []


# leaves defined from SOURCE and exec'd so remote-node workers (which
# cannot import the test module) get them as cloudpickle blobs. ``mark``
# sleeps BEFORE its mark, so a killed attempt leaves no trace; ``gated``
# waits for a gate file before its mark
_MARK_SRC = """
def mark(key, path, sleep_s):
    import os
    import time
    time.sleep(sleep_s)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\\n").encode())
    finally:
        os.close(fd)
    return key


def gated(key, path, gate):
    import os
    import time
    while not os.path.exists(gate):
        time.sleep(0.01)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\\n").encode())
    finally:
        os.close(fd)
    return key
"""


def _load(name="mark"):
    ns: dict = {}
    exec(_MARK_SRC, ns)
    return ns[name]


# ----------------------------------------------------------------------
# parity with the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    "", '{"p": 2}', '{"prod": 3, "batch": 1}', '{"a": "2.5", "b": 1e-3}',
    "not json", '["p"]', '{"p": 0}', '{"p": -1}', '{"p": "fast"}',
    '{"p": null}', "[]", "3"])
def test_parse_tenant_quotas_equals_the_reference(raw):
    def run(fn):
        try:
            return ("ok", fn(raw))
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(parse_tenant_quotas) == run(ref_qos.parse_tenant_quotas)


def _drain_script(seed, n_drains=6):
    """Seeded drains over three tenants and three tiers: each drain a
    list of (tier, tenant) keys; between drains a seeded share of the
    order's head is dispatched."""
    rng = np.random.default_rng(seed)
    tenants = ["prod", "batch", "default"]
    out = []
    for _ in range(n_drains):
        n = int(rng.integers(1, 40))
        keys = [(int(rng.integers(0, 3)),
                 tenants[int(rng.integers(0, 3))]) for _ in range(n)]
        out.append((keys, int(rng.integers(0, n + 1))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_order_equals_the_reference(seed):
    """The same drains through both planes (persistent served counters
    advanced by the dispatches between drains): the same permutations."""
    quotas = '{"prod": 3, "batch": 1}'
    ours, ref = QosPlane(quotas), ref_qos.QosPlane(quotas)
    uid = 0
    for keys, n_dispatch in _drain_script(seed):
        ids = []
        for tier, tenant in keys:
            ours.note_queued(uid, tenant, tier)
            ref.note_queued(uid, tenant, tier)
            ids.append(uid)
            uid += 1
        got, want = ours.order(keys), ref.order(keys)
        assert got == want
        for i in got[:n_dispatch]:
            ours.note_dispatched(ids[i])
            ref.note_dispatched(ids[i])
        assert ours.stats() == ref.stats()
        assert ours.top_queued_tier() == ref.top_queued_tier()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("grace", [0.0, 0.3, 1.0])
def test_check_preempt_equals_the_reference(seed, grace):
    """A scripted clock and a seeded event stream (queue, dispatch,
    done, rekey at mixed tiers): check_preempt gives the same victim (or
    none) at every tick in both planes, and the same stats after."""
    rng = np.random.default_rng(seed)
    ours, ref = QosPlane("", grace), ref_qos.QosPlane("", grace)
    now, uid = 100.0, 0
    live = {"q": [], "r": []}
    for _ in range(300):
        now += float(rng.choice([0.05, 0.1, 0.25]))
        ev = int(rng.integers(0, 5))
        if ev == 0 or not (live["q"] or live["r"]):
            tier = int(rng.integers(0, 4))
            tenant = ("a", "b")[int(rng.integers(0, 2))]
            for p in (ours, ref):
                p.note_queued(uid, tenant, tier)
            live["q"].append(uid)
            uid += 1
        elif ev == 1 and live["q"]:
            t = live["q"].pop(int(rng.integers(0, len(live["q"]))))
            for p in (ours, ref):
                p.note_dispatched(t)
            live["r"].append(t)
        elif ev == 2 and live["r"]:
            t = live["r"].pop(int(rng.integers(0, len(live["r"]))))
            for p in (ours, ref):
                p.note_done(t)
        elif ev == 3 and live["r"]:
            t = live["r"].pop(int(rng.integers(0, len(live["r"]))))
            for p in (ours, ref):
                p.note_rekeyed(t, uid)
            live["q"].append(uid)
            uid += 1
        got, want = ours.check_preempt(now), ref.check_preempt(now)
        assert got == want, (now, got, want)
        if got is not None:
            for p in (ours, ref):
                p.note_preempted(got[1], got[2])
    assert ours.stats() == ref.stats()


# the slice's completion-order script, run through either package
_ORDER_KEYS = [(f"prod-{i}", 1, "prod") for i in range(12)] + [
    (f"batch-{i}", 0, "batch") for i in range(12)]


def _completion_order(ray, tmp_path, extra_cfg):
    order = np.random.default_rng(7).permutation(len(_ORDER_KEYS))
    keys = [_ORDER_KEYS[i] for i in order]
    gate, marks = str(tmp_path / "gate"), str(tmp_path / "marks")
    ray.shutdown()
    ray.init(num_cpus=1, num_workers=1, scheduler="tensor",
             _system_config=dict(extra_cfg, qos=True,
                                 tenant_quotas='{"prod": 3, "batch": 1}'))
    try:
        hold = ray.remote(_load("gated")).options(tenant="hold", priority=9)
        mark = ray.remote(_load("mark"))
        h = hold.remote("hold", marks, gate)
        w = ray._worker.get_worker()
        assert _poll(lambda: any(r["state"] == "RUNNING"
                                 for r in w.scheduler.task_table()))
        refs = [mark.options(priority=tier, tenant=tenant).remote(
            key, marks, 0.0) for key, tier, tenant in keys]
        time.sleep(0.3)
        open(gate, "w").close()
        ray.get([h] + refs, timeout=120)
    finally:
        ray.shutdown()
    return _read_marks(marks)


def test_slice_completion_order_equals_the_reference(tmp_path):
    """Thread mode, one worker held by a gate: 12 prod (tier 1, weight 3)
    and 12 batch (tier 0, weight 1) in a seeded order. The port's
    completion order equals the reference's, exactly, and it is strict
    by tier (every prod before every batch)."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _completion_order(ray_tpu, tmp_path / "ref", {})
    got = _completion_order(ray_tpu_torch, tmp_path / "port", CPU)
    assert got == want
    assert got[0] == "hold"
    assert [k.split("-")[0] for k in got[1:]] == ["prod"] * 12 + [
        "batch"] * 12


class TestFairShareMath:
    """Unit-level: the plane's deficit round-robin and quota parsing."""

    def test_order_strict_tiers_then_weighted_share(self):
        plane = QosPlane(tenant_quotas='{"a": 3, "b": 1}')
        keys = []
        for _ in range(12):
            keys.append((0, "b"))
            keys.append((0, "a"))
        keys.append((2, "c"))
        order = plane.order(keys)
        assert sorted(order) == list(range(len(keys)))
        ordered = [keys[i] for i in order]
        assert ordered[0] == (2, "c")
        tail = ordered[1:]
        for n in range(8, 17):
            na = sum(1 for t in tail[:n] if t[1] == "a")
            assert na >= 2 * (n - na), (n, tail[:n])
        assert all(t == (0, "b") for t in ordered[-8:]), ordered[-8:]

    def test_share_converges_across_drains(self):
        plane = QosPlane(tenant_quotas='{"a": 1, "b": 1}')
        for i in range(4):
            plane.note_queued(("a", i), "a", 0)
        for i in plane.order([(0, "a")] * 4):
            plane.note_dispatched(("a", i))
        keys = [(0, "a")] * 4 + [(0, "b")] * 4
        ordered = [keys[i] for i in plane.order(keys)]
        assert ordered[:4] == [(0, "b")] * 4, ordered

    def test_quota_parse_rejects_bad_values(self):
        assert parse_tenant_quotas("") == {}
        assert parse_tenant_quotas('{"p": 2}') == {"p": 2.0}
        for bad in ("not json", '["p"]', '{"p": 0}', '{"p": "fast"}'):
            with pytest.raises(ValueError):
                parse_tenant_quotas(bad)

    def test_watermark_tracks_top_queued_tier(self):
        plane = QosPlane()
        assert plane.top_queued_tier() is None
        plane.note_queued("t1", "a", 0)
        plane.note_queued("t2", "a", 5)
        assert plane.top_queued_tier() == 5
        plane.note_dispatched("t2")
        assert plane.top_queued_tier() == 0
        plane.note_done("t1")
        assert plane.top_queued_tier() is None

    def test_init_refuses_bad_quotas_before_anything_starts(self):
        ray_tpu_torch.shutdown()
        with pytest.raises(ValueError, match="tenant_quotas"):
            ray_tpu_torch.init(num_workers=1, _system_config=dict(
                CPU, qos=True, tenant_quotas='{"p": 0}'))
        assert not ray_tpu_torch.is_initialized()
        ray_tpu_torch.shutdown()


class TestFairShareConvergence:
    def test_two_saturating_tenants_interleave_by_weight(self, tmp_path):
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=1, _system_config=dict(
            CPU, qos=True, tenant_quotas='{"a": 3.0, "b": 1.0}'))
        marks = str(tmp_path / "marks")
        try:
            w = worker_mod.get_worker()
            assert w.qos_plane is not None
            mark = ray_tpu_torch.remote(_load())
            a = mark.options(tenant="a")
            b = mark.options(tenant="b")
            refs = []
            for i in range(12):
                refs.append(b.remote(f"b{i}", marks, 0.03))
                refs.append(a.remote(f"a{i}", marks, 0.03))
            ray_tpu_torch.get(refs, timeout=120.0)

            ks = _read_marks(marks)
            assert len(ks) == 24
            mid = ks[4:16]
            assert sum(1 for k in mid if k.startswith("a")) >= 7, ks
            assert any(k.startswith("b") for k in ks[:16]), ks
            assert all(k.startswith("b") for k in ks[-4:]), ks

            rows = {r["tenant"]: r for r in state.list_tenants()}
            assert rows["a"]["weight"] == 3.0
            assert rows["b"]["weight"] == 1.0
            assert rows["a"]["served"] == 12
            assert rows["b"]["served"] == 12
            assert rows["a"]["queued"] == rows["b"]["queued"] == 0
            assert rows["a"]["running"] == rows["b"]["running"] == 0

            text = "\n".join(metrics_mod._render_core(w))
            assert 'ray_tpu_tenant_queued_tasks{tenant="a"} 0' in text
            assert 'ray_tpu_tenant_running_tasks{tenant="b"} 0' in text
            assert 'ray_tpu_fairshare_deficit{tenant="a"}' in text
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture
def preempt_ray():
    """One process-mode slot, fast grace: a queued higher tier starves
    at once and the kill is a real process kill."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=1, _system_config=dict(
        CPU, worker_mode="process", qos=True, preempt_grace_s=0.3))
    yield worker_mod.get_worker()
    ray_tpu_torch.shutdown()


class TestPreemption:
    def test_preempt_is_exactly_once_and_within_grace(self, preempt_ray,
                                                      tmp_path):
        """A tier-5 task under a tier-0 task that holds the only slot
        until a gate opens: the tier-5 result arrives while the gate is
        still closed (so its slot came from the kill); then the gate
        opens and the victim's retry completes under its original
        return id. One mark per key, the tier-5 key first."""
        w = preempt_ray
        marks, gate = str(tmp_path / "marks"), str(tmp_path / "gate")
        lo = ray_tpu_torch.remote(_load("gated")).options(tenant="batch")
        hi = ray_tpu_torch.remote(_load()).options(priority=5,
                                                  tenant="prod")

        lo_ref = lo.remote("lo-0", marks, gate)
        assert _poll(lambda: any(
            r["tenant"] == "batch" and r["running"] >= 1
            for r in state.list_tenants())), state.list_tenants()

        hi_ref = hi.remote("hi-0", marks, 0.0)
        assert ray_tpu_torch.get(hi_ref, timeout=60.0) == "hi-0"
        assert not os.path.exists(gate)
        assert _read_marks(marks) == ["hi-0"]
        open(gate, "w").close()

        assert ray_tpu_torch.get(lo_ref, timeout=60.0) == "lo-0"
        ks = _read_marks(marks)
        assert ks == ["hi-0", "lo-0"], f"lost or double-executed: {ks}"

        st = w.qos_plane.stats()
        assert st["preemptions_total"] >= 1, st
        assert st["preempts_by_tier"].get(0, 0) >= 1, st
        rows = {r["tenant"]: r for r in state.list_tenants()}
        assert rows["batch"]["preempted"] >= 1, rows

        text = "\n".join(metrics_mod._render_core(w))
        assert "ray_tpu_sched_preemptions_total " in text
        assert 'ray_tpu_sched_preemptions_total{tier="0"}' in text

    def test_no_preemption_without_starvation(self, preempt_ray,
                                              tmp_path):
        w = preempt_ray
        marks = str(tmp_path / "marks")
        f = ray_tpu_torch.remote(_load())
        refs = [f.remote(f"k{i}", marks, 0.1) for i in range(4)]
        assert sorted(ray_tpu_torch.get(refs, timeout=60.0)) == \
            [f"k{i}" for i in range(4)]
        assert w.qos_plane.stats()["preemptions_total"] == 0
        assert sorted(_read_marks(marks)) == [f"k{i}" for i in range(4)]


class TestLocalAdmissionWatermark:
    def test_low_tier_nested_submit_spills_on_tier(self):
        """With tier-5 work queued (infeasible) at the head, the resview
        watermark reaches the node daemons and a tier-0 nested
        submission spills upward with reason "tier"."""
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2, _system_config=dict(
            CPU, worker_mode="process", qos=True, preempt_grace_s=300.0))
        try:
            w = worker_mod.get_worker()
            w.add_remote_cluster_node(num_cpus=2.0, num_workers=2,
                                      resources={"a": 2})

            @ray_tpu_torch.remote(priority=5, tenant="prod",
                                  resources={"zz": 1.0})
            def starved():
                return "never"

            @ray_tpu_torch.remote(max_retries=0)
            def leaf(x):
                return x + 1

            @ray_tpu_torch.remote(resources={"a": 1.0})
            def caller(n):
                import ray_tpu_torch
                return ray_tpu_torch.get(
                    [leaf.remote(i) for i in range(n)], timeout=60.0)

            starved_ref = starved.remote()
            assert _poll(lambda: w.qos_plane.top_queued_tier() == 5)
            time.sleep(1.2)  # the watermark rides the 0.5 s resview push

            assert ray_tpu_torch.get(caller.remote(4),
                                     timeout=120.0) == [1, 2, 3, 4]
            assert _poll(lambda: w.two_level_stats.get(
                "spillback:tier", 0) >= 1), w.two_level_stats

            text = "\n".join(metrics_mod._render_core(w))
            line = [ln for ln in text.splitlines() if
                    ln.startswith('ray_tpu_sched_spillback_total'
                                  '{reason="tier"}')]
            assert line and int(line[0].split()[-1]) >= 1, line
            del starved_ref
        finally:
            ray_tpu_torch.shutdown()


class TestGangAtomicScaleup:
    def test_whole_gang_provisioned_atomically(self):
        """Under qos, the gang-aware autoscaler provisions both nodes a
        pending STRICT_SPREAD group needs in one decision; no observable
        state shows a partial placement."""
        from ray_tpu_torch.autoscaler import (GangAutoscaler,
                                              GangAutoscalerConfig,
                                              VirtualNodeProvider)
        from ray_tpu_torch.util.placement_group import (
            placement_group, placement_group_table)

        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=1, num_workers=2,
                           _system_config=dict(CPU, qos=True))
        try:
            w = worker_mod.get_worker()
            assert w.qos_plane is not None
            provider = VirtualNodeProvider(w, num_cpus=4, num_workers=2)
            scaler = GangAutoscaler(w, provider, GangAutoscalerConfig(
                min_nodes=0, max_nodes=2, upscale_ticks=3,
                idle_timeout_s=60.0, poll_interval_s=0.1))
            scaler.start()
            assert w.placement_groups.hold_infeasible is True

            pg = placement_group([{"CPU": 2}, {"CPU": 2}],
                                 strategy="STRICT_SPREAD",
                                 name="gang", priority=1)
            ready = pg.ready()
            deadline = time.monotonic() + 60.0
            created = False
            while time.monotonic() < deadline and not created:
                row = placement_group_table()[pg.id.hex()]
                placed = len(row["bundle_rows"])
                assert placed in (0, 2), row
                assert (row["state"] == "CREATED") == (placed == 2), row
                created = row["state"] == "CREATED"
                time.sleep(0.02)
            assert created, placement_group_table()
            ray_tpu_torch.get(ready, timeout=10.0)

            row = placement_group_table()[pg.id.hex()]
            assert row["priority"] == 1
            assert len(set(row["bundle_rows"])) == 2, row
            assert scaler.num_gang_upscales >= 1
            assert scaler.stats()["gang_upscales"] >= 1
            assert scaler.stats()["provider_nodes"] == 2

            @ray_tpu_torch.remote(num_cpus=2, placement_group=pg)
            def inside():
                return 7

            assert ray_tpu_torch.get(inside.remote(), timeout=60.0) == 7
            scaler.stop()
            assert w.placement_groups.hold_infeasible is False
        finally:
            ray_tpu_torch.shutdown()


@pytest.mark.chaos
class TestQosChaosSoak:
    def test_preemptions_under_node_kill_and_link_sever(self, tmp_path):
        """Tier-0 sleepers saturate a 3-node cluster, tier-5 work starves
        and preemptions fire; the chaos ``node`` site then kills a remote
        node and a ``peer_link`` sever is armed while retries and kills
        are in flight. Every logical key is marked exactly once."""
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2, _system_config=dict(
            CPU, worker_mode="process", qos=True, preempt_grace_s=0.3,
            node_heartbeat_timeout_s=20.0, health_check_timeout_s=5.0))
        marks = str(tmp_path / "marks")
        try:
            w = worker_mod.get_worker()
            ea = w.add_remote_cluster_node(num_cpus=3.0, num_workers=3,
                                           resources={"a": 4})
            w.add_remote_cluster_node(num_cpus=1.0, num_workers=1,
                                      resources={"b": 2})
            mark = _load()
            lo = ray_tpu_torch.remote(mark).options(tenant="batch",
                                                    max_retries=4)
            hi = ray_tpu_torch.remote(mark).options(priority=5,
                                                    tenant="prod",
                                                    max_retries=4)
            lo_keys = [f"lo-{i}" for i in range(6)]
            lo_refs = [lo.remote(k, marks, 4.0) for k in lo_keys]
            assert _poll(lambda: any(
                r["tenant"] == "batch" and r["running"] >= 4
                for r in state.list_tenants()), timeout=60.0), \
                state.list_tenants()

            hi_keys = [f"hi-{i}" for i in range(2)]
            hi_refs = [hi.remote(k, marks, 0.2) for k in hi_keys]
            assert _poll(lambda: w.qos_plane.stats()
                         ["preemptions_total"] >= 1, timeout=30.0), \
                w.qos_plane.stats()

            chaos.arm(chaos.FaultPlan(4471, faults=[
                ("node", 2, "kill", {"node": ea.index}),
                ("peer_link", 1, "sever")]))
            hi2_keys = [f"hi2-{i}" for i in range(3)]
            hi_refs += [hi.remote(k, marks, 0.2) for k in hi2_keys]
            hi_keys += hi2_keys

            assert sorted(ray_tpu_torch.get(hi_refs, timeout=180.0)) == \
                sorted(hi_keys)
            assert sorted(ray_tpu_torch.get(lo_refs, timeout=240.0)) == \
                sorted(lo_keys)
            chaos.disarm()

            ks = _read_marks(marks)
            assert sorted(ks) == sorted(lo_keys + hi_keys), ks
            assert w.qos_plane.stats()["preemptions_total"] >= 1
            assert chaos.counters()["injected"].get("node", 0) >= 1
        finally:
            chaos.disarm()
            ray_tpu_torch.shutdown()


class TestKnobsOff:
    def test_qos_false_is_inert(self):
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2, _system_config=CPU)
        try:
            w = worker_mod.get_worker()
            assert w.qos_plane is None
            assert w.scheduler.qos_plane is None
            assert not any(t.name == "ray_tpu_qos"
                           for t in __import__("threading").enumerate())

            @ray_tpu_torch.remote(priority=5, tenant="prod")
            def f(x):
                return x * 2

            assert ray_tpu_torch.get([f.remote(i) for i in range(4)],
                                     timeout=60.0) == [0, 2, 4, 6]
            assert state.list_tenants() == []

            text = "\n".join(metrics_mod._render_core(w))
            for fam in ("ray_tpu_sched_preemptions_total",
                        "ray_tpu_tenant_queued_tasks",
                        "ray_tpu_tenant_running_tasks",
                        "ray_tpu_fairshare_deficit"):
                vals = [ln for ln in text.splitlines()
                        if ln.startswith(fam + " ")
                        or ln.startswith(fam + "{")]
                assert vals, f"{fam} missing from /metrics render"
                assert all(ln.split()[-1] in ("0", "0.0") for ln in vals)
                assert all("{" not in ln for ln in vals), vals
            assert 'reason="tier"} 0' in text
        finally:
            ray_tpu_torch.shutdown()

    def test_default_submit_blob_has_no_qos_keys(self):
        import cloudpickle

        from ray_tpu_torch._private.ids import JobID, TaskID
        from ray_tpu_torch._private.runtime.worker_process import _dump_spec
        from ray_tpu_torch._private.task_spec import TaskSpec, TaskType

        def fn(x):
            return x

        def mk(**kw):
            return TaskSpec(
                task_id=TaskID.of(JobID.from_int(7)),
                task_type=TaskType.NORMAL_TASK, name="fn",
                func=fn, func_descriptor="tests.fn", args=(1,),
                kwargs={}, num_returns=1, resources={"CPU": 1.0}, **kw)

        d0 = cloudpickle.loads(_dump_spec(mk()))
        assert "priority" not in d0 and "tenant" not in d0, sorted(d0)
        d1 = cloudpickle.loads(_dump_spec(mk(priority=3, tenant="p")))
        assert d1["priority"] == 3 and d1["tenant"] == "p"
        assert set(d1) - set(d0) == {"priority", "tenant"}, sorted(d1)


def test_qos_ab_arms_run_the_same_work():
    """perf.qos_ab (the reference's A/B of the plane) at a small size:
    both arms finish the same tasks (equal totals); only the on arm has
    the plane. Times are this host's and are not compared."""
    from ray_tpu_torch._private import perf

    off = perf.qos_ab(False, n_per_tenant=6, n_submit=4, system_config=CPU)
    on = perf.qos_ab(True, n_per_tenant=6, n_submit=4, system_config=CPU)
    assert off["total"] == on["total"] == 2 * sum(range(6))
    assert off["mode"] == "off" and on["mode"] == "on"
    assert off["n_submit"] == on["n_submit"] == 4
    assert set(off) == set(on)
