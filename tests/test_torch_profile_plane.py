"""The port's profile plane: the cases of ``tests/test_profile_plane.py``
on ``ray_tpu_torch``, and its deterministic functions held to the
reference's on the same inputs, exactly.

The reference's ``test_profile_overhead_within_10_percent`` is a
wall-clock guard (profiled throughput within 10% of unprofiled) that
fails under a loaded host; its counterpart here is no tier-1 guard:
``perf.qos_ab`` and phase ``ops`` of ``chip_smoke.py`` time the planes
on the card's host. What the guard's run also shows, that a profiled
process-mode runtime finishes its tasks with samples recorded, is
checked here without a clock.

Parity with the reference, on seeded synthetic stacks and samples:
``fold_stack``, ``collapsed``, ``top_tasks``, ``speedscope`` and
``flamegraph_report`` byte-equal (JSON dumps), ``UtilizationRing``'s
downsampling and rows equal, ``ProfilePlane``'s stack table (counts,
eviction) equal.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu._private import profile_plane as ref_pp
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.profile_plane import (CpuPercent, ProfilePlane,
                                                  ResourceSampler,
                                                  StackSampler,
                                                  UtilizationRing, collapsed,
                                                  flamegraph_report,
                                                  fold_stack, read_meminfo,
                                                  read_proc_stat,
                                                  read_self_rss, speedscope,
                                                  top_tasks)
from ray_tpu_torch.util import state

ON_LINUX = os.path.exists("/proc/stat")
CPU = {"sched_device": "cpu"}


def _poll(fn, timeout=30.0, interval=0.1):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out or time.monotonic() >= deadline:
            return out
        time.sleep(interval)


def _burn(seconds):
    end = time.time() + seconds
    x = 0
    while time.time() < end:
        x += 1
    return x


def _rows(seed, n=40):
    """Seeded synthetic profile_stacks rows: nodes 0-2, labels idle /
    thread names / "name:taskid8", stacks of 1-6 frames."""
    rng = np.random.default_rng(seed)
    frames = [f"mod{i}.fn{j}" for i in range(4) for j in range(5)]
    labels = ["idle", "MainThread", "ray_tpu_sched_tick"] + [
        f"task_{k}:{int(rng.integers(0, 2**32)):08x}" for k in range(5)]
    rows = []
    for _ in range(n):
        depth = int(rng.integers(1, 7))
        rows.append({"node": int(rng.integers(0, 3)),
                     "task": labels[int(rng.integers(0, len(labels)))],
                     "stack": ";".join(frames[int(i)] for i in
                                       rng.integers(0, len(frames), depth)),
                     "count": int(rng.integers(1, 500))})
    return rows


# ----------------------------------------------------------------------
# parity with the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_exports_equal_the_reference(seed):
    rows = _rows(seed)
    assert collapsed(rows) == ref_pp.collapsed(rows)
    assert json.dumps(top_tasks(rows)) == json.dumps(ref_pp.top_tasks(rows))
    assert json.dumps(top_tasks(rows, limit=3)) == json.dumps(
        ref_pp.top_tasks(rows, limit=3))
    assert json.dumps(speedscope(rows)) == json.dumps(
        ref_pp.speedscope(rows))
    assert json.dumps(flamegraph_report(rows)) == json.dumps(
        ref_pp.flamegraph_report(rows))


def test_fold_stack_equals_the_reference():
    def leaf():
        return fold_stack(sys._getframe()), ref_pp.fold_stack(
            sys._getframe())

    def mid():
        return leaf()

    ours, ref = mid()
    assert ours == ref
    assert ours.split(";")[-1].endswith(".leaf")


@pytest.mark.parametrize("seed", range(3))
def test_utilization_ring_downsamples_like_the_reference(seed):
    """The same samples, some closer than 0.8 x the interval, some past
    maxlen: the same rows, latest values and counters."""
    rng = np.random.default_rng(seed)
    ours, ref = UtilizationRing(0.5, 16), ref_pp.UtilizationRing(0.5, 16)
    ts = 1000.0
    for _ in range(200):
        ts += float(rng.choice([0.1, 0.3, 0.45, 0.6, 1.0]))
        node = int(rng.integers(0, 3))
        series = ("cpu_percent", "rss_bytes")[int(rng.integers(0, 2))]
        value = float(rng.normal())
        ours.record(node, series, ts, value)
        ref.record(node, series, ts, value)
    assert ours.rows() == ref.rows()
    assert ours.rows(node=1, series="rss_bytes") == ref.rows(
        node=1, series="rss_bytes")
    assert ours.latest() == ref.latest()
    assert (ours.points_recorded, ours.points_downsampled) == (
        ref.points_recorded, ref.points_downsampled)


@pytest.mark.parametrize("seed", range(3))
def test_stack_table_equals_the_reference(seed):
    """Seeded batches into a table of 16 stacks: the same rows (order
    included), evictions and summary."""
    rng = np.random.default_rng(seed)
    kw = dict(hz=10.0, interval_s=1.0, util_maxlen=8, max_stacks=16)
    ours, ref = ProfilePlane(**kw), ref_pp.ProfilePlane(**kw)
    for _ in range(30):
        node = int(rng.integers(0, 3))
        batch = {"samples": [(f"t{int(rng.integers(0, 6))}",
                              f"a;b{int(rng.integers(0, 8))}",
                              int(rng.integers(1, 9)))
                             for _ in range(int(rng.integers(1, 5)))],
                 "dropped": int(rng.integers(0, 3))}
        ours.record_batch(node, batch)
        ref.record_batch(node, batch)
    assert ours.profile_stacks() == ref.profile_stacks()
    assert ours.summary() == ref.summary()


# ----------------------------------------------------------------------
# /proc parsers (the one implementation memory_monitor also uses)
# ----------------------------------------------------------------------

class TestParsers:
    def test_read_meminfo_shape(self):
        used, total = read_meminfo()
        assert total >= 1
        assert 0 <= used <= total

    def test_host_memory_delegates_to_shared_parser(self):
        from ray_tpu_torch._private import memory_monitor
        used, total = memory_monitor.host_memory()
        assert (used, total) != (0, 0)
        assert total == read_meminfo()[1]

    @pytest.mark.skipif(not ON_LINUX, reason="needs /proc")
    def test_read_self_rss_positive(self):
        assert read_self_rss() > 0

    @pytest.mark.skipif(not ON_LINUX, reason="needs /proc")
    def test_proc_stat_and_cpu_percent(self):
        busy, total = read_proc_stat()
        assert 0 <= busy <= total
        cpu = CpuPercent()
        assert cpu.sample() >= 0.0
        _burn(0.05)
        assert 0.0 <= cpu.sample() <= 100.0

    def test_fold_stack_root_first(self):
        def inner():
            return fold_stack(sys._getframe())

        def outer():
            return inner()

        frames = outer().split(";")
        assert frames[-1].endswith(".inner")
        assert frames[-2].endswith(".outer")
        assert all("." in f for f in frames)


# ----------------------------------------------------------------------
# StackSampler units (in-process, no runtime)
# ----------------------------------------------------------------------

class TestStackSampler:
    def test_samples_main_thread_with_task_label(self):
        got = []
        s = StackSampler(hz=250.0, flush=lambda p: got.append(p),
                         label_fn=lambda: "mytask:abcd1234",
                         flush_interval_s=0.1)
        s.start()
        try:
            _burn(0.6)
        finally:
            s.stop()
            s._thread.join(timeout=5)
        assert s.samples_taken > 0
        samples = [t for p in got for t in p["samples"]]
        assert samples, got
        assert {lbl for lbl, _, _ in samples} == {"mytask:abcd1234"}
        assert any("_burn" in stack for _, stack, _ in samples)

    def test_all_threads_mode_labels_by_thread_name(self):
        got = []
        stop = threading.Event()
        t = threading.Thread(target=stop.wait, name="park_me",
                             daemon=True)
        t.start()
        s = StackSampler(hz=250.0, flush=lambda p: got.append(p),
                         all_threads=True, flush_interval_s=0.1)
        s.start()
        try:
            _burn(0.5)
        finally:
            s.stop()
            s._thread.join(timeout=5)
            stop.set()
        labels = {lbl for p in got for lbl, _, _ in p["samples"]}
        assert "park_me" in labels, labels
        assert "MainThread" in labels, labels

    def test_declined_flush_rebuffers_and_retries(self):
        calls = []

        def flaky(payload):
            calls.append(payload)
            return len(calls) > 1

        s = StackSampler(hz=0, flush=flaky)
        s._buf = {("a", "x;y"): 3}
        assert s._try_flush() is False
        assert s._buf == {("a", "x;y"): 3}
        s._buf[("a", "x;y")] += 2
        assert s._try_flush() is True
        assert s._buf == {}
        assert calls[-1]["samples"] == [("a", "x;y", 5)]

    def test_bounded_buffer_counts_overflow(self):
        s = StackSampler(hz=0, flush=lambda p: False, max_keys=1)
        s._buf = {("a", "x"): 1, ("b", "y"): 2}
        assert s._try_flush() is False
        assert len(s._buf) == 1
        assert s._dropped >= 1
        got = []
        s._flush = lambda p: got.append(p)
        assert s._try_flush() is True
        assert got[0]["dropped"] >= 1

    def test_hz_zero_never_starts_a_thread(self):
        s = StackSampler(hz=0, flush=lambda p: None).start()
        assert not s._thread.is_alive()


# ----------------------------------------------------------------------
# ResourceSampler + UtilizationRing units
# ----------------------------------------------------------------------

class TestResourceSampler:
    def test_sample_payload_shape_and_gauges(self):
        s = ResourceSampler(0, sink=lambda p: None,
                            gauges={"queue": lambda: 7,
                                    "broken": lambda: 1 / 0})
        p = s.sample()
        assert set(p) == {"ts", "cpu_percent", "rss_bytes",
                          "mem_used_bytes", "queue", "broken"}
        assert p["queue"] == 7
        assert p["broken"] == 0
        assert abs(p["ts"] - time.time()) < 5.0

    def test_interval_zero_never_starts_a_thread(self):
        s = ResourceSampler(0, sink=lambda p: None).start()
        assert not s._thread.is_alive()


class TestUtilizationRing:
    def test_downsample_replaces_within_interval(self):
        ring = UtilizationRing(interval_s=1.0, maxlen=8)
        ring.record(0, "cpu", 100.0, 10.0)
        ring.record(0, "cpu", 100.5, 20.0)
        (row,) = ring.rows()
        assert row["points"] == [[100.0, 20.0]]
        assert ring.points_downsampled == 1
        ring.record(0, "cpu", 101.0, 30.0)
        (row,) = ring.rows()
        assert len(row["points"]) == 2
        assert ring.points_recorded == 2

    def test_maxlen_bounds_each_series(self):
        ring = UtilizationRing(interval_s=1.0, maxlen=4)
        for i in range(10):
            ring.record(1, "rss", 100.0 + 2 * i, float(i))
        (row,) = ring.rows()
        assert len(row["points"]) == 4
        assert row["points"][-1] == [118.0, 9.0]

    def test_rows_filter_and_latest(self):
        ring = UtilizationRing(interval_s=1.0, maxlen=8)
        ring.record(0, "cpu", 100.0, 1.0)
        ring.record(1, "cpu", 100.0, 2.0)
        ring.record(1, "rss", 100.0, 3.0)
        assert len(ring.rows()) == 3
        assert [r["node"] for r in ring.rows(node=1)] == [1, 1]
        assert [r["series"] for r in ring.rows(series="cpu")] \
            == ["cpu", "cpu"]
        assert ring.latest() == {0: {"cpu": 1.0},
                                 1: {"cpu": 2.0, "rss": 3.0}}


# ----------------------------------------------------------------------
# ProfilePlane aggregation units (explicit args, no runtime)
# ----------------------------------------------------------------------

class TestProfilePlane:
    def _plane(self, **kw):
        kw.setdefault("hz", 100.0)
        kw.setdefault("interval_s", 1.0)
        kw.setdefault("util_maxlen", 16)
        kw.setdefault("max_stacks", 1000)
        return ProfilePlane(**kw)

    def test_record_batch_merges_counts(self):
        pp = self._plane()
        pp.record_batch(1, {"samples": [("t1", "a;b", 3)], "dropped": 0})
        pp.record_batch(1, {"samples": [("t1", "a;b", 2),
                                        ("t2", "a;c", 1)], "dropped": 4})
        rows = pp.profile_stacks()
        assert rows[0] == {"node": 1, "task": "t1", "stack": "a;b",
                           "count": 5}
        assert rows[1]["count"] == 1
        summ = pp.summary()
        assert summ["samples_recorded"] == 6
        assert summ["samples_dropped"] == 4
        assert summ["stacks_resident"] == 2

    def test_stack_table_evicts_oldest(self):
        pp = self._plane(max_stacks=2)
        pp.record_batch(0, {"samples": [("a", "s1", 1)]})
        pp.record_batch(0, {"samples": [("b", "s2", 1)]})
        pp.record_batch(0, {"samples": [("a", "s1", 1)]})
        pp.record_batch(0, {"samples": [("c", "s3", 1)]})
        assert {r["task"] for r in pp.profile_stacks()} == {"a", "c"}
        assert pp.summary()["stacks_evicted"] == 1

    def test_record_util_applies_clock_offset(self):
        pp = self._plane()
        pp.record_util(2, {"ts": 100.0, "cpu_percent": 50.0,
                           "rss_bytes": 1024}, offset=7.5)
        rows = pp.list_utilization(node=2, series="cpu_percent")
        assert rows[0]["points"] == [[107.5, 50.0]]
        pp.record_util(2, {"ts": 110.0, "weird": "NaN-ish-object",
                           "ok": 1})
        names = {r["series"] for r in pp.list_utilization(node=2)}
        assert "ts" not in names
        assert "ok" in names

    def test_defaults_come_from_the_knobs(self):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        pp = ProfilePlane()
        assert pp.hz == GLOBAL_CONFIG.profile_hz
        assert pp.util.interval_s == GLOBAL_CONFIG.utilization_interval_s
        assert pp.util.maxlen == GLOBAL_CONFIG.utilization_ring
        assert pp._max_stacks == GLOBAL_CONFIG.profile_stacks_max

    def test_head_samplers_record_locally_and_shutdown(self):
        pp = self._plane(hz=200.0, interval_s=0.05)
        pp.start_head_samplers(gauges={"g": lambda: 42.0})
        try:
            _poll(lambda: pp.summary()["samples_recorded"] > 0,
                  timeout=10)
            _poll(lambda: pp.utilization_latest().get(0, {}).get("g"),
                  timeout=10)
        finally:
            pp.shutdown()
        assert pp.summary()["samples_recorded"] > 0
        assert pp.utilization_latest()[0]["g"] == 42.0
        assert pp._samplers == []


# ----------------------------------------------------------------------
# export formats
# ----------------------------------------------------------------------

class TestExports:
    ROWS = [
        {"node": 0, "task": "idle", "stack": "a;b", "count": 10},
        {"node": 1, "task": "f:12ab34cd", "stack": "a;c", "count": 30},
        {"node": 1, "task": "f:12ab34cd", "stack": "a;c;d", "count": 60},
    ]

    def test_collapsed_lines(self):
        text = collapsed(self.ROWS)
        assert "node1;f:12ab34cd;a;c;d 60\n" in text
        assert text.endswith("\n")
        assert collapsed([]) == ""

    def test_top_tasks_aggregates_by_label(self):
        table = top_tasks(self.ROWS)
        assert table[0] == {"node": 1, "task": "f:12ab34cd",
                            "samples": 90, "cpu_pct": 90.0}
        assert table[1]["cpu_pct"] == 10.0

    def test_speedscope_document(self):
        doc = speedscope(self.ROWS)
        prof = doc["profiles"][0]
        assert prof["type"] == "sampled"
        assert len(prof["samples"]) == len(prof["weights"]) == 3
        assert prof["endValue"] == 100
        frames = [f["name"] for f in doc["shared"]["frames"]]
        assert frames.count("node1") == 1
        first = prof["samples"][0]
        assert frames[first[0]] == "node0"
        assert frames[first[1]] == "idle"

    def test_flamegraph_report_shape(self):
        rep = flamegraph_report(self.ROWS)
        assert set(rep) == {"samples", "top_tasks", "collapsed",
                            "speedscope"}
        assert rep["samples"] == 100


# ----------------------------------------------------------------------
# integration: cross-node attribution on one clock (shared runtime)
# ----------------------------------------------------------------------

@pytest.fixture(scope="class")
def profile_ray():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                       _system_config=dict(CPU, worker_mode="process",
                                           profile_hz=100.0,
                                           utilization_interval_s=0.2))
    w = worker_mod.get_worker()
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"alpha": 2})
    w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                              resources={"beta": 2})
    yield w
    ray_tpu_torch.shutdown()


class TestClusterFlightRecorder:
    def test_remote_task_attribution_and_aligned_utilization(
            self, profile_ray):
        """CPU burns pinned to both remote nodes surface in
        profile_stacks() as named off-head rows; list_utilization()
        carries a head-clock-aligned series for every node."""
        @ray_tpu_torch.remote(resources={"alpha": 1})
        def burn_alpha(s):
            return _burn(s)

        @ray_tpu_torch.remote(resources={"beta": 1})
        def burn_beta(s):
            return _burn(s)

        t_start = time.time()
        out = ray_tpu_torch.get([burn_alpha.remote(1.2),
                                 burn_beta.remote(1.2)], timeout=120)
        assert all(x > 0 for x in out)

        def named_offhead():
            rows = [r for r in state.profile_stacks()
                    if r["node"] != 0 and "burn_" in r["task"]]
            return rows or None
        rows = _poll(named_offhead, timeout=30)
        assert rows, "no off-head stack attributed to a named task"
        by_task = {r["task"].split(":")[0].split(".")[-1] for r in rows}
        assert by_task >= {"burn_alpha", "burn_beta"}, by_task
        for r in rows:
            assert re.search(r"burn_(alpha|beta):[0-9a-f]{8}$",
                             r["task"]), r
            assert r["node_id"], r
        assert any(r["stack"].split(";")[-1].endswith("._burn")
                   for r in rows), rows
        assert any("_run_payload" in r["stack"] for r in rows), rows

        def all_nodes_report():
            nodes = {r["node"] for r in state.list_utilization(
                series="cpu_percent")}
            return nodes if nodes >= {0, 1, 2} else None
        assert _poll(all_nodes_report, timeout=30), \
            state.list_utilization()
        t_end = time.time()
        for r in state.list_utilization():
            assert r["node_id"]
            for ts, _v in r["points"]:
                assert t_start - 10.0 <= ts <= t_end + 10.0, r

        head = {r["series"] for r in state.list_utilization()
                if r["node"] == 0}
        assert {"cpu_percent", "rss_bytes", "arena_used_bytes",
                "sched_ready_queue", "inflight_tasks"} <= head, head
        # a daemon's sampler carries its arena gauge
        remote = {r["series"] for r in state.list_utilization()
                  if r["node"] == 1}
        assert "arena_used_bytes" in remote, remote

        assert all(r["series"] == "rss_bytes"
                   for r in state.list_utilization(series="rss_bytes"))
        nid = next(r["node_id"] for r in state.list_utilization()
                   if r["node"] == 1)
        assert {r["node"] for r in
                state.list_utilization(node_id=nid[:12])} == {1}

    def test_profile_api_exports_and_metrics(self, profile_ray,
                                             tmp_path):
        @ray_tpu_torch.remote
        def busy(s):
            return _burn(s)

        refs = [busy.remote(1.5) for _ in range(2)]
        report = ray_tpu_torch.profile(1.0)
        assert ray_tpu_torch.get(refs, timeout=120)
        assert report["samples"] > 0
        assert report["top_tasks"]
        assert report["collapsed"].strip()
        assert report["speedscope"]["profiles"][0]["weights"]

        path = ray_tpu_torch.profile(0.2,
                                     filename=str(tmp_path / "p.folded"))
        assert path.endswith("p.folded")
        text = open(path).read()
        assert text == "" or " " in text.splitlines()[0]
        path = ray_tpu_torch.profile(0.2, filename=str(tmp_path / "p.json"))
        doc = json.load(open(path))
        assert doc["$schema"].startswith("https://www.speedscope.app")

        from ray_tpu_torch._private import metrics
        text = metrics.render_all(profile_ray)
        assert "# TYPE ray_tpu_profile_samples_recorded_total counter" \
            in text
        assert "# TYPE ray_tpu_node_cpu_percent gauge" in text
        m = re.search(r"ray_tpu_profile_samples_recorded_total (\d+)",
                      text)
        assert m and int(m.group(1)) > 0
        assert re.search(r'ray_tpu_node_rss_bytes\{node="0"\} \d', text)
        assert re.search(r'ray_tpu_node_rss_bytes\{node="[12]"\} \d',
                         text)

    def test_gang_autoscaler_reads_utilization_pressure(self,
                                                        profile_ray):
        """util_pressure_pct acts once the plane is on: with no backlog,
        a cluster whose latest cpu_percent averages at or above it asks
        for a node."""
        from ray_tpu_torch.autoscaler import (GangAutoscaler,
                                              GangAutoscalerConfig)

        class _NoProvider:
            pass

        cfg = GangAutoscalerConfig(util_pressure_pct=0.0)
        scaler = GangAutoscaler(profile_ray, _NoProvider(), cfg)
        assert scaler._pending_demand() == 0
        cfg.util_pressure_pct = 1e-9
        _poll(lambda: profile_ray.profile_plane.utilization_latest(),
              timeout=10)
        latest = profile_ray.profile_plane.utilization_latest()
        cpus = [s["cpu_percent"] for s in latest.values()
                if "cpu_percent" in s]
        assert scaler._pending_demand() == (1 if cpus and sum(cpus) > 0
                                            else 0)
        cfg.util_pressure_pct = 101.0
        assert scaler._pending_demand() == 0


# ----------------------------------------------------------------------
# ray:// + CLI (a head subprocess through the port's own CLI)
# ----------------------------------------------------------------------

def test_profile_over_ray_client_and_cli(tmp_path, capsys):
    """A named stack row and aligned utilization for every node,
    reachable over a ray:// session and through the CLI verbs
    (`profile`, `status --address`) against `python -m ray_tpu_torch
    start --head` running with profile_hz > 0."""
    from ray_tpu_torch._private import spawn_env
    from ray_tpu_torch.__main__ import _cmd_profile, _cmd_status

    ray_tpu_torch.shutdown()
    env = spawn_env.child_env(
        extra={"RAY_TPU_TORCH_PROFILE_HZ": "100",
               "RAY_TPU_TORCH_UTILIZATION_INTERVAL_S": "0.2",
               "RAY_TPU_TORCH_SCHED_DEVICE": "cpu"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-cpus", "4", "--num-workers", "2",
         "--worker-mode", "process"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        address = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                time.sleep(0.05)
                continue
            m = re.search(r"address='(ray://[^']+)'", line)
            if m:
                address = m.group(1)
                break
        assert address, "head did not print a connect string"

        ray_tpu_torch.init(address=address)

        @ray_tpu_torch.remote
        def client_burn(s):
            end = time.time() + s
            x = 0
            while time.time() < end:
                x += 1
            return x

        assert ray_tpu_torch.get(client_burn.remote(1.2), timeout=60) > 0

        def named_row():
            return [r for r in state.profile_stacks()
                    if "client_burn" in r["task"]] or None
        assert _poll(named_row, timeout=30), "no named row over ray://"
        util = _poll(lambda: state.list_utilization(
            series="cpu_percent"), timeout=30)
        assert util, "no utilization visible over ray://"
        now = time.time()
        assert all(abs(now - r["points"][-1][0]) < 60 for r in util)
        ray_tpu_torch.shutdown()

        rc = _cmd_status(SimpleNamespace(metrics_port=0, address=address))
        out = capsys.readouterr().out
        assert rc == 0
        assert "nodes (" in out
        assert "utilization (latest sample per node):" in out
        assert "cpu_percent=" in out

        fg = tmp_path / "cluster.folded"
        rc = _cmd_profile(SimpleNamespace(address=address, duration=1.0,
                                          output=str(fg)))
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "samples over" in out
        assert fg.exists() and fg.read_text().strip()
    finally:
        ray_tpu_torch.shutdown()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


# ----------------------------------------------------------------------
# disabled plane: zero cost, schema-stable surfaces
# ----------------------------------------------------------------------

def test_disabled_plane_is_absent_everywhere():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=1,
                       _system_config=dict(CPU, worker_mode="process"))
    try:
        w = worker_mod.get_worker()
        assert w.profile_plane is None
        names = {t.name for t in threading.enumerate()}
        assert not any(n.startswith(("ray_tpu_profile",
                                     "ray_tpu_util")) for n in names)

        @ray_tpu_torch.remote
        def f(x):
            return x * 2

        assert ray_tpu_torch.get(f.remote(3), timeout=60) == 6
        assert state.profile_stacks() == []
        assert state.list_utilization() == []
        from ray_tpu_torch._private import metrics
        text = metrics.render_all(w)
        assert "ray_tpu_profile_samples_recorded_total 0" in text
        assert "ray_tpu_profile_samples_dropped_total 0" in text
        assert "ray_tpu_node_cpu_percent 0" in text
        assert "ray_tpu_node_rss_bytes 0" in text
        assert "ray_tpu_node_arena_used_bytes 0" in text
    finally:
        ray_tpu_torch.shutdown()


def test_profiled_process_runtime_records_its_workers():
    """The run the reference's overhead guard makes, without its clock:
    a process-mode runtime with the plane on runs a batched fan-out to
    the end, and its workers' samplers ship frames the head records
    under node 0, labelled with the task."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2,
                       _system_config=dict(CPU, worker_mode="process",
                                           profile_hz=100.0))
    try:
        w = worker_mod.get_worker()
        assert w.profile_plane is not None

        @ray_tpu_torch.remote
        def noop(i):
            _burn(0.02)
            return i

        refs = noop.map_remote([(i,) for i in range(80)])
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(80))
        assert _poll(lambda: any(
            r["node"] == 0 and "noop:" in r["task"]
            for r in w.profile_plane.profile_stacks()), timeout=30)
    finally:
        ray_tpu_torch.shutdown()
