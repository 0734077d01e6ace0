"""The port's state API, timeline, metrics endpoint and dashboard: the
cases of ``tests/test_observability.py`` and the dashboard cases of
``tests/test_dag_snapshot_dashboard.py`` on ``ray_tpu_torch``, plus
parity with the reference on the same small workload: the row keys of
every state verb whose rows the workload makes, ``summarize_tasks``'s
keys and the timeline's event keys equal the reference's; the state
module defines the reference's verbs; and the dashboard serves the
reference's endpoint list. The overview page escapes every cell it
renders.
"""

import json
import re
import threading
import time
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.util import state

CPU = {"sched_device": "cpu"}


@pytest.fixture(params=["event", "tensor"])
def rt(request):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=4, scheduler=request.param,
                       _system_config=CPU)
    yield ray_tpu_torch
    from ray_tpu_torch import dashboard
    dashboard.stop_dashboard()
    ray_tpu_torch.shutdown()


class TestStateVerbs:
    def test_list_tasks_reflects_live_run(self, rt):
        gate = threading.Event()

        @ray_tpu_torch.remote
        def blocked():
            gate.wait(timeout=30)
            return 1

        refs = [blocked.remote() for _ in range(6)]
        time.sleep(0.3)
        rows = state.list_tasks()
        states = [r["state"] for r in rows]
        assert states.count("RUNNING") >= 1
        assert len(rows) == 6
        assert all(r["name"].endswith("blocked") for r in rows), rows
        assert state.summarize_tasks().get("RUNNING", 0) >= 1
        gate.set()
        assert ray_tpu_torch.get(refs, timeout=30) == [1] * 6
        for _ in range(100):
            if not state.list_tasks():
                break
            time.sleep(0.02)
        assert state.list_tasks() == []

    def test_list_tasks_shows_dep_blocked(self, rt):
        gate = threading.Event()

        @ray_tpu_torch.remote
        def slow():
            gate.wait(timeout=30)
            return 1

        @ray_tpu_torch.remote
        def consumer(x):
            return x

        a = slow.remote()
        c = consumer.remote(a)
        time.sleep(0.2)
        rows = {r["name"].rsplit(".", 1)[-1]: r
                for r in state.list_tasks()}
        assert rows["consumer"]["state"] == "PENDING_ARGS"
        gate.set()
        assert ray_tpu_torch.get(c, timeout=30) == 1

    def test_list_tasks_detail_keeps_finished_rows(self, rt):
        @ray_tpu_torch.remote
        def done_task(x):
            return x

        ray_tpu_torch.get([done_task.remote(i) for i in range(3)],
                          timeout=30)

        def finished():
            # the event plane records a finish just after get returns
            return [r for r in state.list_tasks(detail=True)
                    if r["name"].endswith("done_task")
                    and r["state"] == "FINISHED"]

        deadline = time.monotonic() + 10
        while len(finished()) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(finished()) == 3
        assert state.list_tasks(detail=True, state="FINISHED")

    def test_list_actors_and_objects(self, rt):
        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return "pong"

        a = A.options(name="obsactor").remote()
        ray_tpu_torch.get(a.ping.remote(), timeout=20)
        actors = {r["name"]: r for r in state.list_actors()}
        assert actors["obsactor"]["class_name"] == "A"
        ref = ray_tpu_torch.put({"k": 1})
        assert ref.object_id().hex() in {r["object_id"]
                                         for r in state.list_objects()}
        ray_tpu_torch.kill(a)

    def test_list_nodes_and_pgs(self, rt):
        nodes = state.list_nodes()
        assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
        from ray_tpu_torch.util import placement_group

        pg = placement_group([{"CPU": 1}])
        assert pg.wait(10)
        assert any(p["state"] == "CREATED"
                   for p in state.list_placement_groups())


class TestTimeline:
    def test_timeline_spans(self, rt, tmp_path):
        @ray_tpu_torch.remote
        def work():
            time.sleep(0.02)
            return 1

        ray_tpu_torch.get([work.remote() for _ in range(5)], timeout=30)
        events = ray_tpu_torch.timeline()
        spans = [e for e in events if e["ph"] == "X"
                 and e["name"].endswith("work")]
        assert len(spans) == 5
        assert all(e["dur"] >= 0.02 * 1e6 * 0.5 for e in spans)
        path = ray_tpu_torch.timeline(str(tmp_path / "trace.json"))
        with open(path) as f:
            assert isinstance(json.load(f), list)

    def test_trace_exports_the_latest_trace(self, rt, tmp_path):
        @ray_tpu_torch.remote
        def traced():
            return 1

        ray_tpu_torch.get(traced.remote(), timeout=30)
        rows = state.list_traces()
        assert rows and rows[0]["spans"] >= 1
        events = ray_tpu_torch.trace()
        assert events and any(e.get("ph") == "X" for e in events)
        path = ray_tpu_torch.trace(rows[0]["trace_id"],
                                   str(tmp_path / "tr.json"))
        with open(path) as f:
            assert json.load(f)


class TestMetricsEndpoint:
    def test_prometheus_endpoint_serves_counters(self):
        import socket

        ray_tpu_torch.shutdown()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ray_tpu_torch.init(num_workers=2, scheduler="tensor",
                           _system_config=dict(CPU,
                                               metrics_export_port=port))
        try:
            @ray_tpu_torch.remote
            def f(x):
                return x

            ray_tpu_torch.get([f.remote(i) for i in range(10)], timeout=30)
            from ray_tpu_torch.util.metrics import Counter, Gauge

            Counter("my_app_events_total", "app events").inc(
                3, tags={"kind": "x"})
            Gauge("my_app_temperature", "t").set(21.5)
            w = ray_tpu_torch._worker.get_worker()
            url = f"http://127.0.0.1:{w.metrics_server.port}/metrics"
            body = urllib.request.urlopen(url, timeout=10).read().decode()
            assert "ray_tpu_tasks_finished_total" in body
            assert "ray_tpu_tasks_submitted_total" in body
            assert 'my_app_events_total{kind="x"} 3.0' in body
            assert "my_app_temperature 21.5" in body
        finally:
            ray_tpu_torch.shutdown()


# ----------------------------------------------------------------------
# the same workload through both packages: the rows' keys
# ----------------------------------------------------------------------

def _verb_keys(ray, state_mod, cfg):
    """A small workload (a task held running by an event, a finished
    task, a named actor, a put, a placement group) under qos and the
    profile plane; then each verb's row keys."""
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config=dict(
        cfg, qos=True, profile_hz=50.0, utilization_interval_s=0.1))
    gate = threading.Event()
    try:
        @ray.remote
        def held():
            gate.wait(timeout=30)
            return 1

        @ray.remote
        def quick(x):
            return x

        @ray.remote
        class Named:
            def ping(self):
                return 1

        a = Named.options(name="keys_actor").remote()
        ray.get(a.ping.remote(), timeout=30)
        ray.get(quick.options(tenant="t1").remote(1), timeout=30)
        h = held.remote()
        obj = ray.put([1, 2, 3])
        from importlib import import_module
        pgmod = import_module(ray.__name__ + ".util.placement_group")
        pg = pgmod.placement_group([{"CPU": 1}])
        assert pg.wait(10)
        deadline = time.monotonic() + 10
        while not state_mod.list_utilization() or not \
                state_mod.profile_stacks():
            assert time.monotonic() < deadline
            time.sleep(0.05)

        def keys(rows):
            return sorted({k for r in rows for k in r})

        out = {
            "list_tasks": keys(state_mod.list_tasks()),
            "list_tasks_detail": keys(state_mod.list_tasks(detail=True)),
            "list_actors": keys(state_mod.list_actors()),
            "list_objects": keys(state_mod.list_objects()),
            "list_objects_locations": keys(
                state_mod.list_objects(locations=True)),
            "list_nodes": keys(state_mod.list_nodes()),
            "list_placement_groups": keys(
                state_mod.list_placement_groups()),
            "list_tenants": keys(state_mod.list_tenants()),
            "summarize_tasks": sorted(k for k in state_mod.summarize_tasks()
                                      if not k[0].isupper()
                                      or k.endswith("TOTAL")),
            "task_timeline": keys(state_mod.task_timeline()),
            "list_traces": keys(state_mod.list_traces()),
            "profile_stacks": keys(state_mod.profile_stacks()),
            "list_utilization": keys(state_mod.list_utilization()),
        }
        # list_faults, list_data_streams and list_serve_deployments read
        # process-wide registries (the chaos controller, Data's recent
        # splits, Serve's controller) that other tests in the process
        # fill: not this workload's rows, so not compared here
        gate.set()
        ray.get(h, timeout=30)
        del obj
        ray.kill(a)
        return out
    finally:
        gate.set()
        ray.shutdown()


def test_state_rows_have_the_references_keys():
    want = _verb_keys(ray_tpu, __import__("ray_tpu.util.state",
                                          fromlist=["x"]), {})
    got = _verb_keys(ray_tpu_torch, state, CPU)
    assert got == want


def test_state_verbs_are_the_references():
    from ray_tpu.util import state as ref_state

    def verbs(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_")
                      and callable(getattr(mod, n))
                      and getattr(getattr(mod, n), "__module__", "")
                      == mod.__name__)

    assert verbs(state) == verbs(ref_state)


# ----------------------------------------------------------------------
# the dashboard
# ----------------------------------------------------------------------

def _routes(src):
    return sorted(set(re.findall(r'"(/api/[a-z_]+)"', src)))


def test_dashboard_serves_the_references_endpoints(rt, tmp_path):
    """The same /api/* paths as the reference's dashboard, each answering
    200 with JSON (the query routes with their parameters)."""
    import inspect

    from ray_tpu import dashboard as ref_dash
    from ray_tpu_torch import dashboard

    ours = _routes(inspect.getsource(dashboard))
    assert ours == _routes(inspect.getsource(ref_dash))
    assert len(ours) >= 19
    port = dashboard.start_dashboard(0)
    w = ray_tpu_torch._worker.get_worker()

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote(), timeout=30)
    tid = state.list_traces()[0]["trace_id"]
    query = {"/api/trace": f"?trace_id={tid}",
             "/api/log_file": None}
    for path in ours:
        if query.get(path, "") is None:
            continue          # needs a capture file: below
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}{query.get(path, '')}",
            timeout=10).read()
        json.loads(body)
    if w.session_log_dir is not None:
        files = state.list_logs()
        if files:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/log_file?filename="
                f"{files[0]['filename']}&tail=5", timeout=10).read()
            assert "lines" in json.loads(body)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api/nope",
                               timeout=10)
    assert err.value.code == 404


class TestDashboard:
    def test_endpoints(self, rt):
        from ray_tpu_torch.dashboard import start_dashboard

        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return 1

        a = A.options(name="dash").remote()
        ray_tpu_torch.get(a.ping.remote(), timeout=20)
        port = start_dashboard(0)

        def fetch(path):
            return json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10).read())

        summary = fetch("/api/summary")
        assert "tasks" in summary and "scheduler" in summary
        assert any(r["name"] == "dash" for r in fetch("/api/actors"))
        assert fetch("/api/nodes")[0]["state"] == "ALIVE"
        assert fetch("/api/actors") == state.list_actors()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert b"ray_tpu_tasks_finished_total" in body
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"ray_tpu_torch" in html
        ray_tpu_torch.kill(a)


class TestDashboardUI:
    def test_index_serves_the_overview_ui(self, rt):
        from ray_tpu_torch.dashboard import start_dashboard

        port = start_dashboard(0)
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        for marker in ('id="tiles"', 'id="nodes"', 'id="actors"',
                       '<svg id="tp"', "setInterval(refresh",
                       "prefers-color-scheme: dark", "/api/summary",
                       'id="tenants"', 'id="util"'):
            assert marker in html, marker
        assert "sched.finished" in html
        assert "waiting_deps" in html

    def test_every_cell_escapes_and_badges_are_css(self, rt):
        """Every table cell of the page goes through esc(), whose
        replacements turn markup into text; state badges are CSS classes
        keyed on a validated token. An actor named with markup comes back
        raw from the API (JSON, no HTML) and escaped by the page's rule."""
        from ray_tpu_torch.dashboard import start_dashboard

        port = start_dashboard(0)
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        assert "_html" not in html
        assert "st-${cls}" in html
        assert 'td[class^="st-"]::before' in html
        assert 'id="streams"' in html
        # every interpolation inside a <td> is esc(...) or a number: a
        # Number(...) coercion, a seconds formatter, the task-detail bar
        cells = re.findall(r"<td[^>]*>\$\{([^}]*)\}</td>", html)
        assert cells
        assert all(c.startswith(("esc(", "Number(", "fmtS("))
                   or c == "bar" for c in cells), cells
        # esc's replacement chain, applied as the page applies it
        chain = re.search(r"function esc\(v\) \{(.*?)\n\}", html,
                          re.S).group(1)
        pairs = re.findall(r'\.replace\(/(.)/g, "([^"]+)"\)', chain)
        assert [p[0] for p in pairs] == ["&", "<", ">", '"']

        def esc(v):
            for ch, ent in pairs:
                v = v.replace(ch, ent)
            return v

        hostile = '<img src=x onerror="alert(1)">&'

        @ray_tpu_torch.remote
        class Evil:
            def ping(self):
                return 1

        a = Evil.options(name=hostile).remote()
        ray_tpu_torch.get(a.ping.remote(), timeout=20)
        rows = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/actors", timeout=10).read())
        name = next(r["name"] for r in rows if r["name"] == hostile)
        cell = esc(name)
        assert "<" not in cell and ">" not in cell and '"' not in cell
        assert cell == ("&lt;img src=x onerror=&quot;alert(1)&quot;&gt;"
                        "&amp;")
        ray_tpu_torch.kill(a)
        streams = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/data_streams", timeout=10).read())
        assert isinstance(streams, list)
