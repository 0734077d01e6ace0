"""ray_tpu_torch.workflow on the CPU: tests/test_ops_layer.py's workflow
cases (TestWorkflow, TestWorkflowDepth) on the port's runtime (thread
mode, the scheduler's device path on the host), and one parity case: a
deterministic workflow, interrupted and resumed, through ``ray_tpu``'s
runtime and then the port's, with the same result and the same journaled
steps."""

import os

import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch as ray  # noqa: E402
from ray_tpu_torch import workflow  # noqa: E402

SYSTEM = {"sched_device": "cpu"}


@pytest.fixture
def rt():
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor", _system_config=SYSTEM)
    yield ray
    ray.shutdown()


class TestWorkflow:
    def test_dag_runs(self, rt, tmp_path):
        @workflow.step
        def add(a, b):
            return a + b

        @workflow.step
        def mul(a, b):
            return a * b

        out = mul.step(add.step(1, 2), 4).run("wf1", str(tmp_path))
        assert out == 12
        status = workflow.get_status("wf1", str(tmp_path))
        assert status["status"] == "SUCCEEDED"
        assert status["fresh_steps"] == 2

    def test_resume_skips_journaled_steps(self, rt, tmp_path):
        calls = {"n": 0}

        @workflow.step
        def flaky(x):
            calls["n"] += 1
            if calls["n"] == 2 and not os.path.exists(
                    str(tmp_path / "ok")):
                open(str(tmp_path / "ok"), "w").close()
                raise RuntimeError("crash mid-workflow")
            return x * 2

        @workflow.step
        def combine(a, b):
            return a + b

        dag = combine.step(flaky.step(1), flaky.step(10))
        with pytest.raises(Exception):
            dag.run("wf2", str(tmp_path))
        # resume: the journaled first step must NOT re-execute
        calls_before = calls["n"]
        out = workflow.resume("wf2", dag, str(tmp_path))
        assert out == 22
        status = workflow.get_status("wf2", str(tmp_path))
        assert status["cached_steps"] >= 1
        # only the crashed step re-executes; the journaled one does not
        assert calls["n"] == calls_before + 1

    def test_steps_listed(self, rt, tmp_path):
        @workflow.step
        def one():
            return 1

        one.step().run("wf3", str(tmp_path))
        steps = workflow.list_steps("wf3", str(tmp_path))
        assert any("one" in s for s in steps)


class TestWorkflowDepth:
    def test_step_retries_through_task_layer(self, rt, tmp_path):
        attempts = str(tmp_path / "attempts")

        @workflow.step
        def flaky(path):
            import os
            n = int(open(path).read()) if os.path.exists(path) else 0
            open(path, "w").write(str(n + 1))
            if n < 2:
                raise RuntimeError("transient")
            return n

        node = flaky.step(attempts).options(max_retries=3)
        out = node.run(workflow_id="wf_retry",
                       storage=str(tmp_path / "s"))
        assert out == 2  # third attempt succeeded
        assert int(open(attempts).read()) == 3

    def test_catch_exceptions(self, rt, tmp_path):
        @workflow.step
        def boom():
            raise ValueError("nope")

        @workflow.step
        def ok():
            return 7

        r, err = boom.step().options(catch_exceptions=True).run(
            workflow_id="wf_catch", storage=str(tmp_path))
        assert r is None and "nope" in str(err)
        r, err = ok.step().options(catch_exceptions=True).run(
            workflow_id="wf_catch2", storage=str(tmp_path))
        assert (r, err) == (7, None)

    def test_continuation_dynamic_workflow(self, rt, tmp_path):
        @workflow.step
        def base(x):
            return x * 10

        @workflow.step
        def decide(x):
            # a step RETURNING a step: the continuation executes in
            # its place (reference: workflow.continuation)
            if x < 3:
                return base.step(x)
            return x

        assert decide.step(2).run("wf_cont1", str(tmp_path)) == 20
        assert decide.step(5).run("wf_cont2", str(tmp_path)) == 5

    def test_failed_status_and_resume_without_node(self, rt, tmp_path):
        marker = str(tmp_path / "fixed")

        @workflow.step
        def sometimes(path):
            import os
            if not os.path.exists(path):
                raise RuntimeError("not yet")
            return "done"

        node = sometimes.step(marker)
        with pytest.raises(Exception):
            node.run("wf_res", str(tmp_path / "s"))
        assert workflow.get_status(
            "wf_res", str(tmp_path / "s"))["status"] == "FAILED"
        open(marker, "w").close()
        # resume WITHOUT the node object: the DAG came from the journal
        out = workflow.resume("wf_res", storage=str(tmp_path / "s"))
        assert out == "done"
        assert workflow.get_output(
            "wf_res", str(tmp_path / "s")) == "done"

    def test_list_all_and_resume_all(self, rt, tmp_path):
        storage = str(tmp_path / "s")
        gate = str(tmp_path / "gate")

        @workflow.step
        def good():
            return 1

        @workflow.step
        def gated(path):
            import os
            if not os.path.exists(path):
                raise RuntimeError("gated")
            return 2

        good.step().run("wf_a", storage)
        with pytest.raises(Exception):
            gated.step(gate).run("wf_b", storage)
        assert dict(workflow.list_all(storage)) == {
            "wf_a": "SUCCEEDED", "wf_b": "FAILED"}
        open(gate, "w").close()
        resumed = workflow.resume_all(storage)
        assert resumed == {"wf_b": 2}
        assert dict(workflow.list_all(storage))["wf_b"] == "SUCCEEDED"

    def test_continuation_crash_does_not_rerun_parent_body(self, rt,
                                                           tmp_path):
        """The parent's side effects must not replay when a resume
        re-enters a workflow that crashed INSIDE a continuation."""
        counter = str(tmp_path / "count")
        gate = str(tmp_path / "gate")
        storage = str(tmp_path / "s")

        @workflow.step
        def gated(path):
            import os
            if not os.path.exists(path):
                raise RuntimeError("continuation crash")
            return "cont-done"

        @workflow.step
        def parent(cpath, gpath):
            import os
            n = int(open(cpath).read()) if os.path.exists(cpath) else 0
            open(cpath, "w").write(str(n + 1))
            return gated.step(gpath)

        node = parent.step(counter, gate)
        with pytest.raises(Exception):
            node.run("wf_body", storage)
        assert int(open(counter).read()) == 1
        open(gate, "w").close()
        assert workflow.resume("wf_body", storage=storage) == "cont-done"
        # the parent body ran exactly once across crash + resume
        assert int(open(counter).read()) == 1
        # internal records never leak into the step listing
        assert all(not s.startswith("__") and "#body" not in s
                   for s in workflow.list_steps("wf_body", storage))


def _parity_run(wf, root, gate):
    """A deterministic workflow with a continuation and a gated step:
    the first run fails at the gate, the resume finishes it. Returns the
    result, the journaled steps and the status after the resume."""

    @wf.step
    def square(x):
        return x * x

    @wf.step
    def gated(x, path):
        import os
        if not os.path.exists(path):
            raise RuntimeError("gate closed")
        return x + 1

    @wf.step
    def expand(x):
        return square.step(x) if x < 10 else x

    @wf.step
    def total(a, b, c):
        return a + b + c

    node = total.step(square.step(3), expand.step(4), gated.step(5, gate))
    with pytest.raises(Exception):
        node.run("wf_parity", root)
    open(gate, "w").close()
    out = wf.resume("wf_parity", storage=root)
    return out, wf.list_steps("wf_parity", root), wf.get_status(
        "wf_parity", root)


def test_workflow_matches_the_reference(tmp_path):
    import ray_tpu
    from ray_tpu import workflow as ref_workflow

    ray.shutdown()
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=4, scheduler="tensor")
    try:
        want = _parity_run(ref_workflow, str(tmp_path / "ref"),
                           str(tmp_path / "ref_gate"))
    finally:
        ray_tpu.shutdown()
    ray.init(num_workers=4, scheduler="tensor", _system_config=SYSTEM)
    try:
        got = _parity_run(workflow, str(tmp_path / "port"),
                          str(tmp_path / "port_gate"))
    finally:
        ray.shutdown()
    assert got == want
    assert got[0] == 9 + 16 + 6
    assert got[2]["status"] == "SUCCEEDED" and got[2]["cached_steps"] >= 2
