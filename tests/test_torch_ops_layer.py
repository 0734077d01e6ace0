"""The port's ops layer: job submission and the CLI, the cases of
``tests/test_ops_layer.py`` (its job and CLI classes; the autoscaler
and workflow cases have their port tests in ``test_torch_cluster.py``
and ``test_torch_workflow.py``) on ``ray_tpu_torch``, plus:

- the card rule for jobs: a job's driver sees no CUDA device
  (``CUDA_VISIBLE_DEVICES=""``) unless ``env_vars`` names a non-empty
  ``CUDA_VISIBLE_DEVICES``, which it then gets;
- the CLI's verbs and flags equal the reference's parser (option
  strings, destinations, defaults, types, choices, nargs); ``bench``
  refuses and runs nothing in its place, ``start --jax-*`` joins the
  process group and ``lint`` runs raylint's passes (ROADMAP.md items 7
  and 8, both done; tests/test_torch_analysis.py runs the real lint);
- ``start --head`` serves ``ray://`` clients, ``start --address`` joins
  a node, ``status``, ``job``, ``timeline``, ``trace``, ``profile`` and
  ``logs`` over ``--address``, and a SIGTERM ends the head with its
  workers and the joined daemon.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import spawn_env
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

CPU = {"sched_device": "cpu"}
# the CLI's head reads its knobs from the registry's environment overrides
CLI_ENV = {"RAY_TPU_TORCH_SCHED_DEVICE": "cpu"}


class TestJobSubmission:
    def test_submit_and_succeed(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
        assert client.wait_until_finish(job_id, timeout=60) == \
            JobStatus.SUCCEEDED
        assert "hello from job" in client.get_job_logs(job_id)
        jobs = client.list_jobs()
        assert jobs[0]["submission_id"] == job_id
        assert jobs[0]["status"] == JobStatus.SUCCEEDED
        assert jobs[0]["end_time"] >= jobs[0]["start_time"]

    def test_failed_job(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        assert client.wait_until_finish(job_id, 60) == JobStatus.FAILED

    def test_stop_job(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
        time.sleep(0.3)
        assert client.stop_job(job_id) is True
        assert client.wait_until_finish(job_id, 30) == JobStatus.STOPPED

    def test_env_vars_and_job_id(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=(f"{sys.executable} -c \"import os; "
                        f"print(os.environ['RAY_TPU_TORCH_JOB_ID'], "
                        f"os.environ['MY_FLAG'])\""),
            env_vars={"MY_FLAG": "on"})
        client.wait_until_finish(job_id, 60)
        logs = client.get_job_logs(job_id)
        assert job_id in logs and "on" in logs

    def test_unknown_job_raises(self, tmp_path):
        with pytest.raises(ValueError, match="unknown job"):
            JobSubmissionClient(str(tmp_path)).get_job_status("nope")


_PRINT_CVD = (f"{sys.executable} -c \"import os; "
              "print('cvd=[' + os.environ.get('CUDA_VISIBLE_DEVICES', "
              "'unset') + ']')\"")


@pytest.mark.parametrize("env_vars, want", [
    (None, "cvd=[]"), ({"CUDA_VISIBLE_DEVICES": ""}, "cvd=[]"),
    ({"CUDA_VISIBLE_DEVICES": "0"}, "cvd=[0]"),
    ({"CUDA_VISIBLE_DEVICES": "1,0"}, "cvd=[1,0]")])
def test_job_sees_a_card_only_when_env_vars_name_one(tmp_path, env_vars,
                                                     want):
    """The port's rule (ROADMAP.md Queue C): a job's driver reaches the
    card through the head, so it sees none, unless env_vars names a
    non-empty CUDA_VISIBLE_DEVICES."""
    client = JobSubmissionClient(str(tmp_path))
    job_id = client.submit_job(entrypoint=_PRINT_CVD, env_vars=env_vars)
    assert client.wait_until_finish(job_id, 60) == JobStatus.SUCCEEDED
    assert want in client.get_job_logs(job_id)


def test_job_logs_land_in_the_session_log_dir():
    """With a runtime up, a job's output file sits in the session log
    dir beside the workers' capture files, so list_logs sees it."""
    from ray_tpu_torch.util import state

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=1, _system_config=CPU)
    try:
        assert ray_tpu_torch._worker.get_worker().session_log_dir
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('in session')\"")
        assert client.wait_until_finish(job_id, 60) == JobStatus.SUCCEEDED
        names = {r["filename"] for r in state.list_logs()}
        assert f"{job_id}.out" in names
        assert "in session" in state.get_log(f"{job_id}.out")
    finally:
        ray_tpu_torch.shutdown()


# ----------------------------------------------------------------------
# the CLI's surface against the reference's
# ----------------------------------------------------------------------

class _Captured(Exception):
    pass


def _parser_of(main):
    """The argparse parser main() builds, caught at parse_args."""
    box = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        box["parser"] = self
        raise _Captured

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Captured):
            main(["status"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return box["parser"]


def _surface(parser):
    """{verb: [(option strings, dest, default, type, nargs, choices,
    action kind)]} with help text left out."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for verb, p in sub.choices.items():
        out[verb] = sorted(
            (tuple(a.option_strings), a.dest, repr(a.default),
             getattr(a.type, "__name__", repr(a.type)), repr(a.nargs),
             repr(a.choices), type(a).__name__)
            for a in p._actions if a.dest != "help")
    return out


def test_cli_verbs_and_flags_equal_the_reference():
    from ray_tpu.__main__ import main as ref_main
    from ray_tpu_torch.__main__ import main

    ours, ref = _surface(_parser_of(main)), _surface(_parser_of(ref_main))
    assert list(ours) == list(ref)
    assert ours == ref


def test_help_lists_the_references_verbs():
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=120,
                         env=spawn_env.child_env())
    assert out.returncode == 0
    for verb in ("start", "status", "microbenchmark", "bench", "job",
                 "logs", "timeline", "trace", "profile", "summary", "lint"):
        assert verb in out.stdout


@pytest.mark.parametrize("argv, item", [
    (["start", "--head", "--jax-coordinator", "h:1"], "item 7"),
    (["start", "--head", "--jax-num-processes", "2"], "item 7"),
    (["start", "--address", "ray://h:1?key=00", "--jax-process-id", "0"],
     "item 7"),
    (["lint"], "item 8"), (["lint", "--json"], "item 8")])
def test_refused_verbs_name_their_roadmap_item(argv, item, monkeypatch,
                                               capsys):
    """The verbs once refused until their ROADMAP.md item landed now run.
    ``lint`` (item 8) runs the analysis plane's ``run_all`` and prints
    its report, as text or with ``--json`` as JSON (a stand-in report
    here; tests/test_torch_analysis.py runs the real passes). The
    ``start --jax-*`` flags (item 7) hand the reference's arguments to
    ``init_multihost`` before anything starts (a stand-in records them
    here; tests/test_torch_sharded.py joins for real)."""
    from ray_tpu_torch.__main__ import main
    from ray_tpu_torch._private import analysis
    from ray_tpu_torch.parallel import distributed

    class Joined(Exception):
        pass

    calls = []

    def fake_init(*args):
        calls.append(args)
        raise Joined

    monkeypatch.setattr(distributed, "init_multihost", fake_init)
    ray_tpu_torch.shutdown()
    if item == "item 8":
        runs = []

        def fake_run_all():
            runs.append(1)
            return analysis.Report(findings=[], new=[], baselined=[],
                                   stale_suppressions=[],
                                   durations={"knobs": 0.5})

        monkeypatch.setattr(analysis, "run_all", fake_run_all)
        assert main(argv) == 0
        out = capsys.readouterr().out
        assert runs == [1]
        if "--json" in argv:
            assert json.loads(out) == {
                "ok": True, "new": [], "baselined": [],
                "stale_suppressions": [], "durations_s": {"knobs": 0.5}}
        else:
            assert "raylint: 0 new, 0 baselined, 0 stale" in out
        assert not calls
    else:
        with pytest.raises(Joined):
            main(argv)
        flags = {a: v for a, v in zip(argv, argv[1:]) if a.startswith('--jax')}
        assert calls == [(flags.get("--jax-coordinator"),
                          int(flags.get("--jax-num-processes", 0)) or None,
                          (int(flags["--jax-process-id"])
                           if "--jax-process-id" in flags else None))]
    assert not ray_tpu_torch.is_initialized()


def test_bench_exits_nonzero_and_runs_nothing(tmp_path, capsys,
                                              monkeypatch):
    from ray_tpu_torch.__main__ import main

    ran = []
    monkeypatch.setattr(subprocess, "call", lambda *a, **k: ran.append(a))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: ran.append(a))
    assert main(["bench"]) != 0
    assert main(["bench", "--smoke"]) != 0
    assert not ran
    assert "not written yet" in capsys.readouterr().err


class TestCLI:
    def test_status_and_summary(self, tmp_path, capsys):
        from ray_tpu_torch.__main__ import main

        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2, scheduler="tensor",
                           _system_config=CPU)

        @ray_tpu_torch.remote
        def work():
            return 1

        ray_tpu_torch.get([work.remote() for _ in range(3)], timeout=30)
        trace = str(tmp_path / "t.json")
        ray_tpu_torch.timeline(trace)
        ray_tpu_torch.shutdown()
        assert main(["summary", trace]) == 0
        out = capsys.readouterr().out
        assert "test_status_and_summary" in out and " 3 " in out

    def test_status_names_the_cuda_devices(self):
        env = spawn_env.child_env(extra=CLI_ENV)
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "status"],
            capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        assert "node resources:" in out.stdout
        assert "cuda devices (0): []" in out.stdout
        assert "jax" not in out.stdout

    def test_microbenchmark_runs_both_modes(self):
        env = spawn_env.child_env(extra=CLI_ENV)
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "microbenchmark",
             "--num-tasks", "200"],
            capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        assert re.search(r"^thread: \d+ tasks/s \(200 tasks", out.stdout,
                         re.M), out.stdout
        assert re.search(r"^process: \d+ tasks/s \(200 tasks", out.stdout,
                         re.M), out.stdout

    def test_logs_reads_a_session_dir_without_a_cluster(self, tmp_path):
        logs = tmp_path / "session_x" / "logs"
        logs.mkdir(parents=True)
        (logs / "worker-1.out").write_text("line a\nline b\n")
        env = spawn_env.child_env(extra=CLI_ENV)
        run = [sys.executable, "-m", "ray_tpu_torch", "logs",
               "--session-dir", str(logs)]
        out = subprocess.run(run, capture_output=True, text=True,
                             timeout=120, env=env)
        assert out.returncode == 0 and "worker-1.out" in out.stdout
        out = subprocess.run(run + ["worker-1.out", "--tail", "1"],
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode == 0 and out.stdout.strip() == "line b"

    def test_address_verbs_refuse_without_an_address(self, capsys):
        from ray_tpu_torch.__main__ import main

        for verb in ("timeline", "trace", "profile"):
            assert main([verb]) == 2
            assert "--address" in capsys.readouterr().err


def _group_alive(pgid):
    alive = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().split(")")[-1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) == pgid:
            alive.append(int(name))
    return alive


def test_operator_path_through_the_cli(tmp_path):
    """start --head (process mode, profile plane on) -> start --address
    -> status --address lists both nodes ALIVE -> job runs a driver that
    connects over ray:// -> timeline / trace / profile / logs over
    --address write their output -> SIGTERM to the head ends the head,
    its workers and the joined daemon."""
    env = spawn_env.child_env(extra=dict(
        CLI_ENV, RAY_TPU_TORCH_PROFILE_HZ="50",
        RAY_TPU_TORCH_UTILIZATION_INTERVAL_S="0.2"))
    cli = [sys.executable, "-m", "ray_tpu_torch"]
    head = subprocess.Popen(
        cli + ["start", "--head", "--worker-mode", "process",
               "--num-workers", "2", "--resources", '{"head_res": 2}'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True, cwd=str(tmp_path))
    node = None
    try:
        address = None
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and address is None:
            line = head.stdout.readline()
            m = re.search(r"address='(ray://[^']+)'", line or "")
            if m:
                address = m.group(1)
        assert address, "head did not print a connect string"
        node = subprocess.Popen(
            cli + ["start", f"--address={address}", "--num-cpus", "2",
                   "--num-workers", "1"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, cwd=str(tmp_path))

        def run(*args, timeout=120):
            return subprocess.run(cli + list(args), capture_output=True,
                                  text=True, timeout=timeout, env=env,
                                  cwd=str(tmp_path))

        deadline = time.monotonic() + 90
        while True:
            st = run("status", "--address", address)
            alive = re.findall(r"^\s+\[\d+\] \S+ ALIVE", st.stdout, re.M)
            if len(alive) == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        assert st.returncode == 0 and len(alive) == 2, st.stdout

        driver = tmp_path / "driver.py"
        driver.write_text(
            "import sys, ray_tpu_torch as ray\n"
            "ray.init(address=sys.argv[1])\n"
            "@ray.remote\n"
            "def sq(x):\n"
            "    return x * x\n"
            "print('job_result', sum(ray.get([sq.remote(i) "
            "for i in range(10)])))\n"
            "ray.shutdown()\n")
        job = run("job", "--", sys.executable, str(driver), f"'{address}'",
                  timeout=300)
        assert job.returncode == 0, job.stdout + job.stderr
        assert "job_result 285" in job.stdout
        assert "status: SUCCEEDED" in job.stdout

        for verb, args, path in (
                ("timeline", ["-o", "tl.json"], "tl.json"),
                ("trace", ["--latest", "-o", "tr.json"], "tr.json"),
                ("profile", ["-d", "1", "-o", "pr.folded"], "pr.folded")):
            out = run(verb, *args, "--address", address)
            assert out.returncode == 0, (verb, out.stdout, out.stderr)
            assert (tmp_path / path).stat().st_size > 0, verb
        assert json.loads((tmp_path / "tl.json").read_text())
        out = run("trace", "--address", address)
        assert out.returncode == 0 and "trace_id" in out.stdout
        out = run("logs", "--address", address)
        assert out.returncode == 0, out.stderr
    finally:
        head.send_signal(signal.SIGTERM)
        groups = [p.pid for p in (head, node) if p is not None]
        deadline = time.monotonic() + 60
        while any(_group_alive(g) for g in groups) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        left = {g: _group_alive(g) for g in groups}
        for g, pids in left.items():
            if pids:
                os.killpg(g, signal.SIGKILL)
    assert not any(left.values()), left
    assert head.wait(timeout=10) == 0
