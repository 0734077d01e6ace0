"""Command-line interface: python -m ray_tpu_torch <command>.

Reference surface: the ray CLI (ray: python/ray/scripts/scripts.py —
start / status / microbenchmark / job submit / logs / timeline).
``start --head`` runs a head that serves ``ray://`` clients and joining
nodes until SIGTERM; ``start --address`` joins this machine as a node
daemon. Inspection commands connect over ``--address``, start an
ephemeral session (status, microbenchmark) or scrape a running driver's
Prometheus endpoint (status --metrics-port).

The verbs and flags are ``ray_tpu``'s. ``start --jax-coordinator
--jax-num-processes --jax-process-id`` joins the ``torch.distributed``
process group (parallel/distributed.py ``init_multihost``; set
``RAY_TPU_TORCH_DIST_DEVICE=cpu`` for ranks on the CPU). ``lint`` runs
raylint's eight static passes over this package (``_private/analysis``,
``--json``, ``--update-baseline``, ``--changed-only``). One verb is
refused: ``bench`` (the port's benchmark is not written yet; the root
``bench.py`` measures ``ray_tpu``, not the port).

On a host without CUDA, set ``RAY_TPU_TORCH_SCHED_DEVICE=cpu`` (the
config registry's environment override) so a head's scheduler runs its
plain path on the host; every other knob takes the same
``RAY_TPU_TORCH_<KNOB>`` form, e.g. ``RAY_TPU_TORCH_QOS=1``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _status_over_address(address: str) -> int:
    """One-shot cluster health summary over ray://: node table (state,
    REJOINING grace, daemon outbox depth), task counts, and the latest
    utilization snapshot per node — which carries the head's internal
    gauges (scheduler queue depths, inflight leases, failover count)
    when the cluster runs with profile_hz > 0."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=address)
    try:
        nodes = state.list_nodes()
        print(f"nodes ({len(nodes)}):")
        for n in nodes:
            line = (f"  [{n['index']}] {n['node_id'][:12]} "
                    f"{n['state']:<9} {n['kind']:<7} "
                    f"hb={n['heartbeat_age_s']:.1f}s")
            if "rejoining_for_s" in n:
                line += f" rejoining_for={n['rejoining_for_s']:.1f}s"
            if "outbox_depth" in n:
                line += (f" outbox={n['outbox_depth']}"
                         f" replayed={n['outbox_replayed']}")
            print(line)
        print("tasks:")
        for k, v in sorted(state.summarize_tasks().items()):
            print(f"  {k}: {v}")
        util = state.list_utilization()
        latest: dict = {}
        for r in util:
            if r["points"]:
                latest.setdefault(r["node"], {})[r["series"]] = \
                    r["points"][-1][1]
        if latest:
            print("utilization (latest sample per node):")
            for node in sorted(latest):
                kv = " ".join(f"{s}={latest[node][s]:g}"
                              for s in sorted(latest[node]))
                print(f"  [{node}] {kv}")
        else:
            print("utilization: no samples (head runs with "
                  "profile_hz=0?)")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def _cmd_status(args) -> int:
    if args.metrics_port:
        import urllib.request

        url = f"http://127.0.0.1:{args.metrics_port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        print(body)
        return 0
    if args.address:
        return _status_over_address(args.address)
    import os

    import ray_tpu_torch

    ray_tpu_torch.init(ignore_reinit_error=True)
    print("node resources:")
    for k, v in ray_tpu_torch.cluster_resources().items():
        if v and v < 1e17:
            print(f"  {k}: {v}")
    print(f"  worker_mode: "
          f"{ray_tpu_torch._config.worker_mode}")
    print(f"  cpus detected: {os.cpu_count()}")
    try:
        import torch

        n = torch.cuda.device_count()
        print(f"  cuda devices ({n}): "
              f"{[torch.cuda.get_device_name(i) for i in range(n)]}")
    except Exception as e:  # noqa: BLE001
        print(f"  cuda unavailable: {e}")
    ray_tpu_torch.shutdown()
    return 0


def _cmd_start(args) -> int:
    """Run a head serving remote clients + joining nodes, or a node
    daemon joining a head (reference: `ray start --head` /
    `ray start --address=...`)."""
    import json as _json
    import os
    import signal

    # multi-process device runtime: join the torch.distributed process
    # group BEFORE any device use, so this process is a rank of the
    # global mesh (the reference joins the jax.distributed coordinator
    # here). A rank flag without a coordinator (argument or
    # RAY_TPU_JAX_COORDINATOR) is an error, not ignored.
    joined = False
    if (args.jax_coordinator or args.jax_num_processes
            or args.jax_process_id >= 0):
        from ray_tpu_torch.parallel import distributed

        joined = distributed.init_multihost(
            args.jax_coordinator or None,
            args.jax_num_processes or None,
            args.jax_process_id if args.jax_process_id >= 0 else None)
        if not joined:
            raise ValueError("start --jax-num-processes/--jax-process-id "
                             "need --jax-coordinator (or "
                             "RAY_TPU_JAX_COORDINATOR)")
        import torch.distributed as dist

        print(f"ray_tpu_torch rank {dist.get_rank()} of "
              f"{dist.get_world_size()} joined "
              f"({distributed.backend()} on {distributed.device()})",
              flush=True)

    if args.head:
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        resources = _json.loads(args.resources) if args.resources else None
        kw = dict(ignore_reinit_error=True, resources=resources)
        if args.num_cpus:
            kw["num_cpus"] = args.num_cpus
        if args.num_workers:
            kw["num_workers"] = args.num_workers
        sys_cfg = {}
        if args.worker_mode:
            sys_cfg["worker_mode"] = args.worker_mode
        if args.gcs_journal:
            # control-plane FT: journal GCS mutations; a restarted head
            # replays them and re-adopts rejoining node daemons
            sys_cfg["gcs_journal_path"] = args.gcs_journal
        if sys_cfg:
            kw["_system_config"] = sys_cfg
        ray_tpu_torch.init(**kw)
        plan_json = os.environ.get("RAY_TPU_TORCH_CHAOS_PLAN", "")
        if plan_json:
            # seeded failure drills against a subprocess head: the
            # failover soak arms a head-site kill this way, so the head
            # SIGKILLs ITSELF at a deterministic health-loop arrival
            # (same seed + plan -> same blackout point)
            from ray_tpu_torch import chaos as _chaos
            plan = _json.loads(plan_json)
            _chaos.arm(_chaos.FaultPlan(
                plan["seed"], faults=plan.get("faults", ())))
            print(f"ray_tpu_torch head: chaos plan armed (seed={plan['seed']},"
                  f" {len(plan.get('faults', []))} fault(s))", flush=True)
        w = worker_mod.get_worker()
        hs = w.enable_head_endpoint(host=args.host, port=args.port)
        host, port = hs.address
        connect = f"ray://{host}:{port}?key={hs.authkey.hex()}"
        print(f"ray_tpu_torch head started.\n"
              f"  connect a driver:  ray_tpu_torch.init(address={connect!r})\n"
              f"  join a node:       python -m ray_tpu_torch start "
              f"--address='{connect}'", flush=True)
        import threading
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        try:
            stop.wait()  # Event.wait: no lost-signal window, EINTR-safe
        except KeyboardInterrupt:
            pass
        ray_tpu_torch.shutdown()
        if joined:
            from ray_tpu_torch.parallel import distributed

            distributed.shutdown_multihost()
        return 0

    if not args.address:
        print("usage: start --head | start --address=ray://host:port?key=..",
              file=sys.stderr)
        return 2
    from ray_tpu_torch._private.client import parse_client_address
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.runtime.node_daemon import NodeDaemon

    host, port, key = parse_client_address(args.address)
    if key is None:
        print("the address must include ?key=... (printed by the head)",
              file=sys.stderr)
        return 2
    info = dict(num_cpus=args.num_cpus or 4.0,
                num_workers=args.num_workers or 0,
                resources=_json.loads(args.resources)
                if args.resources else {})
    daemon = NodeDaemon((host, port), key, "join",
                        GLOBAL_CONFIG.object_store_memory,
                        GLOBAL_CONFIG.inline_object_max_bytes,
                        join_info=info,
                        rejoin_timeout_s=GLOBAL_CONFIG
                        .daemon_rejoin_timeout_s)
    print(f"ray_tpu_torch node joined head at {host}:{port} "
          f"(pid {os.getpid()})", flush=True)
    daemon.run()
    return 0


def _cmd_microbenchmark(args) -> int:
    from ray_tpu_torch._private import perf

    for mode in ("thread", "process"):
        r = perf.e2e_task_throughput(n_tasks=args.num_tasks,
                                     system_config={"worker_mode": mode})
        print(f"{mode}: {r['tasks_per_sec']:.0f} tasks/s "
              f"({r['n_tasks']} tasks in {r['seconds']:.2f}s)")
    return 0


def _cmd_bench(args) -> int:
    # the root bench.py measures ray_tpu (the JAX package), not the port;
    # running it here would report the wrong system
    print("bench: the port's benchmark is not written yet (no "
          "BENCHMARK.json); python3 chip_smoke.py drives and times every "
          "path of the port on the card", file=sys.stderr)
    return 2


def _cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    entry = list(args.entrypoint)
    if entry and entry[0] == "--":  # argparse REMAINDER keeps the --
        entry = entry[1:]
    if not entry:
        print("usage: python -m ray_tpu_torch job -- <command ...>",
              file=sys.stderr)
        return 2
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=" ".join(entry))
    print(f"submitted {job_id}")
    if args.no_wait:
        print(f"logs: {client._job(job_id).log_path}")
        return 0
    status = client.wait_until_finish(job_id, timeout=args.timeout)
    print(client.get_job_logs(job_id), end="")
    print(f"status: {status}")
    return 0 if status == "SUCCEEDED" else 1


def _cmd_logs(args) -> int:
    """List / print session log files (reference: `ray logs`).

    Three sources, in order of preference: a running cluster over
    ``--address ray://...`` (uses the list_logs/get_log state verbs,
    including off-head nodes), an explicit ``--session-dir``, or the
    newest ``session_*/logs`` under ``$TMPDIR/ray_tpu_torch`` on this machine
    (postmortem reads straight off disk — no cluster needed)."""
    from ray_tpu_torch._private import log_plane

    if args.address:
        import ray_tpu_torch
        from ray_tpu_torch.util import state

        ray_tpu_torch.init(address=args.address)
        try:
            if args.filename:
                text = state.get_log(args.filename,
                                     node_id=args.node_id or None,
                                     tail=args.tail or None)
                print(text, end="" if text.endswith("\n") else "\n")
            else:
                rows = state.list_logs(args.node_id or None)
                if not rows:
                    print("no log files")
                for r in rows:
                    print(f"{r['size_bytes']:>10}  "
                          f"node={r.get('node_id', '')[:12]:<12}  "
                          f"{r['filename']}")
        finally:
            ray_tpu_torch.shutdown()
        return 0

    log_dir = args.session_dir or log_plane.latest_session_log_dir()
    if not log_dir:
        print(f"no session log dir found under {log_plane.default_root()} "
              "(pass --session-dir or --address)", file=sys.stderr)
        return 2
    if args.filename:
        try:
            text = log_plane.read_log(log_dir, args.filename,
                                      args.tail or None)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 2
        print(text, end="" if text.endswith("\n") else "\n")
        return 0
    print(f"session log dir: {log_dir}")
    rows = log_plane.list_log_files(log_dir)
    if not rows:
        print("no log files")
    for r in rows:
        print(f"{r['size_bytes']:>10}  {r['filename']}")
    return 0


def _cmd_timeline(args) -> int:
    """Dump the cluster's chrome-trace timeline to a JSON file
    (reference: `ray timeline`). Connects over ray:// so the trace is
    rendered head-side from the task event plane — spans from every
    node land on one aligned clock axis."""
    if not args.address:
        print("timeline needs --address ray://host:port?key=... "
              "(printed by `python -m ray_tpu_torch start --head`)",
              file=sys.stderr)
        return 2
    import ray_tpu_torch

    ray_tpu_torch.init(address=args.address)
    try:
        path = ray_tpu_torch.timeline(args.output)
        with open(path) as f:
            n = len(json.load(f))
        print(f"wrote {path} ({n} events) — open in "
              f"chrome://tracing or https://ui.perfetto.dev")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def _cmd_trace(args) -> int:
    """List traces or export one as Perfetto JSON (the distributed
    sibling of `timeline`: one trace's causal tree — driver, scheduler
    and per-node exec lanes with parent/child flow arrows)."""
    if not args.address:
        print("trace needs --address ray://host:port?key=... "
              "(printed by `python -m ray_tpu_torch start --head`)",
              file=sys.stderr)
        return 2
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=args.address)
    try:
        if not args.trace_id and not args.latest:
            rows = state.list_traces()
            if not rows:
                print("no traces recorded (is trace_sample_rate 0?)")
                return 0
            print(f"{'trace_id':18} {'root':28} {'spans':>6} "
                  f"{'live':>5} {'failed':>7}")
            for r in rows:
                print(f"{r['trace_id'][:16]:18} "
                      f"{(r['root'] or '?')[:28]:28} {r['spans']:>6} "
                      f"{r['live_spans']:>5} {r['failed']:>7}")
            return 0
        path = ray_tpu_torch.trace(args.trace_id or None, args.output)
        with open(path) as f:
            n = len(json.load(f))
        print(f"wrote {path} ({n} events) — open in "
              f"chrome://tracing or https://ui.perfetto.dev")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def _cmd_profile(args) -> int:
    """Profile the running cluster for a window and print the
    top-tasks-by-CPU table, optionally exporting the flamegraph
    (requires the head to run with profile_hz > 0)."""
    if not args.address:
        print("profile needs --address ray://host:port?key=... "
              "(printed by `python -m ray_tpu_torch start --head`)",
              file=sys.stderr)
        return 2
    import ray_tpu_torch

    ray_tpu_torch.init(address=args.address)
    try:
        report = ray_tpu_torch.profile(args.duration)
        if not report["samples"]:
            print("no samples recorded over the window (head runs "
                  "with profile_hz=0?)")
            return 1
        print(f"{report['samples']} samples over "
              f"{args.duration:.1f}s")
        print(f"{'node':>4} {'task':36} {'samples':>8} {'cpu%':>6}")
        for r in report["top_tasks"]:
            print(f"{r['node']:>4} {r['task'][:36]:36} "
                  f"{r['samples']:>8} {r['cpu_pct']:>6.1f}")
        if args.output:
            if args.output.endswith((".txt", ".folded")):
                with open(args.output, "w") as f:
                    f.write(report["collapsed"])
            else:
                with open(args.output, "w") as f:
                    json.dump(report["speedscope"], f)
            print(f"wrote {args.output} — open in "
                  f"https://www.speedscope.app")
    finally:
        ray_tpu_torch.shutdown()
    return 0


def _cmd_summary(args) -> int:
    """Summarize a timeline JSON produced by ray_tpu_torch.timeline()."""
    with open(args.trace) as f:
        events = json.load(f)
    spans = [e for e in events if e.get("ph") == "X"]
    by_name: dict = {}
    for e in spans:
        st = by_name.setdefault(e["name"], [0, 0.0])
        st[0] += 1
        st[1] += e.get("dur", 0.0) / 1e6
    print(f"{'task':40} {'count':>8} {'total_s':>10}")
    for name, (count, total) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1]):
        print(f"{name[:40]:40} {count:>8} {total:>10.3f}")
    return 0


def _changed_files() -> "set":
    """Repo-relative paths changed vs ``git merge-base HEAD main``
    (committed, staged and unstaged), for ``lint --changed-only``."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        base = subprocess.run(
            ["git", "merge-base", "HEAD", "main"], cwd=repo,
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", base], cwd=repo,
            capture_output=True, text=True, timeout=10, check=True)
    except (OSError, subprocess.SubprocessError):
        return set()
    return {ln.strip() for ln in diff.stdout.splitlines() if ln.strip()}


def _cmd_lint(args) -> int:
    """Run the analysis plane — the eight framework-invariant static
    passes (lock order, shared state, wire protocol, knobs, registries,
    ref lifecycle, closure capture, blocking calls) over the installed
    ray_tpu_torch package. Exit 1 on findings not covered by
    analysis/baseline.json."""
    from ray_tpu_torch._private import analysis

    report = analysis.run_all()
    if getattr(args, "changed_only", False):
        changed = _changed_files()
        # findings carry package-relative paths; the diff is
        # repo-relative with the ray_tpu_torch/ prefix
        def touched(f):
            return f.file and ("ray_tpu_torch/" + f.file).replace(
                os.sep, "/") in changed
        report.new = [f for f in report.new if touched(f)]
        report.baselined = [f for f in report.baselined if touched(f)]
        report.stale_suppressions = []  # not decidable from a diff
    if args.update_baseline:
        analysis.save_baseline([f.key for f in report.findings])
        print(f"baseline updated: {len(report.findings)} suppression(s)"
              f" written to {analysis.BASELINE_PATH}")
        return 0
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.render_text())
    return 0 if report.ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch",
        description="ray_tpu_torch command line interface")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start a head (serving clients and "
                       "joining nodes) or join as a node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head")
    p.add_argument("--num-cpus", type=float, default=0)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--resources", default="",
                   help='JSON dict of named resources, e.g. \'{"a": 2}\'')
    p.add_argument("--worker-mode", default="",
                   choices=["", "thread", "process"])
    p.add_argument("--gcs-journal", default="",
                   help="GCS write-ahead journal path; restarting the "
                   "head with the same path restores its tables and "
                   "re-adopts surviving node daemons")
    p.add_argument("--jax-coordinator", default="",
                   help="join the torch.distributed process group at "
                   "host:port (or a tcp:// or file:// address) as rank "
                   "--jax-process-id of --jax-num-processes")
    p.add_argument("--jax-num-processes", type=int, default=0)
    p.add_argument("--jax-process-id", type=int, default=-1)
    p.set_defaults(fn=_cmd_start)

    p = sub.add_parser("status", help="show node/cluster resources, or "
                       "a running cluster's health over --address")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="scrape a running driver's metrics endpoint")
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head: "
                   "one-shot health summary (nodes, outbox depth, "
                   "utilization snapshot, queue depths)")
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("microbenchmark",
                       help="task throughput micro-benchmark")
    p.add_argument("--num-tasks", type=int, default=2000)
    p.set_defaults(fn=_cmd_microbenchmark)

    p = sub.add_parser("bench", help="refused: the port's benchmark is "
                       "not written yet")
    p.add_argument("--smoke", action="store_true")
    p.set_defaults(fn=_cmd_bench)

    p = sub.add_parser("job", help="submit a driver script as a job")
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="command to run (everything after 'job')")
    p.set_defaults(fn=_cmd_job)

    p = sub.add_parser("logs", help="list or print session log files")
    p.add_argument("filename", nargs="?", default="",
                   help="capture file to print (omit to list files)")
    p.add_argument("--tail", type=int, default=0,
                   help="print only the last N lines")
    p.add_argument("--node-id", default="",
                   help="node id (hex, prefix ok); default: head/local")
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head "
                   "(reads over the cluster instead of local disk)")
    p.add_argument("--session-dir", default="",
                   help="explicit session logs dir (default: newest "
                   "$TMPDIR/ray_tpu_torch/session_*/logs)")
    p.set_defaults(fn=_cmd_logs)

    p = sub.add_parser("timeline", help="dump the cluster task "
                       "timeline (chrome-trace JSON)")
    p.add_argument("-o", "--output", default="trace.json",
                   help="output path (default: trace.json)")
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head")
    p.set_defaults(fn=_cmd_timeline)

    p = sub.add_parser("trace", help="list distributed traces or "
                       "export one (Perfetto JSON)")
    p.add_argument("trace_id", nargs="?", default="",
                   help="trace id (hex, prefix ok); omit to list")
    p.add_argument("--latest", action="store_true",
                   help="export the most recently active trace")
    p.add_argument("-o", "--output", default="trace_tree.json",
                   help="output path (default: trace_tree.json)")
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("profile", help="flamegraph + top-tasks-by-CPU "
                       "from the continuous profiler")
    p.add_argument("-d", "--duration", type=float, default=5.0,
                   help="profiling window in seconds (default: 5)")
    p.add_argument("-o", "--output", default="",
                   help="write the flamegraph here: speedscope JSON, "
                   "or folded-stack text for .txt/.folded names")
    p.add_argument("--address", default="",
                   help="ray://host:port?key=... of a running head")
    p.set_defaults(fn=_cmd_profile)

    p = sub.add_parser("summary", help="summarize a timeline trace")
    p.add_argument("trace", help="JSON from ray_tpu_torch.timeline(file)")
    p.set_defaults(fn=_cmd_summary)

    p = sub.add_parser("lint", help="run raylint static-analysis "
                       "passes over the package")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite analysis/baseline.json to suppress "
                   "every current finding")
    p.add_argument("--changed-only", action="store_true",
                   help="report only findings in files changed vs "
                   "`git merge-base HEAD main` (all passes still run "
                   "— cross-file invariants need the whole repo)")
    p.set_defaults(fn=_cmd_lint)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
