"""Process mode on the CPU, one runtime a test: the control ring switched
off and overflowing to the pipe, the sanitizer's wire checks over ring
traffic, spilled objects as task arguments, runtime environments in worker
processes, the worker log capture, a process-backed cluster node with
GPUs, and a seeded random program through the reference and the port in
process mode with equal results.

Mirrors tests/test_control_ring.py (the ring-off, oversized-envelope and
sanitizer tests) and tests/test_process_mode.py::TestSpilling. Functions
of this module go to workers by value; the reference is imported only
inside the test that runs it.
"""

import os
import sys
import time

import cloudpickle
import pytest
import torch

import ray_tpu_torch as ray

cloudpickle.register_pickle_by_value(sys.modules[__name__])

T = 60
PROCESS = {"worker_mode": "process", "sched_device": "cpu",
           "object_store_memory": 32 * 1024 * 1024}


def _runtime(num_workers=2, **knobs):
    ray.shutdown()
    return ray.init(num_workers=num_workers, scheduler="tensor",
                    _system_config={**PROCESS, **knobs})


def _pool():
    return ray._private.worker.global_worker.process_pool


def test_ring_off_restores_pipe_behavior():
    _runtime(control_ring=False)
    try:
        @ray.remote
        def f(i):
            return i * 3

        assert ray.get([f.remote(i) for i in range(16)],
                       timeout=T) == [i * 3 for i in range(16)]
        pool = _pool()
        assert pool.ring_stats == {"msgs": 0, "bytes": 0, "fallback": 0,
                                   "full_waits": 0}
        for h in pool._handles:
            assert h.ring_in is None and h.ring_out is None
    finally:
        ray.shutdown()


def test_oversized_envelope_falls_back_to_pipe():
    _runtime(control_ring_slot_bytes=256)
    try:
        @ray.remote
        def tail(s):
            return s[-4:]

        big = "y" * 4096
        assert ray.get([tail.remote(big) for _ in range(4)],
                       timeout=T) == ["yyyy"] * 4
        assert _pool().ring_stats["fallback"] >= 1
    finally:
        ray.shutdown()


def test_sanitizer_wire_checks_over_ring_traffic():
    from ray_tpu_torch._private.analysis import runtime_sanitizer

    ray.shutdown()
    runtime_sanitizer.arm()
    try:
        _runtime()

        @ray.remote
        def f(i):
            return i + 1

        assert ray.get([f.remote(i) for i in range(16)],
                       timeout=T) == list(range(1, 17))
        assert _pool().ring_stats["msgs"] > 0
        assert runtime_sanitizer.wire_violations() == []
        ray.shutdown()                        # files the report
        rep = runtime_sanitizer.last_report()
        assert rep is not None and rep["wire_violations"] == []
        runtime_sanitizer.check_wire("worker_to_owner", ("done", b"x"))
        assert runtime_sanitizer.wire_violations() == [
            "[worker_to_owner] tag 'done' arrived with arity 2, static "
            "senders produce [4]"]
    finally:
        ray.shutdown()
        runtime_sanitizer.disarm()


def test_spilled_objects_as_task_args_restore_exactly():
    """Tensors larger than the arena can hold together: the puts spill,
    and each restores from disk as a task argument and through get."""
    _runtime(object_store_memory=1 << 20)
    try:
        big = [torch.full((40_000,), float(i), dtype=torch.float64)
               for i in range(4)]
        refs = [ray.put(b) for b in big]
        w = ray._worker.get_worker()
        assert w.shm_store.num_spilled_objects() >= 1

        @ray.remote
        def total(a):
            return float(a.sum())

        assert ray.get([total.remote(r) for r in refs], timeout=T) == [
            40_000.0 * i for i in range(4)]
        for r, b in zip(refs, big):
            assert torch.equal(ray.get(r, timeout=T), b)
        assert w.shm_store.num_restored >= 1
    finally:
        ray.shutdown()


def test_runtime_env_in_worker_processes(tmp_path):
    """working_dir and env_vars apply inside the worker process: for a
    task's duration, and for a process actor's whole lifetime."""
    (tmp_path / "envmod_port.py").write_text("VALUE = 41\n")
    _runtime()
    try:
        env = {"working_dir": str(tmp_path),
               "env_vars": {"PORT_ENV_PROBE": "on"}}

        @ray.remote(runtime_env=env)
        def task():
            import envmod_port

            return envmod_port.VALUE + 1, os.environ["PORT_ENV_PROBE"]

        @ray.remote(runtime_env=env)
        class Actor:
            def value(self):
                import envmod_port

                return (envmod_port.VALUE, os.environ["PORT_ENV_PROBE"],
                        os.getpid())

        assert ray.get(task.remote(), timeout=T) == (42, "on")
        a = Actor.remote()
        value, probe, pid = ray.get(a.value.remote(), timeout=T)
        assert (value, probe) == (41, "on") and pid != os.getpid()
        ray.kill(a)
    finally:
        ray.shutdown()


def test_worker_output_lands_in_its_capture_file():
    _runtime(trace_log_markers=True)
    try:
        w = ray._worker.get_worker()

        @ray.remote
        def speak():
            print("process-mode hello", flush=True)
            return os.getpid()

        ray.get(speak.remote(), timeout=T)
        log_dir = w.session_log_dir
        deadline = time.time() + 10
        found = marked = False
        while time.time() < deadline and not (found and marked):
            text = "".join(open(os.path.join(log_dir, f)).read()
                           for f in os.listdir(log_dir)
                           if f.startswith("worker-") and f.endswith(".out"))
            found = "process-mode hello" in text
            marked = "== trace " in text
            time.sleep(0.1)
        assert found and marked
    finally:
        ray.shutdown()


def test_add_cluster_node_with_gpus():
    """A thread-mode head gains a process-backed node declaring GPUs (its
    workers given the card): num_gpus tasks run there, in its worker
    processes, and the node's GPUs appear in cluster_resources."""
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config={
        "sched_device": "cpu", "worker_gpu_access": True,
        "object_store_memory": 32 * 1024 * 1024})
    try:
        w = ray._worker.get_worker()
        head_gpus = ray.cluster_resources().get("GPU", 0.0)
        entry = w.add_cluster_node(num_cpus=2, num_gpus=2, num_workers=2)
        assert entry.resources["GPU"] == 2
        assert ray.cluster_resources()["GPU"] == head_gpus + 2
        pool = w.pool_for_node(entry.index)

        @ray.remote(num_gpus=1)
        def where():
            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        out = ray.get([where.remote() for _ in range(4)], timeout=T)
        assert {p for p, _ in out} <= set(pool.pids())
        # given the card, a worker inherits the driver's visibility
        assert {v for _, v in out} == {
            os.environ.get("CUDA_VISIBLE_DEVICES")}
    finally:
        ray.shutdown()


@pytest.mark.parametrize("seed", range(2))
def test_random_program_matches_reference_in_process_mode(seed):
    import ray_tpu

    from test_torch_runtime import _random_program

    cfg = {"worker_mode": "process", "object_store_memory": 32 << 20}
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=2, scheduler="tensor", _system_config=cfg)
    try:
        want = _random_program(ray_tpu, seed, n=40)
    finally:
        ray_tpu.shutdown()
    _runtime()
    try:
        got = _random_program(ray, seed, n=40)
    finally:
        ray.shutdown()
    assert got == want
    assert any("ValueError" in v for v in got[0] if isinstance(v, str))


def test_exec_spans_from_worker_processes():
    """A task that fans out to three children from inside a worker
    process: one trace, its four spans finished on worker lanes, with
    dispatch and spawn flow arrows (the trace context crosses the
    process boundary with each nested submission)."""
    _runtime()
    try:
        @ray.remote
        def leaf(x):
            return x + 1

        @ray.remote
        def fan(x):
            return sum(ray.get([leaf.remote(x + i) for i in range(3)]))

        assert ray.get(fan.remote(10), timeout=T) == 36
        tp = ray._worker.get_worker().trace_plane
        deadline = time.time() + 10
        while time.time() < deadline:
            rows = [r for r in tp.list_traces()
                    if (r["root"] or "").endswith("fan")]
            if rows and rows[0]["spans"] == 4:
                break
            time.sleep(0.05)
        assert rows and rows[0]["spans"] == 4 and not rows[0]["failed"]
        events = tp.trace(rows[0]["trace_id"])
        assert sum(e.get("ph") in ("s", "f") for e in events) >= 4
        lanes = {e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        assert any(name.startswith("worker") for name in lanes), lanes
    finally:
        ray.shutdown()
