"""The port's process mode on the CPU: tasks, actors and large objects in
exec'd worker processes, with the TensorScheduler's device path on the
host (sched_device "cpu"), through one module-scoped runtime of 2 workers.

Mirrors tests/test_process_mode.py (TestProcessTasks, TestProcessActors,
TestWorkerActorCalls) and tests/test_control_ring.py's end-to-end tests.
The reference is imported only inside the tests that run it: workers
unpickle functions of this module by value (registered below), and a
worker must never load jax, flax or ray_tpu.
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as ray
import ray_tpu_torch.exceptions as rex
from ray_tpu_torch import chaos

cloudpickle.register_pickle_by_value(sys.modules[__name__])

T = 60
REF_MODULES = ("jax", "flax", "ray_tpu")
PROCESS = {"worker_mode": "process", "sched_device": "cpu",
           "object_store_memory": 64 * 1024 * 1024}


@pytest.fixture(scope="module")
def proc_ray():
    """One process-mode runtime for the module, returned once both
    workers have dialed back (their interpreters import torch, which on
    a loaded host takes seconds: a test of concurrency across processes
    must not race the second worker's start)."""
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config=PROCESS)
    deadline = time.time() + 120
    while not all(h.ready for h in _pool()._handles):
        assert time.time() < deadline, "process workers never came up"
        time.sleep(0.02)
    yield ray
    ray.shutdown()


def _worker():
    return ray._private.worker.global_worker


def _pool():
    return _worker().process_pool


def _wait_for(pred, timeout=30.0):
    """Poll pred; each poll first drains the driver's deferred
    out-of-scope queue, as its API entry points do."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        _worker()._drain_out_of_scope()
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class TestProcessTasks:
    def test_tasks_run_in_separate_processes(self, proc_ray):
        @ray.remote
        def whoami(i):
            return (i, os.getpid())

        out = ray.get([whoami.remote(i) for i in range(8)], timeout=T)
        assert sorted(i for i, _ in out) == list(range(8))
        pids = {p for _, p in out}
        assert os.getpid() not in pids
        assert pids <= set(_pool().pids())

    def test_workers_load_no_reference_and_see_no_card(self, proc_ray):
        @ray.remote
        def probe():
            return (sorted(m for m in sys.modules
                           if m.split(".")[0] in REF_MODULES),
                    os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid())

        mods, visible, pid = ray.get(probe.remote(), timeout=T)
        assert pid != os.getpid()
        assert mods == []
        assert visible == ""         # no worker_gpu_access: card hidden
        assert ray.cluster_resources().get("GPU", 0.0) == 0.0

    def test_concurrent_execution_across_processes(self, proc_ray):
        @ray.remote
        def windowed():
            t0 = time.monotonic()
            time.sleep(0.5)
            return (os.getpid(), t0, time.monotonic())

        a, b = ray.get([windowed.remote(), windowed.remote()], timeout=T)
        assert a[0] != b[0]
        assert a[1] < b[2] and b[1] < a[2]

    def test_dependency_chain_and_map_reduce(self, proc_ray):
        @ray.remote
        def inc(x):
            return x + 1

        @ray.remote
        def add(*xs):
            return sum(xs)

        ref = ray.put(0)
        for _ in range(5):
            ref = inc.remote(ref)
        assert ray.get(ref, timeout=T) == 5
        maps = [inc.remote(i) for i in range(20)]
        assert ray.get(add.remote(*maps), timeout=T) == sum(range(1, 21))

    def test_num_returns(self, proc_ray):
        @ray.remote(num_returns=3)
        def three():
            return 1, 2, 3

        assert ray.get(list(three.remote()), timeout=T) == [1, 2, 3]

    @pytest.mark.parametrize("kind", ["numpy", "tensor"])
    def test_large_objects_via_shm_zero_copy(self, proc_ray, kind):
        @ray.remote
        def make(n, kind):
            if kind == "numpy":
                return np.arange(n, dtype=np.float64)
            return torch.arange(n, dtype=torch.float64)

        @ray.remote
        def total(a, b):
            return float(a.sum() + b.sum())

        a = make.remote(200_000, kind)            # 1.6 MB >> inline
        b = make.remote(50_000, kind)
        got = ray.get(total.remote(a, b), timeout=T)
        assert got == float(np.arange(200_000).sum()
                            + np.arange(50_000).sum())
        w = _worker()
        assert w.shm_store.contains(a.object_id())
        arr = ray.get(a, timeout=T)
        # the driver's copy is a zero-copy view into the arena, pinned
        assert w.shm_store._pins.get(a.object_id(), 0) >= 1
        if kind == "numpy":
            assert not arr.flags["OWNDATA"]
        else:
            import ctypes

            base = ctypes.addressof(
                ctypes.c_char.from_buffer(w.shm_store.arena._shm.buf))
            assert base <= arr.data_ptr() < base + w.shm_store.arena.size
        assert arr[-1] == 199_999.0

    def test_put_tensor_comes_back_as_a_view_and_frees(self, proc_ray):
        w = _worker()
        t = torch.arange(1 << 17, dtype=torch.int64)     # 1 MiB
        ref = ray.put(t)
        oid = ref.object_id()
        assert w.shm_store.contains(oid)

        @ray.remote
        def total(x):
            return int(x.sum())

        assert ray.get(total.remote(ref), timeout=T) == int(t.sum())
        back = ray.get(ref, timeout=T)
        assert torch.equal(back, t) and back.data_ptr() != t.data_ptr()
        del back, ref
        assert _wait_for(lambda: not w.shm_store.contains(oid)
                         and not w.shm_store._pins.get(oid))

    def test_shm_freed_when_out_of_scope(self, proc_ray):
        w = _worker()

        @ray.remote
        def make():
            return np.zeros(300_000, dtype=np.float64)

        ref = make.remote()
        ray.get(ref, timeout=T)
        oid = ref.object_id()
        assert w.shm_store.contains(oid)
        del ref
        assert _wait_for(lambda: not w.shm_store.contains(oid))

    def test_borrower_registered_across_process_boundary(self, proc_ray):
        w = _worker()

        @ray.remote
        def hold(refs):
            time.sleep(1.0)
            return ray.get(refs[0])

        inner = ray.put("payload")
        out = hold.remote([inner])
        assert _wait_for(lambda: w.reference_counter.stats()[
            "borrowed_total"] > 0)
        assert ray.get(out, timeout=T) == "payload"
        assert _wait_for(lambda: w.reference_counter.stats()[
            "borrowed_total"] == 0)

    def test_error_propagation(self, proc_ray):
        @ray.remote
        def boom():
            raise ValueError("kapow")

        with pytest.raises(ValueError, match="kapow"):
            ray.get(boom.remote(), timeout=T)

    def test_app_retries(self, proc_ray, tmp_path):
        marker = str(tmp_path / "attempts")

        @ray.remote(max_retries=3, retry_exceptions=True)
        def flaky(path):
            n = int(open(path).read()) if os.path.exists(path) else 0
            open(path, "w").write(str(n + 1))
            if n < 2:
                raise RuntimeError("transient")
            return "ok"

        assert ray.get(flaky.remote(marker), timeout=90) == "ok"
        assert int(open(marker).read()) == 3

    def test_worker_crash_retries_and_pool_recovers(self, proc_ray,
                                                    tmp_path):
        marker = str(tmp_path / "crashed")

        @ray.remote(max_retries=2)
        def die_once(path):
            if not os.path.exists(path):
                open(path, "w").close()
                os._exit(17)
            return "survived"

        assert ray.get(die_once.remote(marker), timeout=120) == "survived"

        @ray.remote
        def ping():
            return os.getpid()

        assert isinstance(ray.get(ping.remote(), timeout=T), int)

    def test_force_cancel_kills_worker_process(self, proc_ray):
        @ray.remote
        def spin():
            time.sleep(120)
            return 1

        ref = spin.remote()
        time.sleep(0.8)
        ray.cancel(ref, force=True)
        with pytest.raises(rex.TaskCancelledError):
            ray.get(ref, timeout=T)

    def test_deadline_kills_the_attempt(self, proc_ray):
        @ray.remote(timeout_s=0.5, max_retries=0)
        def sleepy():
            time.sleep(30)
            return 1

        with pytest.raises(rex.TaskTimeoutError):
            ray.get(sleepy.remote(), timeout=T)

    def test_get_put_inside_task(self, proc_ray):
        @ray.remote
        def inner(refs):
            return ray.put(ray.get(refs[0]) * 2)

        out_ref = ray.get(inner.remote([ray.put(21)]), timeout=T)
        assert ray.get(out_ref, timeout=T) == 42

    def test_nested_task_submission_from_worker(self, proc_ray):
        @ray.remote
        def leaf(x):
            return x * 10

        @ray.remote
        def parent(x):
            return ray.get(leaf.remote(x + 1))

        assert ray.get(parent.remote(3), timeout=90) == 40

    def test_num_gpus_without_card_access_never_runs(self, proc_ray):
        """The workers cannot see the card, so the head advertises no GPU
        and a num_gpus task stays unscheduled instead of running on the
        host's CPU; cancelling it resolves its ref."""
        @ray.remote(num_gpus=1)
        def on_card():
            return "ran"

        ref = on_card.remote()
        with pytest.raises(rex.GetTimeoutError):
            ray.get(ref, timeout=1.0)
        ray.cancel(ref)
        with pytest.raises(rex.TaskCancelledError):
            ray.get(ref, timeout=T)


class TestProcessActors:
    def test_actor_state_in_separate_process(self, proc_ray):
        @ray.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def incr(self, k=1):
                self.n += k
                return self.n

            def pid(self):
                return os.getpid()

        c = Counter.remote(10)
        assert ray.get([c.incr.remote() for _ in range(5)],
                       timeout=T) == [11, 12, 13, 14, 15]
        apid = ray.get(c.pid.remote(), timeout=T)
        assert apid != os.getpid() and apid not in _pool().pids()
        ray.kill(c)

    def test_actor_method_error_keeps_actor_alive(self, proc_ray):
        @ray.remote
        class A:
            def __init__(self):
                self.n = 0

            def boom(self):
                raise ValueError("actor boom")

            def incr(self):
                self.n += 1
                return self.n

        a = A.remote()
        with pytest.raises(ValueError, match="actor boom"):
            ray.get(a.boom.remote(), timeout=T)
        assert ray.get(a.incr.remote(), timeout=T) == 1
        ray.kill(a)

    def test_actor_process_crash_marks_dead(self, proc_ray):
        @ray.remote
        class D:
            def die(self):
                os._exit(3)

            def ping(self):
                return "pong"

        d = D.remote()
        assert ray.get(d.ping.remote(), timeout=T) == "pong"
        d.die.remote()
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                ray.get(d.ping.remote(), timeout=10)
                time.sleep(0.2)
            except rex.ActorDiedError:
                break
        else:
            pytest.fail("actor never reported dead after process crash")

    def test_actor_crash_restart(self, proc_ray):
        @ray.remote(max_restarts=1)
        class R:
            def __init__(self):
                self.n = 100

            def incr(self):
                self.n += 1
                return self.n

            def pid(self):
                return os.getpid()

            def die(self):
                os._exit(5)

        r = R.remote()
        assert ray.get(r.incr.remote(), timeout=T) == 101
        pid1 = ray.get(r.pid.remote(), timeout=T)
        r.die.remote()
        deadline = time.time() + 60
        pid2 = None
        while time.time() < deadline:
            try:
                pid2 = ray.get(r.pid.remote(), timeout=10)
                break
            except rex.ActorDiedError:
                time.sleep(0.2)
        assert pid2 is not None and pid2 != pid1
        assert ray.get(r.incr.remote(), timeout=T) == 101
        ray.kill(r)

    def test_kill_actor_ends_its_process(self, proc_ray):
        @ray.remote
        class K:
            def pid(self):
                return os.getpid()

        k = K.remote()
        pid = ray.get(k.pid.remote(), timeout=T)
        ray.kill(k)
        with pytest.raises(rex.ActorDiedError):
            ray.get(k.pid.remote(), timeout=T)

        def gone():
            try:
                with open(f"/proc/{pid}/stat") as f:
                    return f.read().split(")")[-1].split()[0] == "Z"
            except OSError:
                return True

        assert _wait_for(gone)

    def test_large_args_through_shm_to_actor(self, proc_ray):
        @ray.remote
        class S:
            def total(self, arr):
                return float(arr.sum())

        s = S.remote()
        big = ray.put(torch.ones(300_000, dtype=torch.float64))
        assert ray.get(s.total.remote(big), timeout=T) == 300_000.0
        ray.kill(s)

    def test_a_burst_of_actor_processes_all_come_up(self, proc_ray):
        """Actor processes started together dial the pool at once (two
        connections each): every one must register."""
        @ray.remote
        class P:
            def pid(self):
                return os.getpid()

        actors = [P.remote() for _ in range(8)]
        pids = ray.get([a.pid.remote() for a in actors], timeout=120)
        assert len(set(pids)) == 8
        for a in actors:
            ray.kill(a)

    def test_threaded_actor_stays_host_side(self, proc_ray):
        @ray.remote(max_concurrency=2)
        class H:
            def pid(self):
                return os.getpid()

        h = H.remote()
        assert ray.get(h.pid.remote(), timeout=T) == os.getpid()
        ray.kill(h)


class TestWorkerActorCalls:
    def test_actor_call_from_process_task(self, proc_ray):
        @ray.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        @ray.remote
        def feed(counter, k):
            return ray.get(counter.add.remote(k))

        c = Counter.remote()
        out = ray.get([feed.remote(c, 1) for _ in range(4)], timeout=T)
        assert sorted(out) == [1, 2, 3, 4]
        assert ray.get(c.add.remote(0), timeout=T) == 4


class TestRingEndToEnd:
    def test_tasks_flow_over_ring(self, proc_ray):
        @ray.remote
        def double(i):
            return i * 2

        before = dict(_pool().ring_stats)
        out = ray.get([double.remote(i) for i in range(32)], timeout=T)
        assert out == [i * 2 for i in range(32)]
        stats = _pool().ring_stats
        assert stats["msgs"] > before["msgs"]
        assert stats["bytes"] > before["bytes"]
        for h in _pool()._handles:
            assert h.ring_in is not None and h.ring_out is not None

    def test_map_remote_vectorized_over_ring(self, proc_ray):
        @ray.remote
        def sq(i):
            return i * i

        refs = sq.map_remote([(i,) for i in range(64)])
        assert ray.get(refs, timeout=T) == [i * i for i in range(64)]

    def test_control_ring_metrics_read_the_pool(self, proc_ray):
        from ray_tpu_torch._private import metrics

        text = metrics.render_all(_worker())
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("ray_tpu_control_ring_msgs_total"))
        assert float(line.split()[-1]) == _pool().ring_stats["msgs"] > 0

    def test_worker_sigkill_mid_ring_retries_and_reinits(self, proc_ray):
        chaos.arm(chaos.FaultPlan(77, faults=[("worker", 0, "kill")]))
        try:
            @ray.remote(max_retries=3)
            def work(i):
                time.sleep(0.02)
                return i + 100

            out = ray.get([work.remote(i) for i in range(16)], timeout=120)
            assert sorted(out) == [i + 100 for i in range(16)]
            ctr = chaos.counters()
            assert ctr["injected"]["worker"] >= 1
            assert ctr["recovered"]["worker"] >= 1
        finally:
            chaos.disarm()
        assert _wait_for(lambda: len([h for h in _pool()._handles
                                      if not h.dead]) >= 2 and all(
            h.ring_in is not None and h.ring_out is not None
            for h in _pool()._handles if not h.dead))

        @ray.remote
        def ping():
            return os.getpid()

        assert isinstance(ray.get(ping.remote(), timeout=T), int)
