"""The port's runtime core in thread mode (``ray_tpu_torch``): the cases of
``tests/test_core_api.py`` and ``tests/test_actor.py`` run on the port,
and a seeded random DAG program run through ``ray_tpu`` and through
``ray_tpu_torch`` with the same results.

Every case runs under three schedulers: the TensorScheduler with every
batch assigned by ``kernels.assign`` (its plain version: ``sched_device``
"cpu"), the TensorScheduler on numpy, and the EventScheduler oracle.
Every ``get`` and ``wait`` has a timeout, so a hang fails its test.
"""

import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as ray
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import worker as worker_mod

T = 30  # seconds any get/wait may take

SCHEDULERS = {
    "device": dict(scheduler="tensor",
                   _system_config={"sched_backend": "cuda",
                                   "sched_device": "cpu"}),
    "numpy": dict(scheduler="tensor",
                  _system_config={"sched_backend": "numpy"}),
    "event": dict(scheduler="event"),
}


@pytest.fixture(params=sorted(SCHEDULERS))
def rt(request):
    """A fresh thread-mode runtime with 4 workers under each scheduler."""
    ray.shutdown()
    ray.init(num_workers=4, **SCHEDULERS[request.param])
    try:
        yield request.param
    finally:
        ray.shutdown()


@ray.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value


# -- tests/test_core_api.py ------------------------------------------------

def test_put_get(rt):
    ref = ray.put(42)
    assert ray.get(ref, timeout=T) == 42
    assert ray.get([ref, ref], timeout=T) == [42, 42]
    with pytest.raises(TypeError):
        ray.put(ref)


def test_put_get_keeps_a_tensor_by_reference(rt):
    """Thread mode hands back the very tensor put() was given (a CUDA
    tensor stays on its card; only serialization copies to the host)."""
    import torch

    t = torch.arange(6, dtype=torch.bfloat16)
    assert ray.get(ray.put(t), timeout=T) is t


def test_simple_task_and_fanout(rt):
    @ray.remote
    def f(i):
        return i * i

    assert ray.get(f.remote(3), timeout=T) == 9
    assert ray.get([f.remote(i) for i in range(100)],
                   timeout=T) == [i * i for i in range(100)]


def test_objectref_dependency_chain(rt):
    @ray.remote
    def add(a, b):
        return a + b

    x = add.remote(1, 2)
    y = add.remote(x, 3)
    assert ray.get(add.remote(y, x), timeout=T) == 9


def test_map_reduce_dag(rt):
    @ray.remote
    def mapper(i):
        return i

    @ray.remote
    def reducer(*parts):
        return sum(parts)

    maps = [mapper.remote(i) for i in range(20)]
    assert ray.get(reducer.remote(*maps), timeout=T) == sum(range(20))


def test_kwargs_and_nested_refs(rt):
    @ray.remote
    def f(a, b=0):
        return a + b

    @ray.remote
    def kinds(lst):
        return [type(v).__name__ for v in lst]

    ref = ray.put(5)
    assert ray.get(f.remote(1, b=ref), timeout=T) == 6
    # only top-level args are resolved (reference semantics)
    assert ray.get(kinds.remote([ref]), timeout=T) == ["ObjectRef"]


def test_num_returns_and_mismatch(rt):
    @ray.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @ray.remote(num_returns=2)
    def wrong():
        return (1, 2, 3)

    assert ray.get(list(three.remote()), timeout=T) == [1, 2, 3]
    a, _b = wrong.remote()
    with pytest.raises(ValueError):
        ray.get(a, timeout=T)


def test_generator_task(rt):
    @ray.remote
    def gen(n):
        yield from range(n)

    assert ray.get(gen.remote(4), timeout=T) == [0, 1, 2, 3]


def test_exception_propagation_and_cascade(rt):
    class CustomError(Exception):
        pass

    @ray.remote
    def boom():
        raise CustomError("bad")

    @ray.remote
    def consume(x):
        return x

    ref = boom.remote()
    with pytest.raises(CustomError):
        ray.get(ref, timeout=T)
    with pytest.raises(rex.TaskError):
        ray.get(ref, timeout=T)
    with pytest.raises(CustomError):
        ray.get(consume.remote(ref), timeout=T)


def test_wait_basics_and_timeout(rt):
    gate = threading.Event()

    @ray.remote
    def fast():
        return "fast"

    @ray.remote
    def slow():
        gate.wait(T)
        return "slow"

    refs = [slow.remote(), fast.remote()]
    ready, not_ready = ray.wait(refs, num_returns=1, timeout=T)
    assert len(ready) == 1 and len(not_ready) == 1
    assert ray.get(ready[0], timeout=T) == "fast"
    ready, not_ready = ray.wait(refs, num_returns=2, timeout=0.1)
    assert len(ready) == 1 and len(not_ready) == 1
    gate.set()
    ready, not_ready = ray.wait(refs, num_returns=2, timeout=T)
    assert len(ready) == 2 and not not_ready
    with pytest.raises(ValueError):
        ray.wait([ray.put(1)], num_returns=2, timeout=T)
    with pytest.raises(TypeError):
        ray.wait(ray.put(1), timeout=T)


def test_get_timeout(rt):
    gate = threading.Event()

    @ray.remote
    def blocked():
        gate.wait(T)

    ref = blocked.remote()
    with pytest.raises(rex.GetTimeoutError):
        ray.get(ref, timeout=0.1)
    gate.set()
    assert ray.get(ref, timeout=T) is None


def test_options_override(rt):
    @ray.remote
    def f():
        return 1

    assert ray.get(f.options(num_cpus=2).remote(), timeout=T) == 1
    assert ray.get(f.options(num_tpus=0).remote(), timeout=T) == 1  # alias
    with pytest.raises(ValueError):
        f.options(bogus=1)


def test_retries(rt):
    attempts, picky_attempts = [], []

    @ray.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    @ray.remote(max_retries=5, retry_exceptions=[KeyError])
    def picky():
        picky_attempts.append(1)
        if len(picky_attempts) == 1:
            raise KeyError("retry me")
        raise ValueError("don't retry me")

    assert ray.get(flaky.remote(), timeout=T) == "ok"
    assert len(attempts) == 3
    with pytest.raises(ValueError):
        ray.get(picky.remote(), timeout=T)
    assert len(picky_attempts) == 2


def test_no_retry_by_default_on_app_error(rt):
    attempts = []

    @ray.remote
    def boom():
        attempts.append(1)
        raise RuntimeError("app error")

    with pytest.raises(RuntimeError):
        ray.get(boom.remote(), timeout=T)
    assert attempts == [1]


def test_cancel_multi_return_resolves_all_refs(rt):
    ev = threading.Event()

    @ray.remote
    def gate():
        ev.wait(T)
        return 1

    @ray.remote(num_returns=3)
    def multi(x):
        return x, x + 1, x + 2

    a, b, c = multi.remote(gate.remote())
    ray.cancel(a)
    ev.set()
    for ref in (a, b, c):
        with pytest.raises(rex.TaskCancelledError):
            ray.get(ref, timeout=T)


def test_remote_function_direct_call_raises(rt):
    @ray.remote
    def f():
        return 1

    with pytest.raises(TypeError):
        f()
    assert f.func() == 1
    # .bind builds a DAG node (ray_tpu_torch.dag) instead of calling f
    from ray_tpu_torch.dag import FunctionNode

    node = f.bind()
    assert isinstance(node, FunctionNode) and node.func is f.func
    assert node.execute() == 1


def test_resources_api(rt):
    total = ray.cluster_resources()
    assert total["CPU"] == 4
    # column 1 is the GPU: the host's CUDA devices (none here)
    assert total["GPU"] == worker_mod._detect_gpu_count() == 0
    assert ray.available_resources()["CPU"] <= total["CPU"]
    assert ray.nodes()[0]["Resources"]["GPU"] == 0


def test_ref_serialization_and_runtime_context(rt):
    ref = ray.put("payload")
    assert ray.get(pickle.loads(pickle.dumps(ref)), timeout=T) == "payload"
    ctx = ray.get_runtime_context()
    assert len(ctx.get_job_id()) == 8

    @ray.remote
    def task_ctx():
        return ray.get_runtime_context().get_task_id()

    tid = ray.get(task_ctx.remote(), timeout=T)
    assert len(tid) == 32 and tid != ctx.get_task_id()


def test_large_numpy_roundtrip(rt):
    arr = np.arange(1 << 18, dtype=np.float32)
    out = ray.get(ray.put(arr), timeout=T)
    assert out.dtype == arr.dtype and (out == arr).all()


@pytest.mark.parametrize("case", ["loop", "refs", "errors", "multi", "deps"])
def test_map_remote(rt, case):
    @ray.remote
    def sq(x):
        return x * x

    @ray.remote
    def boom(i):
        if i == 3:
            raise ValueError("batch boom")
        return i

    @ray.remote(num_returns=2)
    def pair(x):
        return x, -x

    @ray.remote
    def total(*xs):
        return sum(xs)

    if case == "loop":
        refs = sq.map_remote([(i,) for i in range(50)])
        assert ray.get(refs, timeout=T) == [i * i for i in range(50)]
    elif case == "refs":
        refs = sq.map_remote([(i,) for i in range(10)])
        assert ray.get(total.remote(*refs), timeout=T) == sum(
            i * i for i in range(10))
    elif case == "errors":
        refs = boom.map_remote([(i,) for i in range(5)])
        with pytest.raises(ValueError, match="batch boom"):
            ray.get(refs, timeout=T)
        assert ray.get([r for i, r in enumerate(refs) if i != 3],
                       timeout=T) == [0, 1, 2, 4]
    elif case == "multi":
        out = pair.map_remote([(1,), (2,)])
        assert [ray.get(list(p), timeout=T) for p in out] == [[1, -1],
                                                               [2, -2]]
    else:
        base = ray.put(21)
        assert ray.get(sq.map_remote([(base,)] * 3),
                       timeout=T) == [441] * 3


# -- tests/test_actor.py ---------------------------------------------------

def test_actor_basic_and_init_args(rt):
    c = Counter.remote()
    assert ray.get(c.incr.remote(), timeout=T) == 1
    assert ray.get(c.incr.remote(5), timeout=T) == 6
    assert ray.get(c.get.remote(), timeout=T) == 6
    assert ray.get(Counter.remote(100).get.remote(), timeout=T) == 100


def test_actor_ordering_and_isolation(rt):
    a, b = Counter.remote(), Counter.remote()
    refs = [a.incr.remote() for _ in range(50)]
    assert ray.get(refs, timeout=T) == list(range(1, 51))
    assert ray.get(b.get.remote(), timeout=T) == 0


def test_actor_method_exception_does_not_kill(rt):
    @ray.remote
    class Fragile:
        def boom(self):
            raise KeyError("oops")

        def ok(self):
            return "fine"

    f = Fragile.remote()
    with pytest.raises(KeyError):
        ray.get(f.boom.remote(), timeout=T)
    assert ray.get(f.ok.remote(), timeout=T) == "fine"


def test_actor_init_failure(rt):
    @ray.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("cannot construct")

        def m(self):
            return 1

    with pytest.raises((RuntimeError, rex.ActorError)):
        ray.get(Broken.remote().m.remote(), timeout=T)


def test_kill_and_named_actor(rt):
    c = Counter.options(name="counter1").remote(5)
    ray.get(c.get.remote(), timeout=T)  # created
    assert ray.get(ray.get_actor("counter1").get.remote(), timeout=T) == 5
    with pytest.raises(ValueError):
        Counter.options(name="counter1").remote()
    ray.kill(c)
    with pytest.raises(rex.ActorError):
        ray.get(c.incr.remote(), timeout=T)
    with pytest.raises(ValueError):
        ray.get_actor("counter1")


def test_kill_ends_the_actors_threads_and_frees_its_instance(rt):
    """Every thread of a killed actor exits and its instance is freed:
    an actor holding a model must not keep it (and its device memory)
    after kill. The reference's stop() drains its inbox after queueing
    the threads' sentinels, which swallows them."""
    import gc
    import weakref

    import torch

    @ray.remote(max_concurrency=4)
    class Holder:
        def __init__(self):
            self.model = torch.zeros(1 << 16)

        def ref(self):
            return weakref.ref(self.model)

    a = Holder.remote()
    held = ray.get(a.ref.remote(), timeout=T)
    prefix = f"actor-{a._actor_id.hex()[:8]}"
    assert any(t.name.startswith(prefix) for t in threading.enumerate())
    ray.kill(a)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            held() is not None
            or any(t.name.startswith(prefix) for t in threading.enumerate())):
        gc.collect()
        time.sleep(0.02)
    assert not any(t.name.startswith(prefix) for t in threading.enumerate())
    assert held() is None


def test_kill_wakes_the_threads_start_has_not_listed_yet(rt):
    """kill() may run while the runtime's start() has started an actor's
    threads but not yet listed them all (the first thread runs __init__
    and the first calls meanwhile): stop() wakes one thread for each of
    the actor's max_concurrency, not for each thread listed, and drops the
    instance, so every thread ends and the instance is freed."""
    import gc
    import weakref

    import torch

    @ray.remote(max_concurrency=4)
    class Holder:
        def __init__(self):
            self.model = torch.zeros(1 << 16)

        def ref(self):
            return weakref.ref(self.model)

    a = Holder.remote()
    held = ray.get(a.ref.remote(), timeout=T)
    runtime = a._runtime()
    # as if start() were still listing threads 1-3 when kill() came
    del runtime._threads[1:]
    del runtime
    prefix = f"actor-{a._actor_id.hex()[:8]}"
    ray.kill(a)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            held() is not None
            or any(t.name.startswith(prefix) for t in threading.enumerate())):
        gc.collect()
        time.sleep(0.02)
    assert not any(t.name.startswith(prefix) for t in threading.enumerate())
    assert held() is None


def test_concurrent_puts_outside_tasks_get_their_own_objects(rt):
    """put() from concurrent actor calls (max_concurrency > 1) and from
    plain driver threads: every ref reads back its own value. Outside a
    task the reference numbers puts per thread under the driver's task
    id, so two threads' first puts share an id and one reads the other's
    object (serve's prefill replicas put each session's KV this way)."""
    @ray.remote(max_concurrency=8)
    class Putter:
        def put(self, i):
            time.sleep(0.001 * (i % 3))
            return ray.put(("actor", i))

    a = Putter.remote()
    refs = ray.get([a.put.remote(i) for i in range(64)], timeout=T)
    out = {}

    def driver_thread(i):
        out[i] = ray.put(("thread", i))

    threads = [threading.Thread(target=driver_thread, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert ray.get(refs, timeout=T) == [("actor", i) for i in range(64)]
    assert ray.get([out[i] for i in range(16)], timeout=T) == [
        ("thread", i) for i in range(16)]
    assert len({r.object_id() for r in refs + list(out.values())}) == 80


def test_actor_handle_serialized_and_passed_to_task(rt):
    @ray.remote
    def use_actor(handle):
        return ray.get(handle.incr.remote(10), timeout=T)

    c = Counter.remote(7)
    assert ray.get(pickle.loads(pickle.dumps(c)).get.remote(),
                   timeout=T) == 7
    assert ray.get(use_actor.remote(c), timeout=T) == 17


def test_async_and_threaded_actors(rt):
    @ray.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio
            await asyncio.sleep(0.01)
            return x * 2

    @ray.remote(max_concurrency=4)
    class Slow:
        def work(self):
            time.sleep(0.2)
            return 1

    w = AsyncWorker.remote()
    assert ray.get([w.work.remote(i) for i in range(10)],
                   timeout=T) == [i * 2 for i in range(10)]
    s = Slow.remote()
    ray.get(s.work.remote(), timeout=T)      # created
    t0 = time.monotonic()
    ray.get([s.work.remote() for _ in range(4)], timeout=T)
    assert time.monotonic() - t0 < 0.7


def test_actor_restart(rt):
    @ray.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    p = Phoenix.remote()
    assert ray.get(p.incr.remote(), timeout=T) == 1
    ray.kill(p, no_restart=False)
    time.sleep(0.1)
    assert ray.get(p.incr.remote(), timeout=T) == 1


def test_actor_refs_as_args_and_gpu_option(rt):
    @ray.remote
    class Adder:
        def add(self, a, b):
            return a + b

    a = Adder.remote()
    assert ray.get(a.add.remote(ray.put(41), 1), timeout=T) == 42
    # num_gpus is the accelerator option (num_tpus its alias): a demand on
    # the resource vector's column 1
    from ray_tpu_torch._private.task_spec import resources_to_vector
    from ray_tpu_torch.remote_function import _build_resources

    for opts in (Adder.options(num_gpus=1)._options,
                 Adder.options(num_tpus=1)._options):
        res = _build_resources(opts)
        assert res == {"CPU": 1.0, "GPU": 1.0}
        assert resources_to_vector(res) == (1.0, 1.0, 0.0, 0.0)


def test_concurrency_groups(rt):
    release = threading.Event()

    @ray.remote(concurrency_groups={"io": 1, "compute": 2})
    class Split:
        @ray.method(concurrency_group="io")
        def slow_io(self):
            release.wait(timeout=T)
            return "io"

        @ray.method(concurrency_group="compute")
        def fast(self, x):
            return x * 2

    a = Split.remote()
    blocked = a.slow_io.remote()
    assert ray.get(a.fast.remote(21), timeout=T) == 42
    release.set()
    assert ray.get(blocked, timeout=T) == "io"
    ray.kill(a)


# -- the same program through the reference and the port ---------------------

def _random_program(api, seed, n=60):
    """A seeded random DAG: each task adds a constant to up to three
    earlier tasks' results (ObjectRef arguments), some tasks fail and
    their dependants inherit the error, and an actor folds a running sum.
    Returns every task's result (or the error's type name), then the
    actor's sums."""
    rng = np.random.default_rng(seed)

    @api.remote
    def node(c, *parents):
        if c % 7 == 0:
            raise ValueError(f"node {c}")
        return c + sum(parents)

    @api.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    refs = []
    for i in range(n):
        k = int(rng.integers(0, min(i, 3) + 1))
        parents = [refs[j] for j in rng.choice(i, size=k, replace=False)] \
            if k else []
        refs.append(node.remote(int(rng.integers(1, 100)), *parents))
    out = []
    for r in refs:
        try:
            out.append(api.get(r, timeout=T))
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
    acc = Acc.remote()
    sums = api.get([acc.add.remote(v) for v in out if isinstance(v, int)],
                   timeout=T)
    return out, sums


@pytest.mark.parametrize("seed", range(3))
def test_random_program_matches_reference(seed):
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=4, scheduler="tensor")
    try:
        want = _random_program(ray_tpu, seed)
    finally:
        ray_tpu.shutdown()
    ray.shutdown()
    ray.init(num_workers=4, **SCHEDULERS["device"])
    try:
        got = _random_program(ray, seed)
    finally:
        ray.shutdown()
    assert got == want
    assert any("ValueError" in v for v in got[0] if isinstance(v, str))


# -- the port's own rules ----------------------------------------------------

def test_tensor_scheduler_needs_cuda_unless_cpu():
    """No CPU fallback: scheduler="tensor" on a backend that launches
    (auto, cuda) raises on a host without CUDA unless sched_device="cpu";
    numpy never launches and runs."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ray.shutdown()
    try:
        for cfg in ({}, {"sched_backend": "cuda"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ray.init(num_workers=2, scheduler="tensor",
                         _system_config=cfg)
            assert not ray.is_initialized()
            ray.shutdown()
        ray.init(num_workers=2, scheduler="tensor",
                 _system_config={"sched_backend": "numpy"})
        assert ray.get(ray.put(1), timeout=T) == 1
    finally:
        ray.shutdown()


@pytest.mark.parametrize("knobs", [
    {"worker_mode": "process", "profile_hz": 10.0},
    {"qos": True}, {"profile_hz": 10.0}])
def test_unported_modes_raise(knobs):
    """The modes this test once found refused (the QoS and profile
    planes, ROADMAP.md Queue A item 6) are ported: each knob set now
    inits, builds its plane and runs a task; no init raises for them."""
    ray.shutdown()
    try:
        ray.init(num_workers=2, scheduler="event", _system_config=knobs)
        w = ray._worker.get_worker()
        assert (w.qos_plane is not None) == bool(knobs.get("qos"))
        assert (w.profile_plane is not None) == ("profile_hz" in knobs)
        f = ray.remote(lambda x: x + 1)
        assert ray.get(f.remote(1), timeout=T) == 2
    finally:
        ray.shutdown()


@pytest.mark.parametrize("refused", ["process", "cuda", "unknown_knob"])
def test_refused_init_leaves_no_setting_behind(refused):
    """A refused init resets every knob it applied: the next init (no
    shutdown between them) runs with the defaults."""
    import torch

    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if refused == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: sched_backend=cuda runs")
    kwargs, exc = {
        # process mode runs now; with tenant quotas that do not parse it
        # is refused before anything starts
        "process": ({"scheduler": "event", "_system_config": {
            "task_max_retries": 7, "worker_mode": "process",
            "qos": True, "tenant_quotas": '{"p": 0}'}}, ValueError),
        "cuda": ({"scheduler": "tensor", "_system_config": {
            "task_max_retries": 7, "sched_backend": "cuda"}}, RuntimeError),
        "unknown_knob": ({"scheduler": "event", "_system_config": {
            "task_max_retries": 7, "worker_tpu_access": True}}, KeyError),
    }[refused]
    ray.shutdown()
    try:
        with pytest.raises(exc):
            ray.init(num_workers=2, **kwargs)
        assert not ray.is_initialized()
        ray.init(num_workers=2, scheduler="tensor",
                 _system_config={"sched_device": "cpu"})
        assert GLOBAL_CONFIG.worker_mode == "thread"
        assert GLOBAL_CONFIG.sched_backend == "auto"
        assert GLOBAL_CONFIG.task_max_retries == 3
        assert ray.get(ray.put(1), timeout=T) == 1
    finally:
        ray.shutdown()


@pytest.mark.parametrize("knob", [
    "worker_tpu_access", "utilization_interval_s", "utilization_ring",
    "sched_jax_min_batch", "tenant_quotas", "preempt_grace_s",
    "profile_stacks_max"])
def test_reference_knobs_without_code_are_unknown(knob):
    """Knobs of code the port does not have are not defined: setting one
    raises instead of being accepted and ignored (worker_tpu_access,
    sched_jax_min_batch: JAX's, with GPU counterparts). The five knobs of
    the optional planes came back with the planes: each is defined
    with the reference's default."""
    from ray_tpu._private.config import GLOBAL_CONFIG as REF_CONFIG
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    assert knob in REF_CONFIG.snapshot()
    if knob in ("worker_tpu_access", "sched_jax_min_batch"):
        with pytest.raises(KeyError):
            GLOBAL_CONFIG.set(knob, REF_CONFIG.get(knob))
    else:
        assert GLOBAL_CONFIG.get(knob) == REF_CONFIG.get(knob)


def test_remote_nodes_and_clients_raise():
    """Remote nodes, the head endpoint and ray:// clients run now
    (tests/test_torch_remote_node.py, tests/test_torch_client.py); what
    still raises: an address init cannot connect to (not ray://, or
    without the head's key), a node of either kind that declares GPUs
    its workers cannot see, and rebinding the head endpoint."""
    ray.shutdown()
    try:
        with pytest.raises(ValueError, match="ray://"):
            ray.init(address="127.0.0.1:1")
        with pytest.raises(ValueError, match="key"):
            ray.init(address="ray://127.0.0.1:1")
        assert not ray.is_initialized()
        ray.init(num_workers=2, scheduler="event")
        w = worker_mod.get_worker()
        for call in (w.add_cluster_node, w.add_remote_cluster_node):
            with pytest.raises(ValueError, match="worker_gpu_access"):
                call(num_cpus=1, num_gpus=1)
        server = w.enable_head_endpoint()
        assert w.enable_head_endpoint() is server
        with pytest.raises(RuntimeError, match="already bound"):
            w.enable_head_endpoint(port=server.address[1] + 1)
    finally:
        ray.shutdown()


def test_env_prefix_is_the_ports_own(monkeypatch):
    """RAY_TPU_* configures the reference only; RAY_TPU_TORCH_* the port."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    monkeypatch.setenv("RAY_TPU_TASK_MAX_RETRIES", "9")
    monkeypatch.setenv("RAY_TPU_TORCH_SCHED_DEVICE_MIN_BATCH", "77")
    GLOBAL_CONFIG.reset()
    try:
        assert GLOBAL_CONFIG.task_max_retries == 3
        assert GLOBAL_CONFIG.sched_device_min_batch == 77
    finally:
        monkeypatch.delenv("RAY_TPU_TORCH_SCHED_DEVICE_MIN_BATCH")
        GLOBAL_CONFIG.reset()


def test_likely_large_sizes_tensors():
    import torch

    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    limit = GLOBAL_CONFIG.inline_object_max_bytes
    assert worker_mod._likely_large(torch.zeros(limit // 2 + 1,
                                                dtype=torch.bfloat16))
    assert not worker_mod._likely_large(torch.zeros(limit // 4,
                                                    dtype=torch.float32))
    assert worker_mod._likely_large(np.zeros(limit + 1, dtype=np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_serialization_moves_tensors_out_of_band(dtype):
    import torch

    from ray_tpu_torch._private.serialization import deserialize, serialize

    t = (torch.arange(24) % 5).to(getattr(torch, dtype)).reshape(4, 6)[:, 1::2]
    obj = serialize({"x": [t], "ref": 3})
    assert len(obj.buffers) == 1 and obj.buffers[0].nbytes == t.nbytes
    back = deserialize(obj)["x"][0]
    assert back.dtype == t.dtype and torch.equal(back, t)
