"""The port's TensorScheduler (``ray_tpu_torch/_private/scheduler/tensor.py``):
the cases of ``tests/test_tensor_scheduler.py`` (end to end, multi-node
spillback, many classes, the dispatch window) on the port; its batched
assignment held to the reference's ``TensorScheduler._assign`` on the same
seeded snapshots; and the rule that a device assignment that raises fails
its tasks and is never retried on numpy.

The device path runs ``kernels.assign``'s plain version here
(``sched_device`` "cpu"); on the card the same code launches the CUDA
tick of ``ops/csrc/scheduler_tick.cu`` (``chip_smoke.py`` phase runtime).
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as ray
from ray_tpu._private.config import GLOBAL_CONFIG as REF_CONFIG
from ray_tpu._private.scheduler.tensor import TensorScheduler as RefScheduler
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import JobID, TaskID
from ray_tpu_torch._private.scheduler import kernels
from ray_tpu_torch._private.scheduler.base import PendingTask
from ray_tpu_torch._private.scheduler.local import NodeState
from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
from ray_tpu_torch._private.task_spec import TaskSpec

T = 30  # seconds any get/wait may take
BACKENDS = {"device": {"sched_backend": "cuda", "sched_device": "cpu"},
            "numpy": {"sched_backend": "numpy"}}


@pytest.fixture(params=sorted(BACKENDS))
def rt(request):
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor",
             _system_config=BACKENDS[request.param])
    try:
        yield request.param
    finally:
        ray.shutdown()


@pytest.fixture(params=sorted(BACKENDS))
def backend(request):
    """The port's config set for a bare TensorScheduler (no init)."""
    GLOBAL_CONFIG.reset()
    for k, v in BACKENDS[request.param].items():
        GLOBAL_CONFIG.set(k, v)
    try:
        yield request.param
    finally:
        GLOBAL_CONFIG.reset()


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.005)
    return cond()


# -- end to end (TestTensorSchedulerE2E) ---------------------------------------

def test_fanout_chain_and_map_reduce(rt):
    @ray.remote
    def f(i):
        return i * 2

    @ray.remote
    def r(*xs):
        return sum(xs)

    assert ray.get([f.remote(i) for i in range(200)],
                   timeout=T) == [i * 2 for i in range(200)]
    assert ray.get(r.remote(*[f.remote(i) for i in range(50)]),
                   timeout=T) == 2 * sum(range(50))
    ref = ray.put(0)
    for _ in range(30):
        ref = f.remote(ref)
    assert ray.get(ref, timeout=T) == 0


def test_error_propagation(rt):
    @ray.remote
    def boom():
        raise ValueError("boom")

    @ray.remote
    def use(x):
        return x

    with pytest.raises(ValueError):
        ray.get(use.remote(boom.remote()), timeout=T)


def test_resource_capacity_respected(rt):
    running, peak, lock = [], [0], threading.Lock()

    @ray.remote(num_cpus=2)
    def heavy():
        with lock:
            running.append(1)
            peak[0] = max(peak[0], len(running))
        time.sleep(0.02)
        with lock:
            running.pop()
        return 1

    assert sum(ray.get([heavy.remote() for _ in range(8)], timeout=T)) == 8
    assert peak[0] <= 2     # 4 CPUs: at most two 2-CPU tasks at once


def test_actors_on_tensor_sched(rt):
    @ray.remote
    class Counter:
        def __init__(self):
            self.x = 0

        def incr(self, n=1):
            self.x += n
            return self.x

    c = Counter.remote()
    assert ray.get([c.incr.remote() for _ in range(20)],
                   timeout=T) == list(range(1, 21))


def test_retry_releases_slot(rt):
    attempts = []

    @ray.remote(max_retries=2, retry_exceptions=True)
    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise ValueError("transient")
        return "ok"

    assert ray.get(flaky.remote(), timeout=T) == "ok"
    assert len(attempts) == 3
    sched = worker_mod.global_worker.scheduler
    assert _wait_for(lambda: sched.stats()["running"] == 0
                     and sched.stats()["ready_queue"] == 0)


def test_cancel_queued(rt):
    ev = threading.Event()

    @ray.remote
    def gate():
        ev.wait(T)
        return 1

    @ray.remote
    def after(x):
        return x

    dep = after.remote(gate.remote())
    ray.cancel(dep)
    ev.set()
    with pytest.raises(rex.TaskCancelledError):
        ray.get(dep, timeout=T)


def test_stats_count_device_assigns(rt):
    @ray.remote
    def f(i):
        return i

    assert ray.get([f.remote(i) for i in range(50)], timeout=T) == list(
        range(50))
    stats = worker_mod.global_worker.scheduler.stats()
    if rt == "device":
        assert stats["device_assigns"] > 0
    else:
        assert stats["device_assigns"] == 0
    assert stats["device_assign_errors"] == 0
    assert stats["calibration"]["state"] == "cold"


# -- multi-node (TestTensorSchedulerMultiNode) -----------------------------------

def _spec(i, cpus=1.0, strategy=None):
    return TaskSpec(task_id=TaskID.of(JobID.from_int(1), seq=i),
                    name=f"t{i}", func=None, func_descriptor="f", args=(),
                    kwargs={}, resources={"CPU": cpus},
                    scheduling_strategy=strategy)


def _bare(caps):
    dispatched, lock = [], threading.Lock()

    def dispatcher(task):
        with lock:
            dispatched.append(task)

    return (TensorScheduler([NodeState(c) for c in caps], dispatcher),
            dispatched, lock)


def test_spillback_to_second_node(backend):
    sched, dispatched, lock = _bare([(2.0, 0, 1e18, 1e18)] * 2)
    try:
        for i in range(4):
            sched.submit(PendingTask(spec=_spec(i), deps=[],
                                     execute=lambda t, n: None))
        assert _wait_for(lambda: len(dispatched) == 4)
        with lock:
            assert {t.node_index for t in dispatched} == {0, 1}
        assert (sched.stats()["device_assigns"] > 0) == (backend == "device")
    finally:
        sched.shutdown()


def test_queued_until_node_added(backend):
    sched, dispatched, lock = _bare([(1.0, 0, 1e18, 1e18)])
    try:
        sched.submit(PendingTask(spec=_spec(0, cpus=4.0), deps=[],
                                 execute=lambda t, n: None))
        time.sleep(0.1)
        assert not dispatched
        assert sched.stats()["infeasible"] == 1
        sched.add_node(NodeState((8.0, 0, 1e18, 1e18)))
        assert _wait_for(lambda: len(dispatched) == 1)
        assert dispatched[0].node_index == 1
    finally:
        sched.shutdown()


def test_spread_strategy_uses_every_node(backend):
    sched, dispatched, lock = _bare([(4.0, 0, 1e18, 1e18)] * 4)
    try:
        sched.submit_many([PendingTask(spec=_spec(i, strategy="SPREAD"),
                                       deps=[], execute=lambda t, n: None)
                           for i in range(8)])
        assert _wait_for(lambda: len(dispatched) == 8)
        with lock:
            counts = np.bincount([t.node_index for t in dispatched],
                                 minlength=4)
        assert counts.tolist() == [2, 2, 2, 2]
    finally:
        sched.shutdown()


# -- many classes (TestManyClasses) ----------------------------------------------

def test_many_classes_end_to_end(rt):
    """64 scheduling classes (one per CPU demand) in one batch."""
    @ray.remote
    def f(i):
        return i

    refs = [f.options(num_cpus=(1 + i % 64) / 64).remote(i)
            for i in range(128)]
    assert ray.get(refs, timeout=T) == list(range(128))
    sched = worker_mod.global_worker.scheduler
    assert len(sched._class_index) == 64


# -- the dispatch window (TestDispatchWindow, thread mode) ------------------------

def test_window_accounting_balances():
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor",
             _system_config={**BACKENDS["device"],
                             "worker_pipeline_depth": 4})
    try:
        @ray.remote
        def f(x):
            return x + 1

        assert ray.get([f.remote(i) for i in range(200)],
                       timeout=T) == [i + 1 for i in range(200)]
        sched = worker_mod.global_worker.scheduler
        assert sched._win_cap[0] == 8      # 4 leases per worker CPU
        assert _wait_for(lambda: sched._outstanding.sum() == 0)
        assert np.allclose(sched._avail[0], sched._cap[0])
        assert not sched._windowed.any()
    finally:
        ray.shutdown()


def test_window_excludes_constrained_classes():
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor", resources={"gadget": 1.0},
             _system_config={**BACKENDS["device"],
                             "worker_pipeline_depth": 8})
    try:
        @ray.remote(resources={"gadget": 1.0})
        def exclusive(i):
            t0 = time.monotonic()
            time.sleep(0.02)
            return (i, t0, time.monotonic())

        rows = ray.get([exclusive.remote(i) for i in range(6)], timeout=T)
        assert sorted(r[0] for r in rows) == list(range(6))
        spans = sorted((t0, t1) for _, t0, t1 in rows)
        for (_, prev_end), (next_start, _) in zip(spans, spans[1:]):
            assert next_start >= prev_end
        sched = worker_mod.global_worker.scheduler
        assert not all(sched._class_window_ok)
    finally:
        ray.shutdown()


# -- parity with the reference's TensorScheduler._assign ---------------------------

def _snapshot(seed, k, n_classes, n_nodes=8):
    """A port TensorScheduler snapshot: k ready tasks over n_classes
    classes on n_nodes nodes, dyadic demands and partly used avail; with
    many classes a random class mask and SPREAD classes; no locality
    column and no outstanding counts (both None), no QoS tiers."""
    rng = np.random.default_rng(seed)
    K, N = n_classes, n_nodes
    demands = np.zeros((K, 4), dtype=np.float32)
    demands[:, 0] = rng.integers(1, 4, K)
    demands[:, 1] = rng.choice([0.0, 0.25, 0.5], K)
    cap = np.zeros((N, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(4, 32, N)
    cap[:, 1] = rng.integers(0, 4, N)
    avail = cap.copy()
    avail[:, 0] -= rng.integers(0, 4, N)
    avail = np.maximum(avail, 0)
    many = K > 1
    mask = rng.random((K, N)) < 0.7 if many else np.ones((K, N), bool)
    spread = rng.random(K) < 0.3 if many else np.zeros(K, bool)
    ready_idx = np.sort(rng.choice(4 * k, size=k, replace=False))
    ready_cls = rng.integers(0, K, k).astype(np.int32)
    return (ready_idx, ready_cls, demands, avail, cap, mask, spread,
            None, None, None)


def _ref_snapshot(snap):
    """The same snapshot for the reference: the port's snapshot has the
    reference's layout (locality column and outstanding counts
    included)."""
    return snap


def _assign_with(sched, config, backend, snap):
    config.set("sched_backend", backend)
    try:
        ready_idx, node_of, avail = sched._assign(
            tuple(x.copy() if isinstance(x, np.ndarray) else x
                  for x in snap))
    finally:
        config.reset()
    return np.asarray(ready_idx), np.asarray(node_of), np.asarray(avail)


@pytest.fixture
def schedulers():
    node = [(8.0, 0.0, 1e18, 0.0)]
    from ray_tpu._private.scheduler.local import NodeState as RefNode

    ref = RefScheduler([RefNode(c) for c in node], lambda t: None)
    GLOBAL_CONFIG.reset()
    port = TensorScheduler([NodeState(c) for c in node], lambda t: None)
    try:
        yield ref, port
    finally:
        ref.shutdown()
        port.shutdown()
        GLOBAL_CONFIG.reset()


@pytest.mark.parametrize("n_classes", [1, 64])
@pytest.mark.parametrize("seed", range(3))
def test_assign_matches_reference_scheduler(schedulers, seed, n_classes):
    """The reference's _assign on numpy and on jax, the port's on numpy
    and on its device path (the plain version): numpy against numpy and
    jax against the device path give identical node_of and avail; numpy
    against the device path agree as the reference's own tests hold jax
    to numpy (SPREAD classes by per-node counts)."""
    ref, port = schedulers
    snap = _snapshot(seed, 96, n_classes)
    GLOBAL_CONFIG.set("sched_device", "cpu")
    ref_np = _assign_with(ref, REF_CONFIG, "numpy", _ref_snapshot(snap))
    ref_jax = _assign_with(ref, REF_CONFIG, "jax", _ref_snapshot(snap))
    port_np = _assign_with(port, GLOBAL_CONFIG, "numpy", snap)
    GLOBAL_CONFIG.set("sched_device", "cpu")
    port_dev = _assign_with(port, GLOBAL_CONFIG, "cuda", snap)
    for a, b in ((ref_np, port_np), (ref_jax, port_dev)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert port.stats()["device_assigns"] == 1
    node_np, node_dev = port_np[1], port_dev[1]
    assert np.array_equal(port_np[2], port_dev[2])
    spread_task = snap[6][snap[1]]
    assert np.array_equal(node_np[~spread_task], node_dev[~spread_task])
    for c in np.unique(snap[1][spread_task]):
        sel = snap[1] == c
        assert np.array_equal(np.bincount(node_np[sel] + 1, minlength=9),
                              np.bincount(node_dev[sel] + 1, minlength=9))


# -- no fallback -------------------------------------------------------------------

class _RaisingAssign:
    """Stands in for kernels.assign: records each call and raises."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        raise RuntimeError("device assign broke")


def test_device_assign_error_fails_tasks_without_numpy(monkeypatch):
    stub = _RaisingAssign()
    numpy_calls = []
    real_np = kernels.assign_np
    monkeypatch.setattr(kernels, "assign", stub)
    monkeypatch.setattr(kernels, "assign_np", lambda *a, **k: (
        numpy_calls.append(1), real_np(*a, **k))[1])
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor",
             _system_config=BACKENDS["device"])
    try:
        @ray.remote
        def f(i):
            return i

        refs = [f.remote(i) for i in range(5)]
        for ref in refs:
            with pytest.raises(rex.SchedulingError) as info:
                ray.get(ref, timeout=T)
            assert isinstance(info.value.__cause__, RuntimeError)
            assert "device assign broke" in str(info.value)
        stats = worker_mod.global_worker.scheduler.stats()
        assert stats["device_assign_errors"] == stub.calls > 0
        assert stats["device_assigns"] == 0
        assert not numpy_calls      # never retried on numpy
        assert stats["ready_queue"] == stats["running"] == 0
    finally:
        ray.shutdown()


def test_calibration_failure_is_kept_and_raised(monkeypatch, backend):
    """Under auto, a device error in calibration is recorded (stats) and
    raised by every later batch at or above sched_device_min_batch;
    smaller batches keep numpy."""
    stub = _RaisingAssign()
    monkeypatch.setattr(kernels, "assign", stub)
    GLOBAL_CONFIG.set("sched_backend", "auto")
    GLOBAL_CONFIG.set("sched_device", "cpu")
    sched, _dispatched, _lock = _bare([(8.0, 0, 1e18, 0)])
    try:
        snap = _snapshot(0, 128, 1, n_nodes=1)
        sched._np_cost = 1.0      # numpy "slow": calibration starts
        sched._assign(snap)
        assert _wait_for(lambda: sched._calib_state == "failed")
        calib = sched.stats()["calibration"]
        assert "device assign broke" in calib["error"]
        assert sched.stats()["device_assign_errors"] == 1
        with pytest.raises(RuntimeError, match="calibration") as info:
            sched._assign(snap)
        assert isinstance(info.value.__cause__, RuntimeError)
        small = _snapshot(0, GLOBAL_CONFIG.sched_device_min_batch - 1, 1,
                          n_nodes=1)
        assert (sched._assign(small)[1] >= 0).any()
        assert stub.calls == 1
    finally:
        sched.shutdown()


def test_calibration_picks_the_device_when_it_wins(monkeypatch, backend):
    GLOBAL_CONFIG.set("sched_backend", "auto")
    GLOBAL_CONFIG.set("sched_device", "cpu")
    sched, _dispatched, _lock = _bare([(8.0, 0, 1e18, 0)])
    try:
        snap = _snapshot(1, 128, 1, n_nodes=1)
        sched._np_cost = 10.0     # numpy far slower than the device path
        sched._assign(snap)
        assert _wait_for(lambda: sched._calib_state == "device")
        before = sched.stats()["device_assigns"]
        sched._assign(snap)
        assert sched.stats()["device_assigns"] == before + 1
    finally:
        sched.shutdown()


def test_check_device_rules(monkeypatch):
    from ray_tpu_torch._private.scheduler import tensor

    GLOBAL_CONFIG.reset()
    try:
        GLOBAL_CONFIG.set("sched_backend", "jax")
        with pytest.raises(ValueError, match="sched_backend"):
            tensor.check_device()
        GLOBAL_CONFIG.set("sched_backend", "cuda")
        GLOBAL_CONFIG.set("sched_device", "mps")
        with pytest.raises(ValueError, match="sched_device"):
            tensor.check_device()
        GLOBAL_CONFIG.set("sched_device", "cuda")
        monkeypatch.setattr(tensor.torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tensor.check_device()
        GLOBAL_CONFIG.set("sched_device", "cpu")
        tensor.check_device()
        GLOBAL_CONFIG.set("sched_device", "cuda")
        GLOBAL_CONFIG.set("sched_backend", "numpy")
        tensor.check_device()
    finally:
        GLOBAL_CONFIG.reset()


def test_reference_scheduler_untouched():
    """The reference package keeps its own registry and jax backend."""
    assert REF_CONFIG.sched_jax_min_batch == 512
    with pytest.raises(AttributeError):
        GLOBAL_CONFIG.sched_jax_min_batch
