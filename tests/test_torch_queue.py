"""ray_tpu_torch.util.queue on the CPU: tests/test_util_pool_queue.py's
TestQueue cases on the port's runtime (thread mode, the scheduler's device
path on the host), and tensors through the queue in order."""

import time

import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch as ray  # noqa: E402
from ray_tpu_torch.util.queue import Empty, Full, Queue  # noqa: E402


@pytest.fixture(scope="module")
def rt():
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor",
             _system_config={"sched_device": "cpu"})
    yield ray
    ray.shutdown()


@ray.remote
def _producer(q, items):
    for it in items:
        q.put(it)
    return len(items)


@ray.remote
def _consumer(q, n):
    return [q.get(timeout=30) for _ in range(n)]


class TestQueue:
    def test_fifo_roundtrip(self, rt):
        q = Queue()
        for i in range(5):
            q.put(i)
        assert q.qsize() == 5 and not q.empty()
        assert [q.get() for _ in range(5)] == list(range(5))
        assert q.empty()
        q.shutdown()

    def test_nowait_and_bounds(self, rt):
        q = Queue(maxsize=2)
        q.put_nowait(1)
        q.put_nowait(2)
        assert q.full()
        with pytest.raises(Full):
            q.put_nowait(3)
        assert q.get_nowait() == 1
        q2 = Queue()
        with pytest.raises(Empty):
            q2.get_nowait()
        q.shutdown()
        q2.shutdown()

    def test_blocking_get_with_timeout(self, rt):
        q = Queue()
        t0 = time.monotonic()
        with pytest.raises(Empty):
            q.get(timeout=0.3)
        assert time.monotonic() - t0 >= 0.25
        q.shutdown()

    def test_blocking_put_respects_capacity(self, rt):
        q = Queue(maxsize=1)
        q.put("a")
        with pytest.raises(Full):
            q.put("b", timeout=0.3)
        assert q.get() == "a"
        q.put("b", timeout=5)  # space freed: succeeds
        assert q.get() == "b"
        q.shutdown()

    def test_cross_task_producer_consumer(self, rt):
        """The handle pickles into tasks; a blocked consumer unblocks
        when the producer task feeds the queue."""
        q = Queue()
        got_ref = _consumer.remote(q, 4)
        time.sleep(0.2)  # consumer is parked on the empty queue
        assert ray.get(_producer.remote(q, list("abcd")), timeout=60) == 4
        assert ray.get(got_ref, timeout=60) == list("abcd")
        q.shutdown()

    def test_batch_ops(self, rt):
        q = Queue(maxsize=4)
        q.put_nowait_batch([1, 2, 3])
        with pytest.raises(Full):
            q.put_nowait_batch([4, 5])
        assert q.get_nowait_batch(2) == [1, 2]
        with pytest.raises(Empty):
            q.get_nowait_batch(5)
        q.shutdown()


def test_tensors_between_tasks_in_order(rt):
    """What chip_smoke's phase workflow does with CUDA tensors, on the
    host: a producer task's tensors reach a consumer task equal and in
    order."""
    q = Queue(maxsize=8)
    items = [torch.full((4,), float(i)) for i in range(32)]
    got_ref = _consumer.remote(q, len(items))
    assert ray.get(_producer.remote(q, items), timeout=60) == len(items)
    got = ray.get(got_ref, timeout=60)
    assert [int(t[0]) for t in got] == list(range(32))
    assert all(torch.equal(a, b) for a, b in zip(got, items))
    q.shutdown()
