"""No accept thread of the port outlives ``shutdown()``.

A thread blocked in ``Listener.accept()`` is not woken by closing the
listener on Linux; the port's listeners (the head endpoint, the process
pools, the node daemon) now shut the socket down first and join the thread
(``_private/runtime/listener.py``). The reference closes without it, so
its ``ray_tpu_head_accept`` and ``ray_tpu_pool_accept`` threads stay alive
after ``Cluster.shutdown()`` (ROADMAP.md Queue C): the last case shows the
difference. Only threads started during a case count: other tests in the
same worker may have left the reference's behind.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

CPU = {"sched_device": "cpu"}


def _accept_threads(before):
    return sorted(t.name for t in threading.enumerate()
                  if t not in before and t.is_alive()
                  and t.name.startswith("ray_tpu") and "accept" in t.name)


def test_process_mode_shutdown_leaves_no_accept_thread():
    import ray_tpu_torch as ray

    ray.shutdown()
    before = set(threading.enumerate())
    ray.init(num_workers=2, _system_config={**CPU, "worker_mode": "process"})
    try:
        assert ray.get(ray.remote(lambda x: x + 1).remote(1), timeout=60) == 2
        assert _accept_threads(before) == ["ray_tpu_pool_accept"]
    finally:
        ray.shutdown()
    assert _accept_threads(before) == []


def test_cluster_shutdown_leaves_no_accept_thread():
    import ray_tpu_torch as ray
    from ray_tpu_torch.cluster_utils import Cluster

    ray.shutdown()
    before = set(threading.enumerate())
    cluster = Cluster(initialize_head=True, head_node_args=dict(
        num_cpus=2, num_workers=1,
        _system_config={**CPU, "worker_mode": "process"}))
    try:
        cluster.add_node(num_cpus=2, num_workers=1)
        cluster.add_node(num_cpus=2, num_workers=1, remote=True)
        cluster.wait_for_nodes()
        f = ray.remote(lambda x: x * 2)
        assert ray.get([f.remote(i) for i in range(8)],
                       timeout=60) == [2 * i for i in range(8)]
        assert "ray_tpu_head_accept" in _accept_threads(before)
        assert "ray_tpu_pool_accept" in _accept_threads(before)
    finally:
        cluster.shutdown()
    assert _accept_threads(before) == []


def test_reference_still_leaves_its_accept_threads():
    """The difference parity tests must expect: the reference's head
    endpoint keeps its accept thread after shutdown."""
    pytest.importorskip("jax")
    import ray_tpu
    from ray_tpu.cluster_utils import Cluster as RefCluster

    ray_tpu.shutdown()
    before = set(threading.enumerate())
    cluster = RefCluster(initialize_head=True, head_node_args=dict(
        num_cpus=2, num_workers=1))
    try:
        cluster.add_node(num_cpus=2, num_workers=1, remote=True)
        cluster.wait_for_nodes()
    finally:
        cluster.shutdown()
    assert "ray_tpu_head_accept" in _accept_threads(before)


def _pool_threads(before):
    return sorted(t.name for t in threading.enumerate()
                  if t not in before and t.is_alive()
                  and t.name.startswith("ray_tpu_pool_"))


def test_removed_node_pool_threads_end_at_shutdown():
    """A node removed from the cluster (a machine death) leaves the table
    of live pools, but its process pool still holds its accept and demux
    threads: shutdown() must end them too, as it ends the live pools'."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.cluster_utils import Cluster

    ray.shutdown()
    before = set(threading.enumerate())
    cluster = Cluster(initialize_head=True, head_node_args=dict(
        num_cpus=2, num_workers=1, _system_config=CPU))
    try:
        nodes = [cluster.add_node(num_cpus=2, num_workers=1)
                 for _ in range(2)]
        cluster.wait_for_nodes()
        f = ray.remote(lambda x: x * 2)
        assert ray.get([f.remote(i) for i in range(8)],
                       timeout=60) == [2 * i for i in range(8)]
        assert _pool_threads(before).count("ray_tpu_pool_accept") == 2
        cluster.remove_node(nodes[0])
        assert ray.get(f.remote(5), timeout=60) == 10
    finally:
        cluster.shutdown()
    assert _pool_threads(before) == []


def test_pool_shutdown_joins_its_demux_and_monitor_threads(monkeypatch):
    """A process pool's shutdown() returns only after its demux thread and
    every worker's exit monitor have ended, even where a monitor is slow
    to handle its worker's exit (as on a loaded host)."""
    import time

    import ray_tpu_torch as ray
    from ray_tpu_torch._private.runtime import process_pool

    slow = process_pool.ProcessWorkerPool._on_worker_failure

    def slow_failure(self, h, cause):
        time.sleep(0.5)
        return slow(self, h, cause)

    monkeypatch.setattr(process_pool.ProcessWorkerPool, "_on_worker_failure",
                        slow_failure)
    ray.shutdown()
    before = set(threading.enumerate())
    ray.init(num_workers=2, _system_config={**CPU, "worker_mode": "process"})
    try:
        assert ray.get(ray.remote(lambda x: x + 1).remote(1), timeout=60) == 2
        names = _pool_threads(before)
        assert names.count("ray_tpu_pool_monitor_1") == 1, names
        assert "ray_tpu_pool_demux_0" in names, names
    finally:
        ray.shutdown()
    assert _pool_threads(before) == []


class _RefusesShutdown:
    """A listening socket whose shutdown fails with ENOTCONN and wakes
    nothing, as an AF_UNIX listener's does under gVisor (as on the H100
    host the port runs on), and whose close wakes nothing either (it is
    deferred to the end of the test); everything else goes to the real
    socket."""

    def __init__(self, sock):
        self._sock = sock

    def shutdown(self, how):
        import errno

        raise OSError(errno.ENOTCONN, "Transport endpoint is not connected")

    def close(self):
        pass

    def __getattr__(self, name):
        return getattr(self._sock, name)


@pytest.mark.parametrize("family", ["AF_UNIX", "AF_INET"])
def test_a_dial_wakes_accept_where_shutdown_cannot(tmp_path, family):
    """close_listener ends a thread blocked in accept() even where the
    socket's shutdown wakes nothing: it dials the listener once, the
    handshake fails on the closed dial, and the loop returns."""
    from multiprocessing.connection import Listener

    from ray_tpu_torch._private.runtime.listener import close_listener

    address = (str(tmp_path / "s.sock") if family == "AF_UNIX"
               else ("127.0.0.1", 0))
    listener = Listener(address=address, family=family, authkey=b"k" * 16)
    closed = threading.Event()

    def loop():
        while not closed.is_set():
            try:
                listener.accept()
            except Exception:
                if closed.is_set():
                    return

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    real = listener._listener._socket
    listener._listener._socket = _RefusesShutdown(real)
    closed.set()
    try:
        close_listener(listener, thread, timeout_s=5.0)
        assert not thread.is_alive()
    finally:
        real.close()
