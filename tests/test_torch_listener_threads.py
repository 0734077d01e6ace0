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
