"""Virtual multi-node cluster harness.

Reference: python/ray/cluster_utils.py — ``Cluster`` /
``cluster.add_node(num_cpus=...)`` / ``remove_node``. The reference
spawns a real raylet+plasma per node on one machine with DECLARED
resources; here each added node is a real per-node runtime too: its own
exec'd worker processes behind a dedicated pool, its own scheduler row,
registered in the GCS node table and covered by health checks. Node
death (remove_node, or killing the node's processes) flows through
GCS -> scheduler eviction -> retriable failure of its in-flight work ->
actor restart-elsewhere.

    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(initialize_head=True)
    n1 = cluster.add_node(num_cpus=4)
    ...
    cluster.remove_node(n1)      # graceless: kills the node's processes
    cluster.shutdown()
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import worker as worker_mod


class ClusterNode:
    """Handle to one virtual node (wraps the GCS node entry)."""

    def __init__(self, entry):
        self._entry = entry

    @property
    def node_id(self):
        return self._entry.node_id

    @property
    def index(self) -> int:
        return self._entry.index

    @property
    def state(self) -> str:
        return self._entry.state

    def worker_pids(self) -> List[int]:
        pool = self._entry.pool
        return pool.pids() if pool is not None else []

    def kill_worker_processes(self) -> None:
        """Chaos helper: the machine dies — every worker process is
        SIGKILLed and the node cannot self-heal (an individual worker
        crash respawns a replacement; a dead machine cannot). The control
        plane is NOT told; the GCS health checker must notice."""
        pool = self._entry.pool
        if pool is not None:
            pool.simulate_machine_death()

    def __repr__(self) -> str:
        return (f"ClusterNode(index={self.index}, "
                f"id={self.node_id.hex()[:16]}, state={self.state})")


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None):
        self._nodes: List[ClusterNode] = []
        if initialize_head:
            args = dict(head_node_args or {})
            args.setdefault("ignore_reinit_error", True)
            ray_tpu_torch.init(**args)

    def add_node(self, num_cpus: float = 4.0, num_gpus: float = 0.0,
                 num_workers: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None,
                 remote: bool = False,
                 object_store_memory: Optional[int] = None) -> ClusterNode:
        """``remote=True`` backs the node with a NODE DAEMON process
        owning its own shm arena, reached over TCP — the true multi-host
        topology (localhost stands in for the DCN); the default shares
        the head process's arena (virtual same-host node).
        object_store_memory sizes the remote node's arena. ``num_gpus``
        > 0 needs the ``worker_gpu_access`` knob either way (the node's
        workers must see the card)."""
        w = worker_mod.get_worker()
        if remote:
            entry = w.add_remote_cluster_node(
                num_cpus=num_cpus, num_gpus=num_gpus,
                num_workers=num_workers, resources=resources,
                object_store_memory=object_store_memory)
        else:
            entry = w.add_cluster_node(num_cpus=num_cpus, num_gpus=num_gpus,
                                       num_workers=num_workers,
                                       resources=resources)
        node = ClusterNode(entry)
        self._nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode,
                    allow_graceful: bool = False) -> None:
        """Kill the node. graceless (default): in-flight work fails with a
        retriable NodeDiedError and reschedules onto survivors."""
        w = worker_mod.get_worker()
        w.on_node_failure(node.node_id,
                          reason="Cluster.remove_node"
                          + (" (graceful)" if allow_graceful else ""))

    def wait_for_nodes(self, timeout: float = 10.0) -> None:
        """Block until every added node's workers are accepting work."""
        deadline = time.monotonic() + timeout
        for node in self._nodes:
            pool = node._entry.pool
            if pool is None or node.state != "ALIVE":
                continue
            while time.monotonic() < deadline:
                if pool.live_process_count() > 0:
                    break
                time.sleep(0.02)

    @property
    def list_all_nodes(self) -> List[ClusterNode]:
        return list(self._nodes)

    def shutdown(self) -> None:
        ray_tpu_torch.shutdown()
        self._nodes.clear()
