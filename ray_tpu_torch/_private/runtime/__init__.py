"""Multi-process node runtime (process mode).

Reference surfaces: the raylet's worker pool
(ray: src/ray/raylet/worker_pool.cc), the plasma shared-memory store
(ray: src/ray/object_manager/plasma/), and the core-worker execution path
(ray: src/ray/core_worker/). Here: exec'd worker processes driven over
pipes and shared-memory control rings, with a shared-memory mmap arena as
the large-object data plane.
"""
