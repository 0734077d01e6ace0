"""Scheduling subsystem (counterpart of ``ray_tpu/_private/scheduler``).

The policy boundary mirrors the reference's ClusterTaskManager /
ILocalTaskManager split (ray: src/ray/raylet/scheduling/): submission
enters through ``SchedulerBase.submit``; readiness tracking + node
assignment happen behind the boundary; dispatch callbacks execute tasks.

Two interchangeable implementations:
  - ``local.EventScheduler``   — per-event dict-based (reference-style
    O(1)-per-task decisions); the semantics oracle.
  - ``tensor.TensorScheduler`` — the pending DAG held as arrays; batched
    assignment through ``kernels.assign`` (the hand-written CUDA tick of
    ``ops/csrc/scheduler_tick.cu``) or ``kernels.assign_np``.
"""

from ray_tpu_torch._private.scheduler.base import PendingTask, SchedulerBase  # noqa: F401
from ray_tpu_torch._private.scheduler.local import EventScheduler  # noqa: F401
