"""Scheduler interface shared by the event-driven oracle and the
tensorized device-resident implementation."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.task_spec import TaskSpec


@dataclasses.dataclass
class PendingTask:
    spec: TaskSpec
    deps: List[ObjectID]           # unresolved top-level ObjectRef args
    execute: Callable[["PendingTask", int], None]  # (task, node_index) -> None
    # filled by the scheduler:
    node_index: int = -1
    cancelled: bool = False


class SchedulerBase:
    """Submission boundary. Implementations must be thread-safe."""

    # Optional TaskEventAggregator the worker attaches after
    # construction; implementations call record_ready_batch() when a
    # dep-blocked task's last dependency lands (no-dep tasks skip the
    # hook entirely: READY defaults to SUBMITTED at read time).
    task_events = None

    # Two-level scheduling counters: node-local admissions this
    # scheduler never placed, and their upward spillbacks that landed
    # back on its queue. Bare class attrs so both implementations (and
    # tests' stubs) inherit the zero without extra __init__ plumbing;
    # the notes below rebind instance attrs, and the only writers are
    # the head's daemon-demux/rpc threads, which bump under the GIL
    # at report granularity (exactness is not load-bearing — the
    # authoritative counts live in worker.two_level_stats).
    _num_local_dispatch = 0
    _num_spillback = 0

    # Optional QosPlane the worker attaches after construction when the
    # qos knob is on: drains consult plane.order() so ready work
    # dispatches strict-tier-first with weighted fair-share between
    # tenants inside a tier. None (the class default) keeps the FIFO
    # drain order byte-for-byte pre-QoS.
    qos_plane = None

    # Optional object-location provider the worker attaches after
    # construction: locations_of(object_id) -> List[int] of node rows
    # holding a copy (primary first). Drives the locality scoring
    # column; None (or an empty list per oid) disables it.
    locations_of = None

    # Optional fail_tasks(tasks, exc) the worker attaches after
    # construction: resolves the returns of tasks the scheduler could not
    # place because its batched device assignment raised (TensorScheduler;
    # the port never retries such a batch on another backend).
    fail_tasks = None

    def note_local_dispatch(self) -> None:
        """A node's LocalScheduler admitted a worker-submitted task
        without this (head) scheduler ever seeing it."""
        self._num_local_dispatch += 1

    def note_spillback(self) -> None:
        """A node declined a local submission (queue full / unfit) and
        spilled it up to this scheduler's normal path."""
        self._num_spillback += 1

    def submit(self, task: PendingTask) -> None:
        raise NotImplementedError

    def submit_many(self, tasks: List[PendingTask]) -> None:
        """Batch submission: implementations override to take their
        queue lock and wake the tick loop ONCE per batch."""
        for t in tasks:
            self.submit(t)

    def node_state(self, index: int):
        """NodeState at a row (locked read). None if out of range."""
        raise NotImplementedError

    def node_count(self) -> int:
        raise NotImplementedError

    def notify_object_ready(self, object_id: ObjectID) -> None:
        """An object a pending task depends on became available."""
        raise NotImplementedError

    def notify_task_finished(self, task_id: TaskID, node_index: int,
                             resources: Dict[str, float]) -> None:
        """Resources released on the node that ran the task."""
        raise NotImplementedError

    def notify_batch(self, ready_objects: List[ObjectID],
                     finished: List[tuple]) -> None:
        """Deliver many object-ready + task-finished events with one
        wakeup (completion batching on the hot path; ``finished`` rows
        are (task_id, node_index, resources) tuples). Default: loop."""
        for oid in ready_objects:
            self.notify_object_ready(oid)
        for task_id, node_index, resources in finished:
            self.notify_task_finished(task_id, node_index, resources)

    def cancel(self, task_id: TaskID) -> bool:
        """Remove a queued task. Returns True if it had not started."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError
