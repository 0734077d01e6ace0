"""User-facing exception hierarchy.

Reference surface: python/ray/exceptions.py — RayError, RayTaskError
(wraps the remote traceback and re-raises on get), RayActorError,
ObjectLostError, GetTimeoutError, TaskCancelledError, OutOfMemoryError.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised; carries the remote traceback and cause.

    ``ray.get`` raises an exception that is BOTH the user's exception type
    and a TaskError (dynamic subclass), matching the reference's
    RayTaskError.as_instanceof_cause() behavior so `except UserError` works.
    """

    def __init__(self, function_name: str, cause: BaseException,
                 tb_str: Optional[str] = None):
        self.function_name = function_name
        self.cause = cause
        self.traceback_str = tb_str or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"task {function_name} failed:\n{self.traceback_str}"
        )

    def __reduce__(self):
        # default Exception pickling replays __init__ with self.args
        # (just the message) and breaks on the required ``cause`` —
        # carry the real constructor arguments across the wire
        return (TaskError,
                (self.function_name, self.cause, self.traceback_str))

    def as_instanceof_cause(self) -> BaseException:
        cause_cls = type(self.cause)
        if issubclass(cause_cls, TaskError):
            return self.cause
        name = f"TaskError({cause_cls.__name__})"
        bases = (TaskError, cause_cls)
        try:
            derived = type(name, bases, {
                "__init__": lambda s: None,
                "__str__": lambda s: self.args[0],
                "__reduce__": lambda s: (_rebuild_task_error,
                                         (self.function_name, self.cause,
                                          self.traceback_str)),
            })
            err = derived()
            err.function_name = self.function_name
            err.cause = self.cause
            err.traceback_str = self.traceback_str
            err.args = self.args
            return err
        except TypeError:
            # cause class not subclassable (e.g. has __slots__ conflicts)
            return self


def _rebuild_task_error(function_name, cause, tb_str):
    return TaskError(function_name, cause, tb_str).as_instanceof_cause()


class NodeDiedError(RayTpuError):
    """The node a task/actor was placed on died (reference:
    ray.exceptions.NodeDiedError; detected by GCS health checks or
    explicit Cluster.remove_node)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    """Actor is dead or unreachable; method calls fail with this."""

    def __init__(self, msg: str = "actor died", actor_id=None):
        self.actor_id = actor_id
        super().__init__(msg)


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    """Actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object's value was lost and could not be reconstructed from lineage."""

    def __init__(self, object_id_hex: str, msg: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(msg or f"object {object_id_hex} lost")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_id_hex: str):
        super().__init__(object_id_hex, f"owner of object {object_id_hex} died")


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskTimeoutError(RayTpuError, TimeoutError):
    """A task exceeded its per-attempt ``timeout_s`` deadline and was
    cancelled by the supervision layer. Retriable: each timeout counts
    one attempt against ``max_retries``; when retries are exhausted the
    final error chains the last per-attempt timeout as ``__cause__``."""

    def __init__(self, msg: str = "task timed out", task_id=None,
                 timeout_s=None):
        self.task_id = task_id
        self.timeout_s = timeout_s
        super().__init__(msg)

    def __reduce__(self):
        return (TaskTimeoutError,
                (self.args[0], self.task_id, self.timeout_s))


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task {task_id} cancelled")


class PendingCallsLimitExceeded(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Retriable: the memory monitor killed this task over threshold."""


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class SchedulingError(RayTpuError):
    """The scheduler could not place the task: its batched device
    assignment raised. ``__cause__`` is the device error; the batch is
    never retried on another backend (the port has no fallback)."""
