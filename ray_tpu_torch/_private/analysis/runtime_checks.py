"""Dynamic counterpart of the static lock passes.

``assert_holds(lock)`` verifies the calling thread actually holds the
lock guarding the structure it is about to touch. It compiles to a
no-op unless ``RAY_TPU_TORCH_DEBUG_LOCKS=1`` (read once at import, like
other debug gates), so the hot paths it decorates — the GCS object
directory, the task-event ring, the pull manager — pay nothing in
production while chaos soaks and debug runs exercise the same
invariants raylint checks statically.

Ownership detection: ``RLock`` and ``Condition`` expose ``_is_owned``;
a plain ``Lock`` has no owner concept, so the best available check is
``acquire(blocking=False)`` — if that *succeeds*, nobody held the lock
and the caller has a race. (It cannot distinguish "this thread holds
it" from "another thread holds it"; that is exactly the static pass's
job.)
"""

from __future__ import annotations

import os

_ENABLED = os.environ.get("RAY_TPU_TORCH_DEBUG_LOCKS", "") == "1"


class LockNotHeldError(AssertionError):
    pass


def enabled() -> bool:
    return _ENABLED


def assert_holds(lock, what: str = "") -> None:
    """Raise LockNotHeldError if ``lock`` is demonstrably not held.

    No-op unless RAY_TPU_TORCH_DEBUG_LOCKS=1.
    """
    if not _ENABLED:
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        if not owned():
            raise LockNotHeldError(
                f"lock required but not held by this thread"
                f"{': ' + what if what else ''}")
        return
    # plain Lock: a successful non-blocking acquire proves NOBODY held it
    if lock.acquire(blocking=False):
        lock.release()
        raise LockNotHeldError(
            f"lock required but not held by anyone"
            f"{': ' + what if what else ''}")
