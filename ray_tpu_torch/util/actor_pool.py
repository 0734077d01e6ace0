"""Actor pool utility.

Reference surface: ray.util.ActorPool (ray: python/ray/util/actor_pool.py)
— round-robins submitted work over a fixed set of actor handles, yielding
results as they complete. Same API: submit / map / map_unordered /
get_next / get_next_unordered / has_next / has_free / push / pop_idle.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch


class ActorPool:
    """Round-robin work distribution over a set of actors.

    fn passed to submit/map receives (actor, value) and must call a
    remote method, returning the ObjectRef — exactly the reference's
    calling convention::

        pool = ActorPool([Worker.remote() for _ in range(4)])
        out = list(pool.map(lambda a, v: a.double.remote(v), range(10)))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        self._future_to_actor: dict = {}
        # ordered-result bookkeeping (reference: _index_to_future)
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []
        # indices consumed by get_next_unordered; get_next skips them
        self._consumed_unordered: set = set()

    # -- submission ----------------------------------------------------
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Run fn(actor, value) on the next free actor; queues the call
        if all actors are busy (drained as results are consumed)."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    # -- consumption ---------------------------------------------------
    def _return_actor(self, future) -> None:
        actor = self._future_to_actor.pop(future, None)
        if actor is not None:
            self._idle.append(actor)
        if self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in SUBMISSION order. A timeout raises WITHOUT
        consuming the slot (retryable); a task exception propagates
        AFTER the actor returns to the pool, so failures never shrink
        it (both reference behaviors)."""
        self._advance_past_consumed()
        if not self.has_next():
            raise StopIteration("no pending results")
        # one deadline for the whole call: _wait_any may loop several
        # times draining queued submits, and each leg gets only the
        # REMAINING time, not a fresh full timeout
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def _remaining() -> float | None:
            if deadline is None:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("no result within timeout")
            return left

        idx = self._next_return_index
        while idx not in self._index_to_future:
            # its submit is still queued behind busy actors: free one up
            self._wait_any(_remaining())
        future = self._index_to_future[idx]
        ready, _ = ray_tpu_torch.wait([future], num_returns=1,
                                timeout=_remaining())
        if not ready:
            raise TimeoutError("no result within timeout")
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._advance_past_consumed()
        self._return_actor(future)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in COMPLETION order (same timeout/exception
        contract as get_next)."""
        if not self.has_next():
            raise StopIteration("no pending results")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def _remaining() -> float | None:
            if deadline is None:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("no result within timeout")
            return left

        while not self._index_to_future:
            self._wait_any(_remaining())
        ready, _ = ray_tpu_torch.wait(list(self._index_to_future.values()),
                                num_returns=1, timeout=_remaining())
        if not ready:
            raise TimeoutError("no result within timeout")
        future = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f == future:
                del self._index_to_future[idx]
                self._consumed_unordered.add(idx)
                break
        self._advance_past_consumed()
        self._return_actor(future)
        return ray_tpu_torch.get(future)

    def _advance_past_consumed(self) -> None:
        """Move the ordered cursor past indices get_next_unordered
        consumed (mixing the two consumption orders is allowed), and
        prune them so the set stays bounded by out-of-order depth."""
        while self._next_return_index in self._consumed_unordered:
            self._consumed_unordered.discard(self._next_return_index)
            self._next_return_index += 1

    def _wait_any(self, timeout: float | None) -> None:
        """Make progress WITHOUT consuming results: drain a queued
        submit if an actor is idle, else wait for any in-flight task
        still holding its actor and return that actor to the pool (its
        result stays pending until get_next/get_next_unordered)."""
        if self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)
            return
        futures = [f for f in self._index_to_future.values()
                   if f in self._future_to_actor]
        if not futures:
            raise RuntimeError("queued submits but no in-flight futures")
        ready, _ = ray_tpu_torch.wait(futures, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        self._return_actor(ready[0])

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        """Results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        """Results in completion order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ----------------------------------------------------
    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def pop_idle(self) -> Any | None:
        """Remove and return an idle actor (None if all are busy)."""
        return self._idle.pop() if self._idle else None
