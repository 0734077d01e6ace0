"""Distributed FIFO queue.

Counterpart of ``ray_tpu/util/queue.py``, copied onto the port's async
actors (values, CUDA tensors included, travel by value through the
actor's calls). Reference surface: ray.util.queue.Queue (ray: python/ray/util/queue.py)
— a bounded multi-producer/multi-consumer queue backed by an ASYNC
actor, so a blocked get/put parks on the actor's event loop instead of
holding one of its threads. Same API: put/get (blocking with timeout),
put_nowait/get_nowait, qsize/empty/full, plus Empty/Full exceptions.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    """asyncio.Queue behind an async actor: concurrent get/put calls
    interleave on the loop, so a consumer awaiting an empty queue never
    wedges the producer call that would feed it."""

    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item: Any, timeout: Optional[float]) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float]):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def put_nowait_batch(self, items: List[Any]) -> bool:
        if (self._q.maxsize and
                self._q.qsize() + len(items) > self._q.maxsize):
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    async def get_nowait_batch(self, n: int):
        if self._q.qsize() < n:
            return False, []
        return True, [self._q.get_nowait() for _ in range(n)]


class Queue:
    """Driver/worker-side handle; all state lives in the queue actor, so
    handles pickle freely into tasks and actors (pass the Queue object
    itself, as with the reference)."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = actor_options or {}
        cls = _QueueActor.options(**opts) if opts else _QueueActor
        self.actor = cls.remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full(f"put timed out after {timeout}s")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty(f"get timed out after {timeout}s")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(
                self.actor.put_nowait_batch.remote(list(items))):
            raise Full("batch exceeds queue capacity")

    def get_nowait_batch(self, n: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(n))
        if not ok:
            raise Empty(f"fewer than {n} items queued")
        return items

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
