"""Distributed Queue backed by an async actor (port of
ray_tpu/util/queue.py; reference: python/ray/util/queue.py) — Queue with put/get
(blocking with timeout), put_nowait/get_nowait, qsize/empty/full,
put_nowait_batch/get_nowait_batch, shutdown.
"""

from __future__ import annotations

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(num_cpus=0, max_concurrency=16)
class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio

        self._maxsize = maxsize
        self._q = asyncio.Queue(maxsize)

    async def put(self, item, timeout: float | None = None):
        import asyncio

        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: float | None = None):
        import asyncio

        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item):
        if self._q.full():
            return False
        self._q.put_nowait(item)
        return True

    async def get_nowait(self):
        if self._q.empty():
            return False, None
        return True, self._q.get_nowait()

    async def put_nowait_batch(self, items):
        if self._maxsize > 0 and self._q.qsize() + len(items) > self._maxsize:
            return False
        for it in items:
            self._q.put_nowait(it)
        return True

    async def get_nowait_batch(self, n):
        if self._q.qsize() < n:
            return None
        return [self._q.get_nowait() for _ in range(n)]

    async def qsize(self):
        return self._q.qsize()

    async def empty(self):
        return self._q.empty()

    async def full(self):
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: dict | None = None):
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**(actor_options or {})).remote(maxsize)

    def put(self, item, block: bool = True, timeout: float | None = None):
        if not block:
            return self.put_nowait(item)
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full("queue full")

    def get(self, block: bool = True, timeout: float | None = None):
        if not block:
            return self.get_nowait()
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("queue empty")
        return item

    def put_nowait(self, item):
        if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
            raise Full("queue full")

    def get_nowait(self):
        ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        if not ok:
            raise Empty("queue empty")
        return item

    def put_nowait_batch(self, items):
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full("batch exceeds queue capacity")

    def get_nowait_batch(self, n: int):
        out = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(n))
        if out is None:
            raise Empty(f"fewer than {n} items queued")
        return out

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
