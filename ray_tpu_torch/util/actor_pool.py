"""ActorPool: load-balance tasks over a fixed set of actors (port of
ray_tpu/util/actor_pool.py; reference: python/ray/util/actor_pool.py) — same API (map /
map_unordered / submit / get_next / get_next_unordered / has_next /
has_free / push / pop_idle). Submits beyond the actor count queue and
dispatch as actors free up (on task completion).
"""

from __future__ import annotations

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors):
        self._idle = list(actors)
        # future -> (index, actor_or_None); actor becomes None once it has
        # been returned to the idle pool (its task finished)
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._pending_submits: list = []  # (fn, value) waiting for an actor
        self._next_task_index = 0
        self._next_return_index = 0

    # ---- submission ----
    def submit(self, fn, value):
        """fn(actor, value) -> ObjectRef. With no free actor the submit is
        queued and dispatched when one frees."""
        if not self._idle:
            self._pending_submits.append((fn, value))
            return
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = (self._next_task_index, actor)
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def map(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---- internals ----
    def _return_actor(self, actor):
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def _release_future(self, ref):
        """Mark ref's actor free (its task completed); keep the result."""
        idx, actor = self._future_to_actor[ref]
        if actor is not None:
            self._future_to_actor[ref] = (idx, None)
            self._return_actor(actor)

    def _wait_any(self, timeout):
        live = list(self._future_to_actor)
        ready, _ = ray_tpu_torch.wait(live, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        self._release_future(ready[0])

    # ---- consumption ----
    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def get_next(self, timeout: float | None = None):
        """Next result in submission order."""
        while self._next_return_index not in self._index_to_future:
            if self._pending_submits and self._idle:
                self.submit(*self._pending_submits.pop(0))
                continue
            if not self._future_to_actor:
                raise StopIteration("no pending results")
            self._wait_any(timeout)
        ref = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._release_future(ref)
            del self._future_to_actor[ref]

    def get_next_unordered(self, timeout: float | None = None):
        """Whichever pending result lands first."""
        if not self._future_to_actor and self._pending_submits and self._idle:
            self.submit(*self._pending_submits.pop(0))
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._release_future(ref)
            idx, _ = self._future_to_actor.pop(ref)
            self._index_to_future.pop(idx, None)

    # ---- membership ----
    def push(self, actor):
        self._return_actor(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
