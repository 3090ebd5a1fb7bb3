"""Identifiers (port of ray_tpu/core/ids.py): ``BaseID``, the job, node,
worker, actor, placement-group and task ids, and ``ObjectID``, with
ray_tpu's byte layouts, and the pooled entropy source ``_rand``.

An ObjectID is a task id (16 bytes) and a return index (4 bytes, little
endian); a put's task id is random and its index 0xFFFFFFFF, the mark of
an object no lineage can rebuild.
"""

from __future__ import annotations

import os
import threading

_rng_lock = threading.Lock()
# os.urandom is a syscall per call; draw entropy in 4 KiB blocks instead.
# The pool is keyed by pid, so a forked child never replays its parent's bytes.
_POOL_SIZE = 4096
_pool = b""
_pool_off = 0
_pool_pid = -1


def _rand(n: int) -> bytes:
    global _pool, _pool_off, _pool_pid
    if n > _POOL_SIZE:
        return os.urandom(n)
    with _rng_lock:
        if _pool_pid != os.getpid() or _pool_off + n > len(_pool):
            _pool = os.urandom(_POOL_SIZE)
            _pool_off = 0
            _pool_pid = os.getpid()
        out = _pool[_pool_off : _pool_off + n]
        _pool_off += n
        return out


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, raw: bytes):
        if len(raw) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(raw)}")
        self._bytes = raw
        self._hash = hash((type(self).__name__, raw))

    @classmethod
    def from_random(cls):
        return cls(_rand(cls.SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return type(self) is type(other) and self._bytes == other._bytes

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_actor(cls, actor_id: ActorID, seq: int) -> "TaskID":
        return cls(actor_id.binary()[:12] + seq.to_bytes(4, "little"))


class ObjectID(BaseID):
    """task_id (16 bytes) + return index (4 bytes little-endian)."""

    SIZE = 20

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def from_put(cls) -> "ObjectID":
        # a put has no producing task: a random task id, and index
        # 0xFFFFFFFF marks "not reconstructable through lineage"
        return cls(_rand(16) + b"\xff\xff\xff\xff")

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[16:20], "little")

    def is_put(self) -> bool:
        return self._bytes[16:20] == b"\xff\xff\xff\xff"
