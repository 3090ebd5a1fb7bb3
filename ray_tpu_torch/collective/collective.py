"""Collective communication API on actor groups (port of
ray_tpu/collective/collective.py, backend ``"object_store"``).

Every rank of a group rendezvouses on one named actor (rank 0 creates
it, detached); the data plane is the shared-memory object store: ranks
exchange ObjectRefs through the rendezvous actor (small control
messages), read each other's payloads from the store and reduce
locally, then free their own. Point-to-point sends at or above 32 KiB
ride the store too; smaller ones ride the actor.

The result takes the input's flavour: a numpy array for a numpy input,
a torch tensor on the input's device and of its dtype for a torch input.
A tensor on the card goes through host memory, as ray_tpu's jax arrays
do; a bf16 tensor travels as f32 (numpy has no bf16). A group of ray_tpu's
backend ``"xla"`` takes the same path, as in ray_tpu; the device
collectives over tensors one process holds are ``ici.py``.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.collective.types import Backend, ReduceOp, apply_reduce


class _GroupInfo:
    def __init__(self, name, world_size, rank, backend, handle):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.handle = handle
        self.round = 0
        self.p2p_seq: dict = {}  # (kind, peer, tag) -> count
        self.lock = threading.Lock()

    def next_round(self) -> int:
        with self.lock:
            self.round += 1
            return self.round

    def next_p2p(self, kind: str, peer: int, tag: int) -> int:
        """Per-(direction, peer, tag) sequence number so repeated sends on
        one tag match their recvs in order instead of clobbering a slot."""
        with self.lock:
            key = (kind, peer, tag)
            self.p2p_seq[key] = self.p2p_seq.get(key, 0) + 1
            return self.p2p_seq[key]


_groups: dict[str, _GroupInfo] = {}


@ray_tpu_torch.remote(num_cpus=0)
class CollectiveRendezvous:
    """The named actor every rank rendezvouses on. Async, so waiting ranks
    do not block one another."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: dict = {}

    def _entry(self, key):
        if key not in self.rounds:
            self.rounds[key] = {"data": {}, "event": asyncio.Event(), "result": None, "done": 0}
        return self.rounds[key]

    async def exchange(self, key, rank, payload, op: str, mode: str):
        from ray_tpu_torch._config import get_config

        e = self._entry(key)
        e["data"][rank] = payload
        if len(e["data"]) == self.world_size:
            arrays = [e["data"][r] for r in range(self.world_size)]
            if mode == "allreduce":
                e["result"] = apply_reduce(ReduceOp(op), arrays)
            elif mode == "allgather":
                e["result"] = arrays
            elif mode == "reducescatter":
                red = apply_reduce(ReduceOp(op), arrays)
                e["result"] = np.array_split(red, self.world_size, axis=0)
            elif mode == "barrier":
                e["result"] = True
            elif mode == "broadcast":
                e["bcast"] = e["data"]
            e["event"].set()
        await asyncio.wait_for(e["event"].wait(), timeout=get_config().collective_timeout_s)
        try:
            if mode == "reducescatter":
                return e["result"][rank]
            if mode == "broadcast":
                return e["bcast"][int(op)]  # op carries src_rank for broadcast
            return e["result"]
        finally:
            # the round is dropped once every rank has read it
            e["done"] += 1
            if e["done"] == self.world_size:
                self.rounds.pop(key, None)

    async def p2p_send(self, key, payload):
        e = self._entry(key)
        e["data"][0] = payload
        e["event"].set()

    async def p2p_recv(self, key):
        from ray_tpu_torch._config import get_config

        e = self._entry(key)
        await asyncio.wait_for(e["event"].wait(), timeout=get_config().collective_timeout_s)
        val = e["data"][0]
        self.rounds.pop(key, None)
        return val

    def reset(self):
        self.rounds.clear()
        return True


def _rendezvous_name(group_name: str) -> str:
    return f"rt_collective::{group_name}"


def init_collective_group(
    world_size: int,
    rank: int,
    backend: Backend | str = Backend.OBJECT_STORE,
    group_name: str = "default",
):
    """Call on every rank."""
    backend = Backend.normalize(backend)
    name = _rendezvous_name(group_name)
    if rank == 0:
        handle = CollectiveRendezvous.options(name=name, lifetime="detached").remote(world_size)
        ray_tpu_torch.get(handle.__ray_ready__())
    else:
        deadline = time.time() + 60
        while True:
            try:
                handle = ray_tpu_torch.get_actor(name)
                break
            except ValueError:
                if time.time() > deadline:
                    raise TimeoutError(f"rendezvous actor for group {group_name!r} never appeared") from None
                time.sleep(0.05)
    _groups[group_name] = _GroupInfo(group_name, world_size, rank, backend, handle)


def create_collective_group(actors, world_size: int, ranks: list[int], backend="object_store",
                            group_name: str = "default"):
    """Declare a group across actor handles (driver side). Each actor then
    joins it in its own process through ``CollectiveActorMixin``."""
    return declare_collective_group(actors, world_size=world_size, ranks=ranks, backend=backend,
                                    group_name=group_name)


def declare_collective_group(actors, world_size=None, ranks=None, backend="object_store", group_name="default"):
    world_size = world_size or len(actors)
    ranks = ranks or list(range(len(actors)))
    return [actor.__rt_init_collective__.remote(world_size, rank, str(Backend.normalize(backend).value), group_name)
            for actor, rank in zip(actors, ranks)]


def destroy_collective_group(group_name: str = "default"):
    g = _groups.pop(group_name, None)
    if g is not None and g.rank == 0:
        try:
            ray_tpu_torch.kill(g.handle)
        except Exception:
            pass


def cleanup_group_actor(group_name: str):
    """Kill a group's (detached) rendezvous actor by name: reaps groups
    whose ranks died without destroying them."""
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(_rendezvous_name(group_name)))
    except Exception:
        pass


def get_rank(group_name: str = "default") -> int:
    return _groups[group_name].rank


def get_world_size(group_name: str = "default") -> int:
    return _groups[group_name].world_size


def _g(group_name) -> _GroupInfo:
    if group_name not in _groups:
        raise RuntimeError(f"collective group {group_name!r} not initialized in this process")
    return _groups[group_name]


# p2p payloads at or above this ride the shm object store (one producer
# and one consumer per key, so the sender alone can decide the plane)
_SHM_PLANE_THRESHOLD = 32 * 1024


def _host(tensor):
    """The payload as a host numpy array: a torch tensor leaves its device,
    bf16 as f32."""
    if tensor is None:
        return None
    import torch

    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(tensor)


def _roundtrip(g: _GroupInfo, tensor, op, mode, round_key=None):
    key = round_key or f"{mode}:{g.next_round()}"
    payload = _host(tensor)
    op_str = op.value if isinstance(op, ReduceOp) else str(op)
    if mode in ("allreduce", "allgather", "reducescatter", "broadcast"):
        # data modes always take the shm plane, so every rank of a round
        # agrees on the protocol
        return _shm_plane(g, key, payload, op_str, mode)
    return ray_tpu_torch.get(g.handle.exchange.remote(key, g.rank, payload, op_str, mode))


def _shm_plane(g: _GroupInfo, key, payload, op_str, mode):
    """Ranks exchange ObjectRefs through the rendezvous actor, read each
    other's payloads from the store and reduce locally: the actor never
    holds world_size x the tensor's bytes. A closing barrier lets each
    rank free its own payload, so rounds leave nothing in the store."""
    if mode == "broadcast" and int(op_str) != g.rank:
        my_ref = (None,)  # only the src rank ships bytes
    else:
        # a 1-tuple: a bare ObjectRef argument would be resolved by the
        # task runtime; a nested one passes through as a reference
        my_ref = (ray_tpu_torch.put(payload),)
    refs = ray_tpu_torch.get(g.handle.exchange.remote(key, g.rank, my_ref, "sum", "allgather"))
    try:
        if mode == "broadcast":
            src = int(op_str)
            return payload if src == g.rank else ray_tpu_torch.get(refs[src][0])
        arrays = [payload if r == g.rank else ray_tpu_torch.get(refs[r][0]) for r in range(g.world_size)]
        if mode == "allgather":
            return arrays
        red = apply_reduce(ReduceOp(op_str), arrays)
        if mode == "reducescatter":
            return np.array_split(red, g.world_size, axis=0)[g.rank]
        return red
    finally:
        # every rank has read what it needs once it reaches this barrier;
        # then each rank frees its own payload object
        ray_tpu_torch.get(g.handle.exchange.remote(f"{key}::done", g.rank, None, "sum", "barrier"))
        if my_ref[0] is not None:
            ray_tpu_torch.internal_free([my_ref[0]])


def _like(result, tensor):
    """``result`` in the input's flavour: a torch tensor of the input's
    dtype on its device for a torch input, else as it came."""
    import torch

    if isinstance(tensor, torch.Tensor):
        return torch.as_tensor(np.asarray(result)).to(device=tensor.device, dtype=tensor.dtype)
    return result


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _g(group_name)
    return _like(_roundtrip(g, tensor, op, "allreduce"), tensor)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _g(group_name)
    out = _roundtrip(g, tensor, op, "allreduce")
    return _like(out, tensor) if g.rank == dst_rank else tensor


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _g(group_name)
    return _like(_roundtrip(g, tensor, src_rank, "broadcast"), tensor)


def allgather(tensor, group_name: str = "default"):
    g = _g(group_name)
    return [_like(r, tensor) for r in _roundtrip(g, tensor, "sum", "allgather")]


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _g(group_name)
    return _like(_roundtrip(g, tensor, op, "reducescatter"), tensor)


def barrier(group_name: str = "default"):
    g = _g(group_name)
    _roundtrip(g, None, "sum", "barrier")


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    g = _g(group_name)
    seq = g.next_p2p("send", dst_rank, tag)
    key = f"p2p:{g.rank}->{dst_rank}:{tag}:{seq}"
    payload = _host(tensor)
    if payload.nbytes >= _SHM_PLANE_THRESHOLD:
        # shm data plane; the actor relays a (wrapped, not resolved) ref
        payload = (ray_tpu_torch.put(payload),)
    ray_tpu_torch.get(g.handle.p2p_send.remote(key, payload))


def recv(shape_or_tensor, src_rank: int, group_name: str = "default", tag: int = 0):
    from ray_tpu_torch.core.object_ref import ObjectRef

    g = _g(group_name)
    seq = g.next_p2p("recv", src_rank, tag)
    key = f"p2p:{src_rank}->{g.rank}:{tag}:{seq}"
    out = ray_tpu_torch.get(g.handle.p2p_recv.remote(key))
    if isinstance(out, tuple) and len(out) == 1 and isinstance(out[0], ObjectRef):
        ref = out[0]
        out = ray_tpu_torch.get(ref)
        ray_tpu_torch.internal_free([ref])  # one consumer: free after the fetch
    return _like(out, shape_or_tensor)


class CollectiveActorMixin:
    """Gives an actor the ``__rt_init_collective__`` hook that
    ``declare_collective_group`` calls."""

    def __rt_init_collective__(self, world_size, rank, backend, group_name):
        init_collective_group(world_size, rank, backend, group_name)
        return rank
