"""Train-scoped collectives (port of ray_tpu/train/collective.py):
``barrier``, ``broadcast_from_rank_zero`` and ``allreduce`` between the
workers of one worker-group attempt, on that attempt's group of
``ray_tpu_torch.collective`` (backend ``"object_store"``). These are the
control plane; gradients of a torch loop go through ``torch.distributed``
(``backend.py``)."""

from __future__ import annotations

import pickle

import numpy as np

import ray_tpu_torch.collective as col
from ray_tpu_torch.train import context as _ctx

_GROUP = "_rt_train"


def _ensure_group():
    ctx = _ctx.get_context()
    if ctx is None:
        raise RuntimeError("train collectives must be called inside a train worker")
    # attempt_uid keeps the rendezvous actor's name unique per attempt, so a
    # restarted group never collides with the (detached) actor of a failed one
    name = group_name_for_attempt(ctx.get_experiment_name(), ctx._attempt_uid)
    try:
        col.get_rank(name)
    except KeyError:
        col.init_collective_group(ctx.get_world_size(), ctx.get_world_rank(), "object_store", name)
    return name


def group_name_for_attempt(experiment_name: str, attempt_uid: str) -> str:
    """Controller-side name of the per-attempt train collective group."""
    return f"{_GROUP}:{experiment_name}:{attempt_uid}"


def barrier():
    """Block until every train worker reaches the barrier."""
    col.barrier(_ensure_group())


def broadcast_from_rank_zero(data):
    """Rank 0's ``data`` is returned on every worker."""
    name = _ensure_group()
    ctx = _ctx.get_context()
    payload = np.frombuffer(pickle.dumps(data), dtype=np.uint8) if ctx.get_world_rank() == 0 else np.zeros(0, np.uint8)
    out = col.broadcast(payload, src_rank=0, group_name=name)
    return pickle.loads(bytes(bytearray(out)))


def allreduce(array, op=col.ReduceOp.SUM):
    """Elementwise allreduce (SUM by default) of an array across the train
    worker group: the GBDT trainer's histogram sync."""
    return col.allreduce(array, group_name=_ensure_group(), op=op)
