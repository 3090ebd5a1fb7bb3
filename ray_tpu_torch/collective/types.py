"""Collective types (port of ray_tpu/collective/types.py): the backends
and reduce ops, and ``apply_reduce`` on numpy arrays."""

from __future__ import annotations

from enum import Enum

import numpy as np

from ray_tpu_torch.core.context import MESH_ITEM


class Backend(str, Enum):
    # rendezvous-actor backend: tensors exchanged through the object store
    # (host memory) -- works anywhere, any process topology
    OBJECT_STORE = "object_store"
    # alias kept for API compatibility with code written for gloo
    GLOO = "gloo"
    # ray_tpu's backend for device arrays over a shared mesh (collective/ici.py)
    XLA = "xla"

    @staticmethod
    def normalize(b: "Backend | str") -> "Backend":
        b = Backend(b) if not isinstance(b, Backend) else b
        if b == Backend.GLOO:
            return Backend.OBJECT_STORE
        if b == Backend.OBJECT_STORE:
            return b
        if b == Backend.XLA:
            raise NotImplementedError(
                "the collective backend 'xla' (device collectives over a shared mesh, ray_tpu's collective/ici.py) "
                f"is not ported to ray_tpu_torch yet (ROADMAP.md, {MESH_ITEM})")
        raise ValueError(f"unsupported backend {b}")


class ReduceOp(str, Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


def apply_reduce(op: ReduceOp, arrays: list):
    op = ReduceOp(op)
    stack = np.stack([np.asarray(a) for a in arrays])
    if op == ReduceOp.SUM:
        return stack.sum(axis=0)
    if op == ReduceOp.PRODUCT:
        return stack.prod(axis=0)
    if op == ReduceOp.MIN:
        return stack.min(axis=0)
    if op == ReduceOp.MAX:
        return stack.max(axis=0)
    if op == ReduceOp.MEAN:
        return stack.mean(axis=0)
    raise ValueError(op)
