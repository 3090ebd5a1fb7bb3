"""Collective types (port of ray_tpu/collective/types.py): the backends
and reduce ops, and ``apply_reduce`` on numpy arrays."""

from __future__ import annotations

from enum import Enum

import numpy as np


class Backend(str, Enum):
    # rendezvous-actor backend: tensors exchanged through the object store
    # (host memory) -- works anywhere, any process topology
    OBJECT_STORE = "object_store"
    # alias kept for API compatibility with code written for gloo
    GLOO = "gloo"
    # ray_tpu's backend for device arrays over a shared mesh: a group of it
    # takes the object-store path, as in ray_tpu, and results come back in
    # the input's flavour (a torch tensor on its device); the in-process
    # device collectives are collective/ici.py
    XLA = "xla"

    @staticmethod
    def normalize(b: "Backend | str") -> "Backend":
        b = Backend(b) if not isinstance(b, Backend) else b
        if b == Backend.GLOO:
            return Backend.OBJECT_STORE
        if b in (Backend.OBJECT_STORE, Backend.XLA):
            return b
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
