"""Module-level functions and classes for the port's cluster tests
(``tests/test_torch_{gcs_ft,driver_attach,transport,distributed,job}.py``).
ray_tpu_torch sends code to its workers by reference, so what a worker
runs lives at the top level of an importable module; this one imports no
jax, so a port worker that imports it holds none."""

import os
import time

import numpy as np


def pid():
    return os.getpid()


def pid_and_parent():
    return os.getpid(), os.getppid()


def arange(n):
    return np.arange(n, dtype=np.float64)


def full(n, v):
    return np.full(n, v)


def ones(n):
    return np.ones(n)


def zeros(n):
    return np.zeros(n)


def total(a):
    return float(a.sum())


def put_inner(n):
    import ray_tpu_torch

    return [ray_tpu_torch.put(np.ones(n))]


def slow_done(s):
    time.sleep(s)
    return "done"


def plus_one(x):
    return x + 1


def ok():
    return "ok"


def raise_unknown_to_the_agent(modname):
    """Raise an exception whose class lives in a module made in this
    process alone (a node agent cannot import it), its message holding the
    bytes of a request kind the agent answers."""
    import sys
    import types

    m = types.ModuleType(modname)
    exec("class Boom(Exception):\n    pass\n", m.__dict__)
    sys.modules[modname] = m
    raise m.Boom("agent_req")


def node_tag(batch):
    """The node a Data map ran on, as the first 8 hex digits of its id."""
    from ray_tpu_torch.core import context

    return {"nid": np.array([int(context.get_client().node_id.hex()[:8], 16)])}


def block_on_node(i, tag):
    """A shm-sized Data block (a dict of numpy columns), made on the node
    the task runs on."""
    return {"x": np.full(16_384, tag + i, np.float64)}


class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n

    def add(self, k):
        self.n += k
        return self.n

    def pid(self):
        return os.getpid()

    def die(self):
        os._exit(1)


class Board:
    def __init__(self):
        self.v = None

    def set(self, v):
        self.v = v

    def get(self):
        return self.v


class Sleeper:
    def nap(self, s):
        time.sleep(s)
        return "done"


def gloo_allgather(config):
    """A train loop: every rank's rank + 1 gathered over the group's
    torch.distributed (gloo) and summed."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import get_context, report

    rank = get_context().get_world_rank()
    out = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([rank + 1.0]))
    report({"rank": rank, "total": float(sum(t.item() for t in out)), "nproc": dist.get_world_size(),
            "ns": os.environ.get("RT_SHM_NS", "")})
