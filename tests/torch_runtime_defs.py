"""Module-level functions and classes for the runtime parity tests
(``tests/test_torch_runtime_*.py``): each test wraps the same definition
with ``ray_tpu.remote`` and with ``ray_tpu_torch.remote``. ray_tpu_torch
sends code to its workers by reference, so what a worker runs must live at
the top level of an importable module; this one imports no jax, so a port
worker that imports it holds none.

``_rt()`` is the package whose runtime this process runs: a nested call
inside a task goes back to the runtime that started the task."""

import asyncio
import os
import sys
import time


def _rt():
    ctx = sys.modules.get("ray_tpu_torch.core.context")
    if ctx is not None and ctx.maybe_client() is not None:
        import ray_tpu_torch

        return ray_tpu_torch
    import ray_tpu

    return ray_tpu


# ---------------------------------------------------------------- tasks
def add(a, b):
    return a + b


def double(x):
    return 2 * x


def kw(a, b=1, c=2):
    return a + b + c


def mean_and_copy(x):
    return float(x.mean()), x * 2


def three():
    return 1, 2, 3


def boom():
    raise ValueError("kaboom")


def dep_boom():
    raise ValueError("dep failed")


def ident(x):
    return x


def sleepy(t):
    time.sleep(t)
    return t


def forever():
    time.sleep(60)


def inner(x):
    return x + 1


def outer(x):
    rt = _rt()
    return rt.get(rt.remote(inner).remote(x), timeout=60) + 10


def consume_refs(refs):
    rt = _rt()
    return sum(rt.get(r, timeout=60) for r in refs)


def die():
    os._exit(1)


def flaky(path):
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("1")
        raise RuntimeError("first attempt fails")
    return "ok"


def gen(n):
    for i in range(n):
        yield i * i


def sq(i):
    return i * i


def loaded_modules():
    """The jax, jaxlib and ray_tpu* modules this process holds, and whether it is the port's worker."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "cloudpickle"))
    return bad, "ray_tpu_torch.core.worker_main" in sys.modules


def card_env():
    """What a card-bound worker sees: its CUDA_VISIBLE_DEVICES (ray_tpu's
    TPU_VISIBLE_CHIPS), its assigned resources and its pid."""
    rt = _rt()
    res = rt.get_runtime_context().get_assigned_resources()
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), os.environ.get("TPU_VISIBLE_CHIPS"),
            sorted(k for k in res if not k.startswith("_")), os.getpid())


def touch(path):
    with open(path, "w") as f:
        f.write("ran")
    return True


def pid():
    return os.getpid()


def where():
    time.sleep(0.2)
    return _rt().get_runtime_context().node_id.hex()


def made():
    return "made"


def forty_two():
    return 42


def in_pg():
    return "in-pg"


def slow_on_doomed():
    time.sleep(1.5)
    return "done"


def produce(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 100, size=(50_000,))


# ---------------------------------------------------------------- actors
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def read(self):
        return self.n


class Bad:
    def boom(self):
        raise RuntimeError("actor method failed")

    def ok(self):
        return "fine"


class FailsInit:
    def __init__(self):
        raise ValueError("init failed")

    def m(self):
        return 1


class Phoenix:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n

    def die(self):
        os._exit(1)

    def pid(self):
        return os.getpid()


def use_counter(c):
    rt = _rt()
    return rt.get(c.incr.remote(10), timeout=60)


class Front:
    def __init__(self, backend):
        self.backend = backend

    def go(self):
        rt = _rt()
        return rt.get(self.backend.incr.remote(), timeout=60) + 100


class AsyncWorker:
    async def work(self, t, v):
        await asyncio.sleep(t)
        return v


class Slow:
    def work(self, t):
        time.sleep(t)
        return t


class Gen:
    def stream(self, n):
        for i in range(n):
            yield i


class Hi:
    def hi(self):
        return "hi"


class CardHolder:
    def env(self):
        return card_env()

    def big(self, path, seed):
        return counted_big(path, seed)


# ---------------------------------------------------------------- direct calls
def total(xs):
    return sum(xs)


def inc(x):
    return x + 1


def die_once(path):
    if not os.path.exists(path):
        with open(path, "w"):
            pass
        os._exit(1)  # the leased worker dies mid-call
    return "second"


def big(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 100, size=(60_000,))


def counted_big(path, seed):
    """``big(seed)``, past the inline limit, with each run counted in ``path``."""
    with open(path, "a") as f:
        f.write("ran\n")
    return big(seed)


def worker_facts():
    """The worker's parent (the process that forked it) and its sys.path."""
    return os.getppid(), list(sys.path)


class Seq:
    def __init__(self):
        self.log = []

    def add(self, i):
        self.log.append(i)
        return len(self.log)

    def get_log(self):
        return list(self.log)


class Rec:
    def __init__(self):
        self.log = []

    def mark(self, x):
        self.log.append(x)
        return x

    def stream(self, n):
        for i in range(n):
            self.log.append(f"s{i}")
            yield i

    def get_log(self):
        return list(self.log)


class Sleeper:
    def nap(self, s):
        time.sleep(s)
        return "ok"


class Restarting:
    def __init__(self):
        self.calls = 0

    def work(self, die=False):
        self.calls += 1
        if die:
            os._exit(1)
        return self.calls

    def pid(self):
        return os.getpid()


class Echo:
    def hi(self, x):
        return x
