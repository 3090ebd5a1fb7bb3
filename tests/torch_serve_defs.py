"""Module-level deployment classes and functions for the Serve parity
tests (``tests/test_torch_serve*.py``): each test wraps the same
definition with ``ray_tpu.serve.deployment`` and with
``ray_tpu_torch.serve.deployment``. ray_tpu_torch sends a deployment's
code to its replicas by reference, so it must live at the top level of an
importable module; this one imports no jax, so a port replica that
imports it holds none.

``_serve()`` is the Serve package of the runtime this process runs (as
``torch_runtime_defs._rt``): code inside a replica reaches the package
that started the replica. ``@serve.batch`` and ``@serve.multiplexed``
belong to one package, so the classes that use them apply the decorator
of their own runtime's package when an instance is built."""

import asyncio
import os
import sys
import time

from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve.llm import LLMServer


def _serve():
    ctx = sys.modules.get("ray_tpu_torch.core.context")
    if ctx is not None and ctx.maybe_client() is not None:
        return tserve
    import ray_tpu.serve

    return ray_tpu.serve


# ---------------------------------------------------------------- test_serve.py
class Echo:
    def __call__(self, x):
        return ("echo", x)

    def shout(self, x):
        return str(x).upper()


def double(x):
    return 2 * x


class Greeter:
    def __init__(self, greeting):
        self.greeting = greeting
        self.suffix = ""

    def reconfigure(self, cfg):
        self.suffix = cfg.get("suffix", "")

    def __call__(self, name):
        return f"{self.greeting}, {name}{self.suffix}"


class WhoAmI:
    def __init__(self):
        self.pid = os.getpid()

    def __call__(self):
        time.sleep(0.05)
        return self.pid


class Adder:
    def __init__(self, amount):
        self.amount = amount

    def __call__(self, x):
        return x + self.amount


class Pipeline:
    def __init__(self, adder):
        self.adder = adder

    def __call__(self, x):
        return self.adder.remote(x).result(timeout_s=60) * 10


class V:
    def __call__(self):
        return 1


class V2:
    def __call__(self):
        return 2


def ok():
    return "ok"


class Api:
    def __call__(self, request):
        if request.path == "/sum":
            data = request.json()
            return {"sum": sum(data["xs"])}
        return {"path": request.path, "q": request.query_params}


class SlowAuto:
    def __call__(self):
        time.sleep(0.4)
        return "done"


class Fragile:
    def pid(self):
        return os.getpid()

    def die(self):
        os._exit(1)

    def __call__(self):
        return "alive"


# ---------------------------------------------------------------- test_serve_v2.py
class Streamer:
    def counts(self, n):
        for i in range(n):
            yield {"i": i}


class AStream:
    async def gen(self, n):
        for i in range(n):
            await asyncio.sleep(0.01)
            yield i * i


class SSE:
    def __call__(self, req):
        for i in range(4):
            yield f"tok{i}"


class Batcher:
    def __init__(self):
        self.batch_sizes = []
        self.score = _serve().batch(max_batch_size=8, batch_wait_timeout_s=0.25)(Batcher._score).__get__(self)

    def _score(self, items):
        self.batch_sizes.append(len(items))
        return [x * 10 for x in items]

    def __call__(self, x):
        return self.score(x)

    def sizes(self):
        return list(self.batch_sizes)


class SlowFor:
    def __call__(self, t):
        time.sleep(t)
        return "done"


class Infinite:
    def gen(self, path):
        i = 0
        while True:
            with open(path, "w") as f:
                f.write(str(i))
            yield i
            i += 1
            time.sleep(0.02)


class EchoAfter50ms:
    def __call__(self, x):
        time.sleep(0.05)
        return x


class WithHook:
    def __init__(self, marker):
        self.marker = marker

    def __call__(self, x):
        return x

    def shutdown(self):
        with open(self.marker, "w") as f:
            f.write("clean")


class GrpcApi:
    def __call__(self, x):
        return {"doubled": x * 2}

    def tokens(self, n):
        for i in range(n):
            yield {"t": i}


class _Model:
    def __init__(self, server, mid):
        self.server = server
        self.mid = mid

    def __call__(self, x):
        return f"{self.mid}:{x}"

    def close(self):
        self.server.evicted.append(self.mid)


class ModelServer:
    def __init__(self):
        self.loads = []
        self.evicted = []
        self.get_model = _serve().multiplexed(max_num_models_per_replica=2, evict_grace_s=0)(
            ModelServer._load).__get__(self)

    def _load(self, model_id: str):
        self.loads.append(model_id)
        return _Model(self, model_id)

    def __call__(self, x):
        mid = _serve().get_multiplexed_model_id()
        assert mid, "model id must reach the replica"
        return {"out": self.get_model()(x), "replica": id(self)}

    def stats(self):
        return {"replica": id(self), "loads": list(self.loads), "evicted": list(self.evicted)}


# ---------------------------------------------------------------- test_async_proxy.py
class EchoJson:
    def __call__(self, request):
        return {"got": request.json()}


class StreamFive:
    def __call__(self, request):
        for i in range(5):
            yield f"t{i} "


class SlowRoutes:
    """A stand-in for the Serve controller's application table that takes
    ``delay_s`` to answer: one application, routed at /new."""

    def __init__(self, delay_s):
        self.delay_s = delay_s

    def list_applications(self):
        time.sleep(self.delay_s)
        return {"new": {"route_prefix": "/new", "ingress": "Ingress"}}


class SleepsThirty:
    def __call__(self, request):
        time.sleep(30)
        return "late"


# ---------------------------------------------------------------- the port's own
class Visible:
    def __call__(self):
        return {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()}


@tserve.deployment
class Decorated:
    """``@serve.deployment`` at the top level of an importable module: the
    module's name is rebound to the Deployment."""

    def __call__(self, x):
        return ("decorated", x, os.getpid())


@tserve.deployment
def decorated_fn(x):
    return x + 1


class ToyTokenizer:
    """A byte tokenizer for the OpenAI surface: each character its code
    point modulo the vocabulary, offset by one (0 stays unused)."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str) -> list:
        return [1 + ord(c) % (self.vocab - 1) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(32 + int(t) % 95) for t in ids)


class TpLLMServer(LLMServer):
    """The tensor-parallel replica's class: LLMServer with a probe of its
    engine's rank processes."""

    def tp_pids(self):
        return self.engine.tp_pids
