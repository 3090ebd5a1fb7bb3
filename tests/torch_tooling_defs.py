"""Module-level code for the cross-language and cluster-tooling twins
(``tests/test_torch_xlang.py``, ``_autoscaler.py``, ``_dashboard.py``,
``_profiling.py``, ``_lock_sanitizer.py``): each test wraps the same
definition with ``ray_tpu.remote`` and ``ray_tpu_torch.remote``, or
exports it to both packages' xlang servers. ray_tpu_torch sends code by
reference, so these live at the top level of an importable module; it
imports no jax. ``_rt()`` is the package of this process's runtime."""

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


# ---------------------------------------------------------------- xlang exports
def double_it(payload: bytes) -> str:
    return str(int(payload.decode()) * 2)


def describe(payload: bytes) -> dict:
    return {"name": payload.decode(), "len": len(payload)}


def upper(payload: bytes) -> bytes:
    return payload.upper()


def repeat_mib(payload: bytes) -> bytes:
    """The payload repeated to 4 MiB: a result large enough that the
    worker seals it in the head's store (a REDIRECT in the port's plane)."""
    return bytes(payload) * ((4 << 20) // len(payload))


def echo_generate(payload: bytes) -> dict:
    """A stand-in for a generate function: each prompt's tokens reversed."""
    import json

    prompts = json.loads(payload)
    return {"tokens": [list(reversed(p)) for p in prompts], "n": len(prompts)}


# ---------------------------------------------------------------- tasks and actors
def node_hex():
    return _rt().get_runtime_context().node_id.hex()


def hold(seconds: float = 3.0):
    time.sleep(seconds)
    return 1


def pid():
    return os.getpid()


def nop():
    return 1


def two():
    return 2


def double(x):
    return x * 2


class Pinger:
    def ping(self):
        return "pong"


def attention_ops(seed: int = 0):
    """K1's plain version at a small shape, on the CPU: the ops a profile
    of it names."""
    import torch

    from ray_tpu_torch.ops.flash_attention import attention_with_lse_ref

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((1, 4, 32, 16), generator=g)
    k, v = (torch.randn((1, 2, 32, 16), generator=g) for _ in range(2))
    return attention_with_lse_ref(q, k, v, causal=True)
