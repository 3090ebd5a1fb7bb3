"""Module-level code for the runtime_env and observability twins
(``tests/test_torch_runtime_env.py``, ``test_torch_observability.py``,
``test_torch_usage.py``): each test wraps the same definition with
``ray_tpu.remote`` and ``ray_tpu_torch.remote``. ray_tpu_torch sends code
by reference, so these live at the top level of an importable module; it
imports no jax. ``_rt()`` is the package of this process's runtime (a
nested call goes back to the runtime that started the task), ``_metrics``
its metrics module."""

import os
import sys
import threading
import time


def _rt():
    ctx = sys.modules.get("ray_tpu_torch.core.context")
    if ctx is not None and ctx.maybe_client() is not None:
        import ray_tpu_torch

        return ray_tpu_torch
    import ray_tpu

    return ray_tpu


def _metrics():
    if _rt().__name__ == "ray_tpu_torch":
        from ray_tpu_torch.util import metrics
    else:
        from ray_tpu.util import metrics
    return metrics


# ---------------------------------------------------------------- runtime_env
def probe():
    """Reads the working_dir's file from the cwd and imports a module that
    only the runtime_env's py_modules hold."""
    import shiny_helper  # from py_modules

    with open("data.txt") as f:
        return f.read(), shiny_helper.VALUE, os.getcwd()


def probe_module_code():
    """The same, where the caller's code is the py_modules module's own."""
    import shiny_helper

    return shiny_helper.answer()


def plain_cwd():
    return os.getcwd(), os.environ.get("RT_WORKER_ID")


def cwd_and_worker():
    return os.getcwd(), os.environ.get("RT_WORKER_ID")


def one():
    return 1


class Flavor:
    def flavor(self):
        return os.environ.get("ACTOR_FLAVOR")


# ---------------------------------------------------------------- observability
def work(i):
    """Increments a counter, then outlives the worker's 1 s flush period."""
    _metrics().Counter("worker_ops_total", tag_keys=()).inc(1.0)
    time.sleep(1.3)
    return i


def step(i):
    time.sleep(0.05)
    return i


def chatty():
    print("hello-from-worker-stdout-xyzzy", flush=True)
    print("hello-from-worker-stderr-xyzzy", file=sys.stderr, flush=True)
    return 1


def hold(marker_path, release_path, result):
    """Holds its worker until ``release_path`` exists (at most 60 s); the
    first attempt writes ``marker_path``'s line, so a retry is seen."""
    with open(marker_path, "a") as f:
        f.write(f"{os.getpid()}\n")
    deadline = time.monotonic() + 60
    while not os.path.exists(release_path) and time.monotonic() < deadline:
        time.sleep(0.05)
    return result


def hold_retry(marker_path, release_path, result):
    """As ``hold``, but a retry (the marker already written) returns at once."""
    if os.path.exists(marker_path):
        return result
    return hold(marker_path, release_path, result)


def deep_in_user_code(release_path):
    deadline = time.monotonic() + 60
    while not os.path.exists(release_path) and time.monotonic() < deadline:
        time.sleep(0.05)


def busy(marker, release_path):
    deep_in_user_code(release_path)
    return marker


def child(x):
    return x + 1


def parent(x):
    rt = _rt()
    return rt.get(rt.remote(child).remote(x)) + 10


def thread_names():
    return sorted(t.name for t in threading.enumerate())


def bump_once(name):
    """Increments a counter and returns this worker's pid at once."""
    _metrics().Counter(name, tag_keys=()).inc(1.0)
    return os.getpid()


class Counting:
    def __init__(self):
        self.n = 0

    def bump(self, name):
        _metrics().Counter(name, tag_keys=()).inc(1.0)
        self.n += 1
        return self.n
