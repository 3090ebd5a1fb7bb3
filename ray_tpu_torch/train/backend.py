"""Backend plugin interface and the two backends (port of
ray_tpu/train/backend.py).

``JaxConfig`` keeps ray_tpu's name and its ``distributed`` modes
("auto": bootstrap when the group has more than one worker; "never";
"always"), with a ``torch.distributed`` bootstrap where ray_tpu runs
``jax.distributed.initialize``: worker 0 picks a free TCP port, every
worker joins ``init_process_group`` with its world rank, the backend
``"nccl"`` on workers bound to a card and ``"gloo"`` otherwise.
``TorchConfig`` is ray_tpu's (TCP rendezvous, gloo by default) and
bootstraps only groups of more than one worker, as ray_tpu's does.
``on_shutdown`` destroys the process group.

The hooks and the functions they run in the workers are module-level
functions here: the port sends code to workers by reference. The
coordinator is the loopback address: the port's runtime is one host
(multi-host agents are not ported).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BackendConfig:
    # set in every worker process before the user loop runs
    env_vars: dict | None = None

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by the controller around the worker group's lifecycle."""

    def on_start(self, worker_group, backend_config):
        pass

    def on_training_start(self, worker_group, backend_config):
        pass

    def on_shutdown(self, worker_group, backend_config):
        pass


# ----------------------------------------------------------------------
# "JAX" backend: ray_tpu's name, a torch.distributed bootstrap behind it
# ----------------------------------------------------------------------
@dataclass
class JaxConfig(BackendConfig):
    """distributed: "auto" bootstraps torch.distributed when num_workers > 1,
    "never" skips it, "always" forces it (a one-rank group included)."""

    distributed: str = "auto"

    @property
    def backend_cls(self):
        return _JaxBackend


def _bootstrap(worker_group, backend: str | None):
    """torch.distributed over TCP on every worker of the group."""
    host, port = worker_group.execute_single(0, _free_coordinator_addr)
    worker_group.execute(_init_torch_process_group, f"tcp://{host}:{port}", len(worker_group), backend)


class _JaxBackend(Backend):
    def on_start(self, worker_group, backend_config: "JaxConfig"):
        mode = backend_config.distributed
        if mode == "never" or (mode == "auto" and len(worker_group) <= 1):
            return
        _bootstrap(worker_group, None)  # nccl on card-bound workers, gloo elsewhere

    def on_shutdown(self, worker_group, backend_config):
        try:
            worker_group.execute(_destroy_torch_process_group)
        except Exception:
            pass


def _free_coordinator_addr():
    """Runs on worker 0: the loopback address and a free port on it,
    checked by a dial."""
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
        return "127.0.0.1", port
    finally:
        srv.close()


def bound_to_card() -> bool:
    """Whether this worker holds a card that CUDA can reach: its train
    context says it asked for one (the runtime then set
    CUDA_VISIBLE_DEVICES) and CUDA sees a device."""
    import torch

    from ray_tpu_torch.train import context as _ctx

    ctx = _ctx.get_context()
    return bool(ctx is not None and ctx._num_gpus > 0 and torch.cuda.is_available())


def _init_torch_process_group(init_method: str, world_size: int, backend: str | None):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import context as _ctx

    if backend is None:
        backend = "nccl" if bound_to_card() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)  # the first card this worker sees: its own
    rank = _ctx.get_context().get_world_rank()
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size, rank=rank)
    return backend


def _destroy_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# Torch backend (ray_tpu's TorchConfig: TCP rendezvous + gloo)
# ----------------------------------------------------------------------
@dataclass
class TorchConfig(BackendConfig):
    backend: str = "gloo"
    init_method: str = "tcp"
    timeout_s: int = 1800

    @property
    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: "TorchConfig"):
        if len(worker_group) <= 1:
            return
        _bootstrap(worker_group, backend_config.backend)

    def on_shutdown(self, worker_group, backend_config):
        try:
            worker_group.execute(_destroy_torch_process_group)
        except Exception:
            pass
