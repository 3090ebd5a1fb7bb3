"""The process's client (port of ray_tpu/core/context.py): each process,
the driver or a worker, binds one client here (the head ``Runtime`` or a
``WorkerClient``); ObjectRefs and actor handles look it up when used, so
they can be pickled across processes and rebound on arrival.

It also names the ROADMAP.md items that the runtime's paths not ported
yet wait for; each such path raises ``NotImplementedError`` through
``not_ported``, naming its item.
"""

from __future__ import annotations

# ROADMAP.md queue 1 items that the runtime's remaining paths name
GRPC_ITEM = "queue 1, serve gRPC ingress"  # serve.start(grpc_port=...), serve/_grpc_proxy.py
LINT_ITEM = "queue 1, lint"  # rt lint, ray_tpu/lint/
MESH_ITEM = "queue 1, multi-device axes"  # meshes and shardings in training, a serving mesh with other axes than tp

_client = None


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, {item})")


def set_client(client):
    global _client
    _client = client


def get_client():
    if _client is None:
        raise RuntimeError("ray_tpu_torch is not initialized in this process; call ray_tpu_torch.init() first")
    return _client


def maybe_client():
    return _client


def is_initialized() -> bool:
    return _client is not None


class RuntimeContext:
    """The caller's view of where it runs (ray_tpu's RuntimeContext)."""

    def __init__(self, client):
        self._client = client

    @property
    def job_id(self):
        return getattr(self._client, "job_id", None)

    @property
    def node_id(self):
        return getattr(self._client, "node_id", None)

    @property
    def worker_id(self):
        return getattr(self._client, "worker_id", None)

    def get_actor_id(self):
        return getattr(self._client, "current_actor_id", None)

    def get_task_id(self):
        return getattr(self._client, "current_task_id", None)

    def get_assigned_resources(self):
        return getattr(self._client, "assigned_resources", {})

    def get_accelerator_ids(self):
        res = self.get_assigned_resources()
        return {"GPU": [str(i) for i in res.get("_gpu_ids", [])]}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_client())
