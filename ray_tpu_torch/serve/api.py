"""serve public API: run / delete / status / handles / shutdown (port of
ray_tpu/serve/api.py). The controller is one named actor, created on
first use; the HTTP proxy lives in the calling process.

The gRPC ingress is not ported: the card's machine has no ``grpcio``.
``start(grpc_port=...)`` raises NotImplementedError naming its ROADMAP.md
item (``core/context.py::GRPC_ITEM``).
"""

from __future__ import annotations

import time

import ray_tpu_torch
from ray_tpu_torch.core import context
from ray_tpu_torch.serve._controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.deployment import Application, build_app_spec
from ray_tpu_torch.serve.handle import DeploymentHandle

_http_proxy = None


def _get_or_create_controller(http_options: HTTPOptions | None = None):
    ray_tpu_torch.api._auto_init()
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        pass
    return (
        ray_tpu_torch.remote(ServeController)
        .options(name=CONTROLLER_NAME, max_concurrency=32, max_restarts=1)
        .remote(http_options)
    )


def start(http_options: HTTPOptions | None = None, proxy: bool = False, grpc_port: int | None = None):
    """Start the Serve control plane (idempotent); optionally the HTTP
    proxy (its port: serve.api._http_proxy.port). ``grpc_port`` raises
    NotImplementedError: the gRPC ingress is not ported."""
    if grpc_port is not None:
        context.not_ported(f"the gRPC ingress (serve.start(grpc_port={grpc_port}))", context.GRPC_ITEM)
    controller = _get_or_create_controller(http_options)
    if proxy:
        _ensure_proxy(controller, http_options or HTTPOptions())
    return controller


def _ensure_proxy(controller, http_options: HTTPOptions):
    global _http_proxy
    if _http_proxy is None:
        if getattr(http_options, "async_proxy", True):
            from ray_tpu_torch.serve._async_proxy import AsyncHTTPProxy as _Proxy
        else:
            from ray_tpu_torch.serve._proxy import HTTPProxy as _Proxy

        _http_proxy = _Proxy(controller, http_options)
        _http_proxy.start()
    return _http_proxy


def run(app: Application, name: str = "default", route_prefix: str = "/", *, blocking_timeout_s: float = 60.0, _blocking: bool = True):
    """Deploy an application and wait for it to be RUNNING; returns the
    ingress DeploymentHandle. TypeError, before anything is deployed,
    when a deployment's code has no name a worker can import."""
    specs, ingress = build_app_spec(app, name)
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs, ingress, route_prefix))
    if _blocking:
        deadline = time.time() + blocking_timeout_s
        while time.time() < deadline:
            st = ray_tpu_torch.get(controller.get_app_status.remote(name))
            if st["status"] == "RUNNING":
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(f"application {name!r} did not become RUNNING within {blocking_timeout_s}s: {st}")
    return DeploymentHandle(controller, name, ingress)


def delete(name: str):
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name))


def status() -> dict:
    controller = _get_or_create_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote())
    return {"applications": {a: ray_tpu_torch.get(controller.get_app_status.remote(a)) for a in apps}}


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_or_create_controller()
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name))
    if ingress is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(controller, name, ingress)


def get_deployment_handle(deployment: str, app_name: str = "default") -> DeploymentHandle:
    controller = _get_or_create_controller()
    return DeploymentHandle(controller, app_name, deployment)


def shutdown():
    """Tear down all applications, replicas, proxies, and the controller
    (a no-op, starting no runtime, when none is running)."""
    global _http_proxy
    if _http_proxy is not None:
        _http_proxy.stop()
        _http_proxy = None
    if not ray_tpu_torch.is_initialized():
        return
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=10)
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
