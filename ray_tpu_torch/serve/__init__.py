"""ray_tpu_torch.serve: model serving on the port's runtime (port of
ray_tpu/serve/).

The controller (one named actor) reconciles each deployment's replicas
(actors, pinned to cards when they ask for them) to their target,
handles route with power-of-two choices and push the demand the
autoscaler reads, and the HTTP proxies (asyncio by default, or the
stdlib thread-per-connection server) route by longest prefix. Batching
(``@serve.batch``) and multiplexing (``@serve.multiplexed``) run inside
the replicas. ``llm.py`` builds the LLM deployments over the port's
engine (``serve.run(build_llm_deployment(LLMConfig(...)))``), and
``overload.py`` is their overload plane: typed 429s, admission control,
drain, the shared retry budget.

A deployment's code travels to its replicas by reference (module and
qualified name): decorate a class or function at the top level of an
importable module or of a driver script with a file. The gRPC ingress is
not ported (ROADMAP.md, queue 1, Serve gRPC ingress).
"""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("serve")

from ray_tpu_torch.serve._proxy import Request
from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions, ReplicaConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse, DeploymentResponseGenerator
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.overload import (
    AdmissionConfig,
    AdmissionController,
    OverloadedError,
    ReplicaDrainingError,
    RetryBudget,
    StepperDiedError,
    http_error_of,
    is_overloaded,
    retry_hint_of,
    router_terminal,
    shed_class_of,
    wait_for_drain,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "HTTPOptions",
    "OverloadedError",
    "ReplicaConfig",
    "ReplicaDrainingError",
    "Request",
    "RetryBudget",
    "StepperDiedError",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "http_error_of",
    "is_overloaded",
    "multiplexed",
    "retry_hint_of",
    "router_terminal",
    "run",
    "shed_class_of",
    "shutdown",
    "start",
    "status",
    "wait_for_drain",
]
