"""Serving (port of ray_tpu/serve/), the in-process half: the overload
plane (``overload.py``: typed 429s, admission control, drain, the shared
retry budget). The controller, replicas, handles and the HTTP proxy are
ROADMAP.md queue 1's next item (serve wiring for GPU replicas), over the
port's runtime.
"""

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
    "OverloadedError",
    "ReplicaDrainingError",
    "RetryBudget",
    "StepperDiedError",
    "http_error_of",
    "is_overloaded",
    "retry_hint_of",
    "router_terminal",
    "shed_class_of",
    "wait_for_drain",
]
