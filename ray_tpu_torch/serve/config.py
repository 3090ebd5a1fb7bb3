"""Serve configuration dataclasses (port of ray_tpu/serve/config.py):
replica counts, per-replica concurrency, the autoscaling window, the
HTTP ingress's options and the resources a replica holds.

One difference, kept on purpose (ROADMAP.md, Differences kept on
purpose): ``ReplicaConfig.num_tpus`` keeps ray_tpu's field name but is
passed to the replica actor as the actor option ``num_tpus``, which the
port's scheduler folds into the card resource ``"GPU"``
(``core/runtime.py::_sched_options``, whole cards: 1, 2, 4 or 8). ray_tpu
puts it into ``resources={"TPU": n}``; on the port's runtime ``"TPU"`` is
a custom resource no node has, and such a replica would stay pending.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalingConfig:
    """Request-driven replica autoscaling: the controller's decision
    logic reads these (``_controller.py::_autoscale``)."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    # smoothing: how long a scale decision must persist before acting
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.2
    look_back_period_s: float = 2.0
    upscaling_factor: float = 1.0
    downscaling_factor: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError("need 0 <= min_replicas <= max_replicas, max >= 1")


@dataclass
class DeploymentConfig:
    num_replicas: int | None = 1
    max_ongoing_requests: int = 5
    autoscaling_config: AutoscalingConfig | None = None
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    user_config: dict | None = None

    def initial_target(self) -> int:
        if self.autoscaling_config is not None:
            return max(self.autoscaling_config.min_replicas, 1)
        return self.num_replicas or 1


@dataclass
class ReplicaConfig:
    """What each replica actor needs from the scheduler. ``num_tpus``
    counts cards: the port's scheduler reads it as ``"GPU"``."""

    num_cpus: float = 1.0
    num_tpus: float = 0.0
    resources: dict = field(default_factory=dict)

    def to_actor_options(self) -> dict:
        opts = {"num_cpus": self.num_cpus}
        if self.num_tpus:
            opts["num_tpus"] = self.num_tpus
        if self.resources:
            opts["resources"] = dict(self.resources)
        return opts


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    # end-to-end per-request deadline; on expiry the proxy responds 504
    # and cancels the replica task
    request_timeout_s: float = 60.0
    # the asyncio ingress (_async_proxy.py): keep-alive and streaming
    # backpressure with O(1) threads. False falls back to the stdlib
    # thread-per-connection server (_proxy.py).
    async_proxy: bool = True
