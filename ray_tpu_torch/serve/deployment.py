"""``@serve.deployment``, ``Deployment`` and the ``bind()`` application
graph (port of ray_tpu/serve/deployment.py). Binding another
deployment's node as an init argument becomes a ``DeploymentHandle`` when
the replica is built, which is how model-composition apps are made.

**Code travels by reference.** The deploy payload carries the decorated
class or function as its module and qualified name
(``core/serialization.py::code_ref``), and the replica imports it there
(``resolve_code``); ray_tpu ships it by value. ``@serve.deployment``
rebinds the module's name to the ``Deployment``, which stdlib pickle would
refuse; ``Deployment._rt_target`` names the class or function inside, and
``resolve_code`` unwraps it. A closure, a lambda or a class of a
``__main__`` with no file raises ``TypeError`` at ``serve.run``, before
anything reaches the controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ray_tpu_torch.core.serialization import code_ref
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, ReplicaConfig


@dataclass
class _HandleMarker:
    """Placeholder for a bound sub-deployment inside init args; resolved to
    a DeploymentHandle inside the replica (``_replica.py``)."""

    app_name: str | None
    deployment: str


class Application:
    """A bound deployment graph node (``Deployment.bind``'s result)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _collect(self, out: dict):
        """DFS the graph, dedup by deployment name."""
        if self.deployment.name in out:
            return
        out[self.deployment.name] = self
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                a._collect(out)


@dataclass
class Deployment:
    func_or_class: object
    name: str
    config: DeploymentConfig = field(default_factory=DeploymentConfig)
    replica_config: ReplicaConfig = field(default_factory=ReplicaConfig)

    @property
    def _rt_target(self):
        return self.func_or_class

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **kw) -> "Deployment":
        """Copy with overrides."""
        cfg_fields = {f for f in DeploymentConfig.__dataclass_fields__}
        rep_fields = {f for f in ReplicaConfig.__dataclass_fields__}
        cfg_kw = {k: v for k, v in kw.items() if k in cfg_fields}
        rep_kw = {k: v for k, v in kw.items() if k in rep_fields}
        other = {k: v for k, v in kw.items() if k not in cfg_fields and k not in rep_fields and k != "ray_actor_options"}
        name = other.pop("name", self.name)
        if "ray_actor_options" in kw:
            rao = kw["ray_actor_options"] or {}
            rep_kw.setdefault("num_cpus", rao.get("num_cpus", self.replica_config.num_cpus))
            rep_kw.setdefault("resources", rao.get("resources", dict(self.replica_config.resources)))
        if other:
            raise TypeError(f"unknown deployment options: {sorted(other)}")
        if isinstance(cfg_kw.get("autoscaling_config"), dict):
            cfg_kw["autoscaling_config"] = AutoscalingConfig(**cfg_kw["autoscaling_config"])
        if cfg_kw.get("num_replicas") == "auto":
            cfg_kw["num_replicas"] = None
            cfg_kw.setdefault("autoscaling_config", self.config.autoscaling_config or AutoscalingConfig())
        return Deployment(
            self.func_or_class,
            name,
            replace(self.config, **cfg_kw),
            replace(self.replica_config, **rep_kw),
        )


def deployment(_func_or_class=None, **kw):
    """@serve.deployment / @serve.deployment(num_replicas=..., ...)"""

    def make(target):
        d = Deployment(target, getattr(target, "__name__", "deployment"))
        return d.options(**kw) if kw else d

    if _func_or_class is not None:
        return make(_func_or_class)
    return make


def build_app_spec(app: Application, app_name: str) -> tuple[list[dict], str]:
    """Flatten a bound graph into the controller's deploy payload.

    Returns ([{name, cls_or_fn, init_args, init_kwargs, config,
    replica_config}], ingress_name): ``cls_or_fn`` is the (module,
    qualified name) pair a replica imports, and Application-valued args
    become _HandleMarker(app_name, dep_name). TypeError when a
    deployment's code has no name a worker can import.
    """
    nodes: dict[str, Application] = {}
    app._collect(nodes)

    def mark(v):
        return _HandleMarker(app_name, v.deployment.name) if isinstance(v, Application) else v

    specs = []
    for name, node in nodes.items():
        specs.append(
            {
                "name": name,
                "cls_or_fn": code_ref(node.deployment.func_or_class),
                "init_args": tuple(mark(a) for a in node.args),
                "init_kwargs": {k: mark(v) for k, v in node.kwargs.items()},
                "config": node.deployment.config,
                "replica_config": node.deployment.replica_config,
            }
        )
    return specs, app.deployment.name
