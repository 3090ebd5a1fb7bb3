"""Serve controller: owns target state and reconciles the world to it
(port of ray_tpu/serve/_controller.py): the replica state machine
STARTING -> RUNNING -> STOPPING, health checks, request-metric
autoscaling, graceful stop and redeploy.

One controller actor per cluster (named SERVE_CONTROLLER). A background
reconcile thread drives, per deployment:

  target replicas  ->  start/stop replica actors (STARTING -> RUNNING
  after first successful health ping; STOPPING drains then kills)
  health checks    ->  dead/unhealthy replicas are torn down and replaced
  autoscaling      ->  handle-reported (queued + ongoing) demand averaged
  over a look-back window; desired = demand / target_ongoing_requests,
  clamped to [min, max] with upscale/downscale delay smoothing

Routers (handles) long-poll `get_replicas(name, known_version)`: the
version bumps whenever the RUNNING set changes.

The controller is an actor, so it creates its replica actors from inside
its own worker (the worker's ``create_actor`` through the head). A
replica's code travels as (module, qualified name) and is imported in
the replica's worker.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field

import ray_tpu_torch
from ray_tpu_torch.serve._replica import Replica

logger = logging.getLogger("ray_tpu_torch.serve")

CONTROLLER_NAME = "SERVE_CONTROLLER"


@dataclass
class ReplicaInfo:
    replica_id: str
    actor: object
    state: str = "STARTING"  # STARTING | RUNNING | STOPPING
    last_health_ok: float = field(default_factory=time.time)
    health_ref: object = None
    started_at: float = field(default_factory=time.time)
    stop_ref: object = None
    stop_deadline: float = 0.0


@dataclass
class DeploymentState:
    name: str
    app_name: str
    cls_or_fn: tuple  # (module, qualified name): the replica imports it
    init_args: tuple
    init_kwargs: dict
    config: object  # DeploymentConfig
    replica_config: object  # ReplicaConfig
    target_replicas: int = 1
    replicas: list = field(default_factory=list)
    version: int = 0
    # autoscaling bookkeeping
    handle_metrics: dict = field(default_factory=dict)  # handle_id -> (ts, ongoing+queued)
    demand_window: deque = field(default_factory=lambda: deque(maxlen=256))
    scale_decision_since: float | None = None
    scale_decision_dir: int = 0
    last_metrics_poll: float = 0.0

    def running(self):
        return [r for r in self.replicas if r.state == "RUNNING"]


class ServeController:
    def __init__(self, http_options=None):
        self._deployments: dict[str, DeploymentState] = {}  # key = app/name
        self._apps: dict[str, dict] = {}  # app -> {"deployments": [...], "ingress": str, "route_prefix": str}
        self._lock = threading.RLock()
        self._shutdown = False
        self._http_options = http_options
        self._proxy_actor = None
        self._thread = threading.Thread(target=self._control_loop, name="serve-controller", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ deploy API

    def deploy_application(self, app_name: str, deployments: list[dict], ingress: str, route_prefix: str = "/"):
        """deployments: [{name, cls_or_fn, init_args, init_kwargs, config,
        replica_config}] (pickled payloads arrive transparently via the
        task path)."""
        with self._lock:
            new_names = {f"{app_name}/{d['name']}" for d in deployments}
            # tear down deployments removed from the app
            for key in [k for k, ds in self._deployments.items() if ds.app_name == app_name and k not in new_names]:
                self._deployments[key].target_replicas = 0
                self._deployments[key].config.num_replicas = 0
            for d in deployments:
                key = f"{app_name}/{d['name']}"
                cur = self._deployments.get(key)
                cfg = d["config"]
                if cur is None:
                    ds = DeploymentState(
                        name=d["name"],
                        app_name=app_name,
                        cls_or_fn=d["cls_or_fn"],
                        init_args=d.get("init_args", ()),
                        init_kwargs=d.get("init_kwargs", {}),
                        config=cfg,
                        replica_config=d["replica_config"],
                        target_replicas=cfg.initial_target(),
                    )
                    self._deployments[key] = ds
                else:
                    # in-place update: new code/config; restart replicas by
                    # marking all for stop (reconcile will replace them)
                    cur.cls_or_fn = d["cls_or_fn"]
                    cur.init_args = d.get("init_args", ())
                    cur.init_kwargs = d.get("init_kwargs", {})
                    cur.config = cfg
                    cur.replica_config = d["replica_config"]
                    cur.target_replicas = cfg.initial_target()
                    for r in cur.replicas:
                        if r.state != "STOPPING":
                            r.state = "STOPPING"
            self._apps[app_name] = {
                "deployments": [d["name"] for d in deployments],
                "ingress": ingress,
                "route_prefix": route_prefix,
            }
        return True

    def delete_application(self, app_name: str):
        with self._lock:
            if app_name not in self._apps:
                return False
            for key, ds in self._deployments.items():
                if ds.app_name == app_name:
                    ds.target_replicas = 0
                    ds.config.num_replicas = 0
                    if ds.config.autoscaling_config:
                        ds.config.autoscaling_config = None
            del self._apps[app_name]
            return True

    def list_applications(self):
        with self._lock:
            return dict(self._apps)

    # -------------------------------------------------------------- routing

    def get_replicas(self, app_name: str, deployment: str, known_version: int = -1):
        """Returns (version, [(replica_id, actor_handle)], max_ongoing)."""
        key = f"{app_name}/{deployment}"
        with self._lock:
            ds = self._deployments.get(key)
            if ds is None:
                return (-1, [], 0)
            return (
                ds.version,
                [(r.replica_id, r.actor) for r in ds.running()],
                ds.config.max_ongoing_requests,
            )

    def get_ingress(self, app_name: str):
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return None
            return app["ingress"]

    def record_handle_metrics(self, app_name: str, deployment: str, handle_id: str, ongoing_plus_queued: int):
        """Handles push demand (in-flight + queued) here on their refresh
        tick; the autoscaler aggregates across handles."""
        key = f"{app_name}/{deployment}"
        with self._lock:
            ds = self._deployments.get(key)
            if ds is not None:
                ds.handle_metrics[handle_id] = (time.time(), int(ongoing_plus_queued))

    # --------------------------------------------------------------- status

    def get_deployment_status(self, app_name: str, deployment: str) -> dict:
        key = f"{app_name}/{deployment}"
        with self._lock:
            ds = self._deployments.get(key)
            if ds is None:
                return {"status": "NOT_FOUND"}
            running = len(ds.running())
            status = "HEALTHY" if running >= max(ds.target_replicas, 0) and ds.target_replicas >= 0 else "UPDATING"
            if ds.target_replicas > 0 and running == 0:
                status = "UPDATING"
            return {
                "status": status,
                "target_replicas": ds.target_replicas,
                "running_replicas": running,
                "version": ds.version,
            }

    def get_app_status(self, app_name: str) -> dict:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return {"status": "NOT_FOUND", "deployments": {}}
            deps = {n: self.get_deployment_status(app_name, n) for n in app["deployments"]}
        ok = all(d["status"] == "HEALTHY" for d in deps.values())
        return {"status": "RUNNING" if ok else "DEPLOYING", "deployments": deps}

    def graceful_shutdown(self):
        with self._lock:
            self._shutdown = True
            for ds in self._deployments.values():
                for r in ds.replicas:
                    try:
                        ray_tpu_torch.kill(r.actor)
                    except Exception:
                        pass
                ds.replicas.clear()
        return True

    # ------------------------------------------------------------ reconcile

    def _control_loop(self):
        while not self._shutdown:
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("serve controller reconcile error")
            time.sleep(0.05)

    def _reconcile_once(self):
        with self._lock:
            states = list(self._deployments.items())
        for key, ds in states:
            with self._lock:
                if self._shutdown:
                    return
                self._autoscale(ds)
                self._scale_replicas(ds)
                self._check_health(ds)
            # drop fully-removed deployments
            with self._lock:
                if ds.target_replicas == 0 and not ds.replicas and ds.app_name not in self._apps:
                    self._deployments.pop(key, None)

    def _start_replica(self, ds: DeploymentState):
        rid = f"{ds.name}#{uuid.uuid4().hex[:6]}"
        opts = ds.replica_config.to_actor_options()
        # +3 slots: health checks / metrics / reconfigure must not starve
        # behind user requests filling max_ongoing_requests
        opts["max_concurrency"] = ds.config.max_ongoing_requests + 3
        actor = ray_tpu_torch.remote(Replica).options(**opts).remote(
            ds.name, rid, ds.cls_or_fn, ds.init_args, ds.init_kwargs, ds.config.user_config
        )
        info = ReplicaInfo(replica_id=rid, actor=actor)
        info.health_ref = actor.check_health.remote()
        ds.replicas.append(info)

    def _finalize_stopping(self, ds: DeploymentState):
        """Graceful drain: prepare_shutdown first, kill when it completes
        (or the graceful timeout passes)."""
        now = time.time()
        for info in [r for r in ds.replicas if r.state == "STOPPING"]:
            if info.stop_ref is None:
                try:
                    info.stop_ref = info.actor.prepare_shutdown.remote(ds.config.graceful_shutdown_timeout_s)
                except Exception:
                    info.stop_ref = None
                info.stop_deadline = now + ds.config.graceful_shutdown_timeout_s + 1.0
                ds.version += 1  # routers drop it immediately
                continue
            done, _ = ray_tpu_torch.wait([info.stop_ref], timeout=0)
            if done or now >= info.stop_deadline:
                try:
                    ray_tpu_torch.kill(info.actor, no_restart=True)
                except Exception:
                    pass
                ds.replicas.remove(info)

    def _scale_replicas(self, ds: DeploymentState):
        self._finalize_stopping(ds)
        alive = [r for r in ds.replicas if r.state in ("STARTING", "RUNNING")]
        if len(alive) < ds.target_replicas:
            for _ in range(ds.target_replicas - len(alive)):
                self._start_replica(ds)
        elif len(alive) > ds.target_replicas:
            # prefer stopping STARTING replicas, then youngest RUNNING
            excess = len(alive) - ds.target_replicas
            victims = sorted(alive, key=lambda r: (r.state == "RUNNING", r.started_at))
            for info in victims[:excess]:
                info.state = "STOPPING"

    def _check_health(self, ds: DeploymentState):
        now = time.time()
        for info in list(ds.replicas):
            if info.state == "STOPPING":
                continue
            if info.health_ref is not None:
                ready, _ = ray_tpu_torch.wait([info.health_ref], timeout=0)
                if ready:
                    try:
                        ray_tpu_torch.get(info.health_ref)
                        info.last_health_ok = now
                        if info.state == "STARTING":
                            info.state = "RUNNING"
                            ds.version += 1
                    except Exception:
                        logger.warning("replica %s failed health check; replacing", info.replica_id)
                        info.state = "STOPPING"
                    info.health_ref = None
            elif now - info.last_health_ok > ds.config.health_check_period_s:
                info.health_ref = info.actor.check_health.remote()
            if now - info.last_health_ok > ds.config.health_check_timeout_s:
                logger.warning("replica %s health check timed out; replacing", info.replica_id)
                info.state = "STOPPING"

    # ------------------------------------------------------------ autoscale

    def _autoscale(self, ds: DeploymentState):
        cfg = ds.config.autoscaling_config
        if cfg is None:
            ds.target_replicas = 0 if ds.config.num_replicas == 0 else (ds.config.num_replicas or 1)
            return
        now = time.time()
        if now - ds.last_metrics_poll < cfg.metrics_interval_s:
            return
        ds.last_metrics_poll = now
        # total demand = handle-reported in-flight + queued (stale handles expire)
        fresh = {h: v for h, (ts, v) in ds.handle_metrics.items() if now - ts < 4 * cfg.metrics_interval_s + 1.0}
        demand = sum(fresh.values())
        ds.handle_metrics = {h: (ts, v) for h, (ts, v) in ds.handle_metrics.items() if h in fresh}
        ds.demand_window.append((now, demand))
        window = [v for (ts, v) in ds.demand_window if now - ts <= cfg.look_back_period_s]
        avg_demand = sum(window) / max(len(window), 1)

        cur = ds.target_replicas
        desired = math.ceil(avg_demand / max(cfg.target_ongoing_requests, 1e-6) - 1e-9)
        if desired > cur:
            desired = cur + max(1, math.ceil((desired - cur) * cfg.upscaling_factor))
        elif desired < cur:
            desired = cur - max(1, math.ceil((cur - desired) * cfg.downscaling_factor))
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))

        direction = (desired > cur) - (desired < cur)
        if direction == 0:
            ds.scale_decision_since = None
            ds.scale_decision_dir = 0
            return
        if ds.scale_decision_dir != direction:
            ds.scale_decision_dir = direction
            ds.scale_decision_since = now
        delay = cfg.upscale_delay_s if direction > 0 else cfg.downscale_delay_s
        if now - (ds.scale_decision_since or now) >= delay:
            ds.target_replicas = desired
            ds.scale_decision_since = None
            ds.scale_decision_dir = 0
