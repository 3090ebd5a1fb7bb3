"""The autoscaler (port of ray_tpu/autoscaler/autoscaler.py): cluster
membership reconciled against demand.

A ``NodeProvider`` is the cloud. ``LocalNodeProvider`` starts node-agent
processes on this host (``Runtime.add_node``); ``CommandNodeProvider``
runs an operator's shell line that starts an ``rt agent`` somewhere, which
joins the head over TCP.

One reconcile pass:
1. read the demand: the requests of queued tasks not placed yet, parked
   ones included (``Scheduler.pending_demand``), pending placement groups
   (``Runtime.pending_pg_demand``) and each type's ``min_workers``;
2. bin-pack the demand onto the live nodes' headroom and the launches in
   flight; what does not fit launches the first node type that holds it,
   up to ``max_workers``, on threads of their own;
3. terminate launched nodes idle (no busy worker, no placement-group
   bundle, an empty dispatch queue) for ``idle_timeout_s``.

**The card as "GPU".** ``"TPU"`` in a node type's resources or in a
request folds into ``"GPU"`` (``accelerators/gpu.py::fold_card``), so a
launch command's ``{num_gpus}`` and ``{num_tpus}`` give the same count.

``status()`` renders the ``rt status``-shaped summary.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from ray_tpu_torch.accelerators.gpu import fold_card

logger = logging.getLogger(__name__)


@dataclass
class NodeTypeConfig:
    name: str
    resources: dict
    min_workers: int = 0
    max_workers: int = 10
    labels: dict = field(default_factory=dict)

    def __post_init__(self):
        self.resources = fold_card(self.resources)


class NodeProvider:
    """The cloud: creates and terminates nodes of a type."""

    def create_node(self, node_type: NodeTypeConfig):
        raise NotImplementedError

    def terminate_node(self, node):
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Launch node-agent processes on this host."""

    def __init__(self, runtime):
        self.rt = runtime

    def create_node(self, node_type: NodeTypeConfig):
        return self.rt.add_node(
            dict(node_type.resources),
            labels={**node_type.labels, "ray_tpu.io/node-type": node_type.name},
        )

    def terminate_node(self, node):
        self.rt.remove_node(node.node_id, graceful=True)


class CommandNodeProvider(NodeProvider):
    """Launch nodes by running a shell command that starts an ``rt agent``
    somewhere: ssh to another machine, a cloud CLI creating a VM whose
    startup script joins, or a local subprocess.

    ``launch_command`` is a format string receiving {address} {authkey}
    {transfer_authkey} {num_cpus} {num_gpus} {num_tpus} {node_type}
    {join_token}; the started agent dials the head's AgentListener, and
    ``create_node`` returns once the joined node appears (or raises on
    timeout)."""

    JOIN_TIMEOUT_S = 120.0

    def __init__(self, runtime, launch_command: str, terminate_command: str | None = None):
        self.rt = runtime
        self.launch_command = launch_command
        self.terminate_command = terminate_command
        self._procs: dict = {}  # node_id -> subprocess handle

    def _known_joined(self) -> set:
        return {n.node_id for n in self.rt.node_list() if n.labels.get("ray_tpu.io/node-type") == "joined"}

    def create_node(self, node_type: NodeTypeConfig):
        import subprocess
        import uuid

        host, port = self.rt._agent_listener.address
        # include "--join-token {join_token}" in launch_command for EXACT
        # launch<->node matching; without it, adoption falls back to a
        # capacity check (a concurrent operator-run join could be claimed)
        token = uuid.uuid4().hex[:12]
        use_token = "{join_token}" in self.launch_command
        cmd = self.launch_command.format(
            address=f"{host}:{port}",
            authkey=self.rt._agent_listener.authkey.hex(),
            transfer_authkey=self.rt._transfer_authkey.hex(),
            num_cpus=node_type.resources.get("CPU", 1),
            num_gpus=node_type.resources.get("GPU", 0),
            num_tpus=node_type.resources.get("GPU", 0),
            node_type=node_type.name,
            join_token=token,
        )
        before = self._known_joined()
        proc = subprocess.Popen(cmd, shell=True)  # operator-authored shell line (ssh, pipes, ...)
        deadline = time.monotonic() + self.JOIN_TIMEOUT_S
        want = node_type.resources
        while time.monotonic() < deadline:
            for node_id in self._known_joined() - before:
                with self.rt._nodes_lock:
                    node = self.rt.nodes.get(node_id)
                if node is None:
                    continue  # joined and died in the window
                if use_token:
                    if node.labels.get("ray_tpu.io/join-token") != token:
                        continue
                elif any(node.total_resources.get(k, 0) < v for k, v in want.items() if v > 0):
                    continue
                node.labels["ray_tpu.io/node-type"] = node_type.name
                self._procs[node_id] = proc
                return node
            if proc.poll() is not None and proc.returncode != 0:
                raise RuntimeError(f"launch command exited {proc.returncode}: {cmd}")
            time.sleep(0.25)
        proc.terminate()
        raise TimeoutError(f"node from {node_type.name!r} never joined within {self.JOIN_TIMEOUT_S}s")

    def terminate_node(self, node):
        import subprocess

        node_type = node.labels.get("ray_tpu.io/node-type", "")
        self.rt.remove_node(node.node_id, graceful=True)
        proc = self._procs.pop(node.node_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
        if self.terminate_command:

            class _Safe(dict):
                def __missing__(self, key):  # unknown placeholder: keep literal
                    return "{" + key + "}"

            cmd = self.terminate_command.format_map(
                _Safe(node_id=node.node_id.hex(), node_type=node_type)
            )
            try:
                subprocess.Popen(cmd, shell=True)
            except OSError as e:
                logger.warning("terminate command failed to start: %s (%s)", cmd, e)


def _fits(avail: dict, req: dict) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in req.items() if v > 0)


def _take(avail: dict, req: dict):
    for k, v in req.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) - v


class Autoscaler:
    def __init__(
        self,
        runtime,
        node_types: list[NodeTypeConfig],
        *,
        provider: NodeProvider | None = None,
        idle_timeout_s: float = 60.0,
        interval_s: float = 1.0,
        upscaling_speed: int = 4,
    ):
        self.rt = runtime
        self.node_types = {t.name: t for t in node_types}
        self.provider = provider or LocalNodeProvider(runtime)
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        self.upscaling_speed = max(1, upscaling_speed)
        self._managed: dict = {}  # node_id -> (type_name, launched_at)
        self._idle_since: dict = {}  # node_id -> ts
        self._launching: dict = {}  # type_name -> in-flight launch count
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- lifecycle --
    def adopt(self, node, type_name: str):
        """Register an externally-launched node as managed (the launcher's
        min_workers floor) so reconcile counts it toward the type's floor
        instead of double-launching."""
        with self._lock:
            self._managed[node.node_id] = (type_name, time.monotonic())

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="rt-autoscaler")
        self._thread.start()
        return self

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self):
        while not self._stopped.wait(self.interval_s):
            try:
                self.reconcile()
            except Exception:
                logger.exception("autoscaler reconcile failed")

    # -- one reconcile pass --
    def reconcile(self):
        with self._lock:
            nodes = self.rt.node_list()
            alive_ids = {n.node_id for n in nodes}
            self._managed = {nid: v for nid, v in self._managed.items() if nid in alive_ids}

            counts: dict[str, int] = {t: 0 for t in self.node_types}
            for nid, (tname, _) in self._managed.items():
                counts[tname] = counts.get(tname, 0) + 1
            # launches dispatched to threads but not yet joined count too,
            # or every reconcile tick would double-launch a slow provider
            for tname, n in self._launching.items():
                counts[tname] = counts.get(tname, 0) + n

            # demand = queued tasks + pending placement groups + floors
            demand = [fold_card(r) for r in self.rt.scheduler.pending_demand() + self.rt.pending_pg_demand()]
            headroom = [dict(n.available) for n in nodes]
            launches: list[NodeTypeConfig] = []
            # capacity already being launched counts as planned headroom:
            # demand that an in-flight (async) launch will satisfy must
            # not provision AGAIN on the next reconcile tick
            planned: list[dict] = [
                dict(self.node_types[tname].resources)
                for tname, n in self._launching.items()
                if tname in self.node_types
                for _ in range(n)
            ]

            def try_place(req: dict) -> bool:
                for h in headroom + planned:
                    if _fits(h, req):
                        _take(h, req)
                        return True
                return False

            for req in demand:
                if not req or try_place(req):
                    continue
                t = self._pick_type(req, counts)
                if t is None:
                    continue  # infeasible on every configured type (or maxed)
                counts[t.name] += 1
                launches.append(t)
                h = dict(t.resources)
                _take(h, req)
                planned.append(h)

            for t in self.node_types.values():
                while counts.get(t.name, 0) < t.min_workers:
                    counts[t.name] += 1
                    launches.append(t)
                    planned.append(dict(t.resources))

            to_launch = launches[: self.upscaling_speed]

        # launch on detached threads: a cloud provider can take minutes per
        # node (a VM's boot), and one slow create must not stall other
        # scaling decisions, idle teardown or the reconcile loop itself
        def _launch(t: NodeTypeConfig):
            node = None
            try:
                node = self.provider.create_node(t)
            except Exception as e:  # noqa: BLE001
                logger.warning("autoscaler launch of %s failed: %s", t.name, e)
            # one lock section: the in-flight count converts to a managed
            # entry atomically, so no reconcile pass sees neither
            with self._lock:
                self._launching[t.name] = max(0, self._launching.get(t.name, 0) - 1)
                if node is not None:
                    self._managed[node.node_id] = (t.name, time.monotonic())
            if node is not None:
                logger.info("autoscaler launched node %s type=%s", node.node_id.hex()[:8], t.name)

        for t in to_launch:
            if self._stopped.is_set():
                return
            with self._lock:
                self._launching[t.name] = self._launching.get(t.name, 0) + 1
            threading.Thread(target=_launch, args=(t,), daemon=True, name="rt-launch").start()

        with self._lock:
            nodes = self.rt.node_list()
            # scale-down: managed nodes idle past the timeout, above min
            now = time.monotonic()
            for n in nodes:
                entry = self._managed.get(n.node_id)
                if entry is None:
                    continue
                tname, _ = entry
                # a worker leased to a direct caller runs its tasks: busy
                # (ray_tpu counts it idle)
                busy = (any(w.state in ("busy", "actor", "starting", "leased") for w in n.workers.values())
                        or bool(n.pg_bundles) or bool(n.dispatch_queue))
                if busy:
                    self._idle_since.pop(n.node_id, None)
                    continue
                first_idle = self._idle_since.setdefault(n.node_id, now)
                if now - first_idle >= self.idle_timeout_s and counts.get(tname, 0) > self.node_types[tname].min_workers:
                    counts[tname] -= 1
                    self._managed.pop(n.node_id, None)
                    self._idle_since.pop(n.node_id, None)
                    logger.info("autoscaler terminating idle node %s", n.node_id.hex()[:8])
                    self.provider.terminate_node(n)

    def _pick_type(self, req: dict, counts: dict) -> NodeTypeConfig | None:
        for t in self.node_types.values():
            if counts.get(t.name, 0) >= t.max_workers:
                continue
            if _fits(t.resources, req):
                return t
        return None

    # -- observability --
    def status(self) -> dict:
        with self._lock:
            nodes = self.rt.node_list()
            return {
                "nodes": [
                    {
                        "node_id": n.node_id.hex(),
                        "type": self._managed.get(n.node_id, ("head/static",))[0],
                        "resources": dict(n.total_resources),
                        "available": dict(n.available),
                    }
                    for n in nodes
                ],
                "pending_demand": self.rt.scheduler.pending_demand(),
                "managed_count": len(self._managed),
            }
