"""The cluster launcher (port of ray_tpu/autoscaler/launcher.py): ``rt up
<config>`` and ``rt down``.

A configuration is JSON (read with the standard library) or YAML (``yaml``
is imported on that path only; without ``pyyaml`` it raises ImportError
naming it):

    {"cluster_name": "demo",
     "head": {"num_cpus": 4,            # the head node's CPUs
              "node_manager_port": 0,   # a fixed port lets agents redial
              "gcs_persist_path": ""},  # non-empty: the head's tables survive it
     "provider": {"type": "command",    # or "local"
                  "launch_command": "ssh {node_type}-pool 'python -m ray_tpu_torch.scripts.cli agent
                      --address {address} --authkey {authkey} --transfer-authkey {transfer_authkey}
                      --num-cpus {num_cpus} --num-gpus {num_gpus}'"},
     "available_node_types": {"gpu_worker": {"resources": {"CPU": 8, "GPU": 1},
                                             "min_workers": 0, "max_workers": 4}}}

``up()`` starts the head runtime in this process, brings up each type's
``min_workers`` and runs the autoscaler until SIGTERM or Ctrl-C. ``rt up``
runs it in the foreground and records a pidfile (``cluster.pid`` in the
session's directory) that ``rt down`` signals.
"""

from __future__ import annotations

import os
import signal
import time

from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    CommandNodeProvider,
    LocalNodeProvider,
    NodeTypeConfig,
)


def load_config(path: str) -> dict:
    """A cluster configuration from ``path``: JSON when it ends in .json,
    else YAML."""
    import json

    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the YAML configuration {path} needs pyyaml, which is not installed; "
                          f"give the configuration as .json instead") from e
    return yaml.safe_load(text)


def _node_types(cfg: dict) -> list[NodeTypeConfig]:
    out = []
    for name, spec in (cfg.get("available_node_types") or {}).items():
        out.append(
            NodeTypeConfig(
                name=name,
                resources=dict(spec.get("resources") or {"CPU": 1}),
                min_workers=int(spec.get("min_workers", 0)),
                max_workers=int(spec.get("max_workers", 10)),
                labels=dict(spec.get("labels") or {}),
            )
        )
    return out


def _provider(cfg: dict, runtime):
    p = cfg.get("provider") or {"type": "local"}
    kind = p.get("type", "local")
    if kind == "local":
        return LocalNodeProvider(runtime)
    if kind == "command":
        return CommandNodeProvider(runtime, p["launch_command"], p.get("terminate_command"))
    raise ValueError(f"unknown provider type {kind!r} (local | command)")


class Cluster:
    """A launched cluster: the head runtime, the provider and the autoscaler."""

    def __init__(self, config: dict):
        import ray_tpu_torch
        from ray_tpu_torch.core import context

        self.config = config
        head = config.get("head") or {}
        system_config = {}
        if head.get("node_manager_port"):
            system_config["node_manager_port"] = int(head["node_manager_port"])
        if head.get("gcs_persist_path"):
            system_config["gcs_persist_path"] = head["gcs_persist_path"]
        if head.get("node_manager_host"):
            # agents on other hosts dial a routable address, not loopback
            system_config["node_manager_host"] = head["node_manager_host"]
        ray_tpu_torch.init(num_cpus=int(head.get("num_cpus", os.cpu_count() or 4)),
                           _system_config=system_config or None)
        self.runtime = context.get_client()
        self.node_types = _node_types(config)
        self.provider = _provider(config, self.runtime)
        self.autoscaler = Autoscaler(self.runtime, self.node_types, provider=self.provider)
        # the floor first, each node adopted, so reconcile counts it toward
        # min_workers instead of launching the floor a second time
        for nt in self.node_types:
            for _ in range(nt.min_workers):
                self.autoscaler.adopt(self.provider.create_node(nt), nt.name)
        self.autoscaler.start()

    def wait(self):
        """Block until SIGTERM/SIGINT (the `rt up` foreground loop)."""
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        try:
            while not stop:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass

    def shutdown(self):
        import ray_tpu_torch

        self.autoscaler.stop()
        ray_tpu_torch.shutdown()


def up(config_path: str, block: bool = True) -> Cluster:
    """Launch the cluster of ``config_path`` and record this process in the
    session's pidfile; ``block``: serve until SIGTERM or Ctrl-C, then shut
    it down."""
    from ray_tpu_torch.util.tracing import session_dir

    cluster = Cluster(load_config(config_path))
    os.makedirs(session_dir(), exist_ok=True)
    with open(os.path.join(session_dir(), "cluster.pid"), "w") as f:
        f.write(str(os.getpid()))
    if block:
        try:
            cluster.wait()
        finally:
            cluster.shutdown()
    return cluster


def down() -> bool:
    """Stop the newest live ``rt up`` head (SIGTERM through its pidfile).
    Dead pidfiles are removed and skipped; a recycled pid is rejected by a
    /proc cmdline check (the process must still be a python head)."""
    from ray_tpu_torch.util.tracing import session_dir

    root = os.path.dirname(session_dir())
    candidates = []
    try:
        sessions = os.listdir(root)
    except FileNotFoundError:
        return False
    for s in sessions:
        p = os.path.join(root, s, "cluster.pid")
        try:
            ts = os.path.getmtime(p)
        except OSError:
            continue
        candidates.append((ts, p))
    for _, p in sorted(candidates, reverse=True):
        try:
            with open(p) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            continue
        # the pid must own the session (its directory is named after the
        # head's pid), be alive and still be a python process
        if f"session_{pid}" not in p:
            continue
        alive = True
        try:
            os.kill(pid, 0)
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
            if b"python" not in cmdline and b"rt" not in cmdline:
                alive = False
        except (ProcessLookupError, PermissionError, OSError):
            alive = False
        if not alive:
            try:
                os.unlink(p)  # stale: clean up so it can't shadow anything
            except OSError:
                pass
            continue
        os.kill(pid, signal.SIGTERM)
        return True
    return False
