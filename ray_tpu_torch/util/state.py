"""The state API and the session's files (port of ray_tpu/util/state.py):
lists and summaries read from the head's live tables, and the JSON files
a process outside the cluster reads.

``cluster_info.json`` carries the join credentials (the agent listener's
address and the authkeys, 0600): ``rt agent`` joins with it and
``init(address="auto")`` attaches with it. ``state.json`` is a snapshot of
the cluster for the CLI (``scripts/cli.py``). Both live in the session's
directory, ``util/tracing.session_dir()`` (under the temporary directory,
``ray_tpu_torch/session_<head pid>``), the one directory of a session the
port writes: flight dumps, spill files and job logs go there too.
"""

from __future__ import annotations

import collections
import json
import os
import time

from ray_tpu_torch.util.tracing import session_dir

__all__ = [
    "cluster_status", "dump_cluster_info", "dump_state", "list_actors", "list_nodes", "list_objects",
    "list_placement_groups", "list_tasks", "load_latest_cluster_info", "load_latest_state", "session_dir",
    "sessions_root", "summarize_actors", "summarize_tasks",
]


def _client():
    from ray_tpu_torch.core import context

    return context.get_client()


def list_nodes() -> list[dict]:
    return _client().cluster_info("nodes")


def list_actors() -> list[dict]:
    return _client().cluster_info("actors")


def list_tasks() -> list[dict]:
    return _client().cluster_info("tasks")


def list_objects() -> dict:
    return _client().cluster_info("objects")


def list_placement_groups() -> list[dict]:
    return _client().cluster_info("placement_groups")


def summarize_tasks() -> dict:
    """Counts by (name, state)."""
    by_state: dict = collections.defaultdict(lambda: collections.defaultdict(int))
    for t in list_tasks():
        by_state[t.get("name", "?")][t.get("status", t.get("state", "?"))] += 1
    return {name: dict(states) for name, states in by_state.items()}


def summarize_actors() -> dict:
    by_state: dict = collections.defaultdict(int)
    for a in list_actors():
        by_state[a.get("state", "?")] += 1
    return dict(by_state)


def cluster_status(client=None) -> dict:
    """The nodes, the cluster's total and available resources, the demand
    the scheduler holds, the actors by state and the lifetime task counts
    (never pruned: the dashboard's throughput reads them)."""
    c = client or _client()
    actors = collections.defaultdict(int)
    for a in c.cluster_info("actors"):
        actors[a.get("state", "?")] += 1
    return {
        "nodes": c.cluster_info("nodes"),
        "cluster_resources": c.cluster_info("cluster_resources"),
        "available_resources": c.cluster_info("available_resources"),
        "pending_demand": c.scheduler.pending_demand() if hasattr(c, "scheduler") else [],
        "actors": dict(actors),
        "task_counts": c.task_manager.lifetime_counts() if hasattr(c, "task_manager") else {},
    }


# ----------------------------------------------------------------------
# the session's files
# ----------------------------------------------------------------------
def sessions_root() -> str:
    """The directory that holds every session's directory on this host."""
    return os.path.dirname(session_dir())


def _write_json(path: str, obj, mode: int = 0o644):
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, default=str)
    os.replace(tmp, path)


def dump_state(client=None) -> str:
    """Write the cluster's snapshot for the CLI; returns its path."""
    c = client or _client()
    d = session_dir()
    os.makedirs(d, exist_ok=True)
    tasks: dict = collections.defaultdict(lambda: collections.defaultdict(int))
    for t in c.cluster_info("tasks"):
        tasks[t.get("name", "?")][t.get("status", "?")] += 1
    snap = {
        "ts": time.time(),
        "pid": os.getpid(),
        "status": cluster_status(c),
        "tasks": {k: dict(v) for k, v in tasks.items()},
        "actors_list": c.cluster_info("actors"),
        "placement_groups": c.cluster_info("placement_groups"),
        "objects": c.cluster_info("objects"),
    }
    path = os.path.join(d, "state.json")
    _write_json(path, snap)
    return path


def dump_cluster_info(client) -> str:
    """Write the join credentials (the agent listener's address and the
    authkeys) for ``rt agent`` and ``init(address=...)``: ray_tpu's keys,
    in a file created 0600 (the authkeys admit to the cluster)."""
    d = session_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "cluster_info.json")
    info = {
        "ts": time.time(),
        "pid": os.getpid(),
        "agent_address": list(client._agent_listener.address),
        "authkey": client._agent_listener.authkey.hex(),
        "transfer_authkey": client._transfer_authkey.hex(),
    }
    _write_json(path, info, mode=0o600)
    return path


def _newest(filename: str) -> list[str]:
    """Every session's ``filename``, the newest first."""
    root = sessions_root()
    try:
        sessions = os.listdir(root)
    except FileNotFoundError:
        return []
    found = []
    for s in sessions:
        p = os.path.join(root, s, filename)
        try:
            found.append((os.path.getmtime(p), p))
        except OSError:
            continue
    return [p for _, p in sorted(found, reverse=True)]


def load_latest_cluster_info() -> dict | None:
    """The newest ``cluster_info.json`` of a head that still runs."""
    for path in _newest("cluster_info.json"):
        try:
            with open(path) as f:
                info = json.load(f)
            os.kill(info["pid"], 0)
        except (OSError, ValueError, KeyError):
            continue  # its head is gone, or the file is being replaced
        return info
    return None


def load_latest_state() -> dict | None:
    """The newest ``state.json`` (the CLI's entry)."""
    paths = _newest("state.json")
    if not paths:
        return None
    with open(paths[0]) as f:
        return json.load(f)
