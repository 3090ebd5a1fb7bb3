"""Usage stats: a local, opt-in record (port of ray_tpu/util/usage.py).

Collection is opt-in through ``RT_USAGE_STATS_ENABLED=1`` and the report
never leaves the machine: ``usage_stats.json`` lands in the session
directory (``util/tracing.session_dir()``) for operators who want a
machine-readable record of what ran (versions, cluster shape, which
libraries were imported). There is no code path that sends it anywhere.
The libraries' ``__init__`` modules mark themselves used
(``record_library_usage``), as ray_tpu's do.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time

SCHEMA_VERSION = "0.1"
VERSION = "0.1.0"  # ray_tpu's __version__: the port follows its API

_lock = threading.Lock()
_library_usages: set[str] = set()
_extra_tags: dict[str, str] = {}
_session_start_ms = int(time.time() * 1000)


def usage_stats_enabled() -> bool:
    """Disabled unless RT_USAGE_STATS_ENABLED=1: there is no prompt flow,
    and silent collection is the wrong default for a library."""
    return os.environ.get("RT_USAGE_STATS_ENABLED", "0") == "1"


def record_library_usage(library: str):
    """Mark a library as used this session (called from library __init__s)."""
    with _lock:
        _library_usages.add(str(library))


def record_extra_usage_tag(key: str, value: str):
    """Attach a custom key=value to the report."""
    with _lock:
        _extra_tags[str(key)] = str(value)


def _cluster_shape(client) -> dict:
    try:
        total = client.cluster_info("cluster_resources")
        nodes = client.cluster_info("nodes")
    except Exception:
        return {}
    return {
        "total_num_cpus": total.get("CPU"),
        "total_num_gpus": total.get("GPU"),
        "total_memory_gb": round(total.get("memory", 0) / (1 << 30), 2) or None,
        "total_num_nodes": len(nodes),
    }


def generate_report_data(client=None) -> dict:
    """The report dict: the locally meaningful subset of the reference's
    usage schema."""
    with _lock:
        libs = sorted(_library_usages)
        tags = dict(_extra_tags)
    data = {
        "schema_version": SCHEMA_VERSION,
        "source": "LOCAL",  # never reported anywhere
        "collect_timestamp_ms": int(time.time() * 1000),
        "session_start_timestamp_ms": _session_start_ms,
        "ray_tpu_version": VERSION,
        "python_version": platform.python_version(),
        "os": sys.platform,
        "library_usages": libs,
        "extra_usage_tags": tags,
    }
    if client is not None:
        data.update(_cluster_shape(client))
    return data


def write_usage_stats(client=None, path: str | None = None) -> str | None:
    """Write usage_stats.json into the session dir; a no-op unless enabled."""
    if not usage_stats_enabled():
        return None
    from ray_tpu_torch.util.tracing import session_dir

    out = path or os.path.join(session_dir(), "usage_stats.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(generate_report_data(client), f, indent=1)
    os.replace(tmp, out)
    return out
