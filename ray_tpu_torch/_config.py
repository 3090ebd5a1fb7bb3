"""Runtime flags (port of ray_tpu/_config.py's runtime part: the object
plane, the head's store, the node agents and their health checks, the
GCS's persistence, the monitors, the scheduler, the worker pool, retries
and lineage).

Each flag keeps ray_tpu's name and default and is overridable through the
same ``RT_<NAME>`` environment variable, read when the config is first
built (``get_config``), and through ``init(_system_config={...})``
(``update``); ``reset_config`` drops it so the next read sees the
environment again. The serving engine's flags live on ``LLMEngine``'s
arguments, as in the port's engine. The data library's flag,
``target_max_block_size``, is read by ``data/executor.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RT_"


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(_ENV_PREFIX + name.upper())
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclass
class Config:
    """The runtime's flags (one instance per process)."""

    # --- object store ---
    # values serialized above this size go to shared memory; below it they
    # stay inline in the owner's store and ride the reply frame (reference:
    # max_direct_call_object_size, common/ray_config_def.h:198)
    max_direct_call_object_size: int = 100 * 1024
    # the head store's shared-memory capacity
    object_store_memory: int = 2 * 1024 * 1024 * 1024
    # share of the capacity above which cold, unpinned objects are spilled
    # (or evicted, for lineage to rebuild)
    object_store_eviction_threshold: float = 0.8
    # spill cold sealed objects to disk instead of evicting them; restore on read
    object_spilling_enabled: bool = True
    # directory of spill files; empty: <session_dir>/spill
    object_spill_dir: str = ""
    # disk budget for spilled bytes; past it cold objects are evicted
    object_spill_max_bytes: int = 50 * 1024 * 1024 * 1024


    # --- across processes: node agents and the transfer servers ---
    # the bind host of the head's agent listener and its transfer server
    # (0.0.0.0 admits `rt agent` joins from other hosts)
    node_manager_host: str = "127.0.0.1"
    # give every added node a shm namespace of its own, so each object that
    # crosses a node's boundary moves through the transfer servers
    shm_isolation: bool = False
    # the agent listener's port (0: any free one); a fixed port lets agents
    # redial a restarted head
    node_manager_port: int = 0
    # seconds an agent redials a lost head (0: it goes with the head)
    agent_reconnect_s: float = 0.0

    # --- the GCS's persistence ---
    # the append-only log of the GCS's tables (empty: in memory only): the
    # KV, the job table and the detached actors outlive a kill -9 of the
    # head, and the next head on the log re-creates the actors
    gcs_persist_path: str = ""

    # --- scheduler ---
    # pack onto the busiest feasible node until its utilization crosses
    # this threshold, then spread (reference: scheduler_spread_threshold)
    scheduler_spread_threshold: float = 0.5
    # task retries on a worker's death when the task does not say
    default_max_retries: int = 3

    # --- worker pool ---
    # "forkserver": the port's own zygote process forks the workers
    # (core/node.py); "spawn": a fresh interpreter per worker; "fork": the
    # driver forks them (refused once the driver holds a CUDA context)
    worker_start_method: str = "forkserver"
    prestart_workers: bool = True

    # --- health ---
    # the head pings node agents every period; a node whose agent answered
    # none in threshold periods is dead
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5
    # period of the session's state.json for the CLI (util/state.py); 0: off
    state_dump_interval_s: float = 2.0

    # --- monitors ---
    # stream the workers' log files (<session>/logs/worker-*.log) to the
    # driver's stderr, each line prefixed "(worker=<id>)" (core/log_monitor.py)
    log_to_driver: bool = True
    # period of the memory monitor's sample (core/memory_monitor.py); 0: off
    memory_monitor_refresh_ms: int = 250
    # the share of the host's memory in use (cgroup v2's limit where tighter)
    # above which the largest retriable worker is killed
    memory_usage_threshold: float = 0.95

    # --- reference counting ---
    # free owned entries once no process holds a ref; the borrow protocol
    # rides it (RT_OBJECT_REF_COUNTING=0 turns the owned plane off)
    object_ref_counting: bool = True
    # period of the housekeeping pass: drain the local ref-count
    # transitions, route them to their owners, free what is due
    ref_counting_interval_s: float = 0.2

    # --- direct call plane (core/direct.py) ---
    # the direct plane itself (RT_DIRECT_CALLS=0 routes everything through the head)
    direct_calls: bool = True
    # seconds an owned object lingers after its last reference drops
    # (absorbs the async borrow-registration race)
    owned_object_grace_s: float = 1.0
    # entries whose ref was serialized out of this process but never saw a
    # registered borrow wait this much longer instead: the owner waits for
    # the explicit borrow-release, and the timer is only the leak backstop
    # for borrowers that died before registering
    owned_object_leak_backstop_s: float = 30.0

    # --- lineage ---
    # terminal task specs beyond this count are pruned (their outputs can
    # no longer be rebuilt)
    max_lineage_tasks: int = 20_000

    # --- data ---
    # blocks observed above this size are split into ~this-sized chunks
    # between pipeline stages (reference: DataContext.target_max_block_size
    # and the executor's dynamic block splitting); 0 disables
    target_max_block_size: int = 128 * 1024 * 1024

    # --- collective ---
    # how long a rank waits in a collective round for the other ranks
    collective_timeout_s: float = 120.0

    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        for f in fields(self):
            if f.name == "extra":
                continue
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def update(self, overrides: dict | None):
        if not overrides:
            return
        known = {f.name for f in fields(self)}
        for k, v in overrides.items():
            if k in known:
                setattr(self, k, v)
            else:
                self.extra[k] = v


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config():
    global _config
    _config = None
