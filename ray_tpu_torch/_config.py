"""Runtime flags of the owned-object plane (port of the part of
ray_tpu/_config.py that ``core/`` reads).

Each flag keeps ray_tpu's name and default and is overridable through the
same ``RT_<NAME>`` environment variable, read when the config is first
built (``get_config``); ``reset_config`` drops it so the next read sees
the environment again. The runtime's other flags (object store memory,
spilling, the scheduler, workers, health checks, ...) wait for the runtime
(ROADMAP.md, queue 1, the runtime).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
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
    """The owned path's flags (one instance per process)."""

    # values serialized above this size go to shared memory; below it they
    # stay inline in the owner's store and ride the reply frame (reference:
    # max_direct_call_object_size, common/ray_config_def.h:198)
    max_direct_call_object_size: int = 100 * 1024
    # free owned entries once no process holds a ref; the borrow protocol
    # rides it (RT_OBJECT_REF_COUNTING=0 turns the owned plane off)
    object_ref_counting: bool = True
    # period of the housekeeping pass: drain the local ref-count
    # transitions, route them to their owners, free what is due
    ref_counting_interval_s: float = 0.2
    # the direct plane itself (RT_DIRECT_CALLS=0 turns it off)
    direct_calls: bool = True
    # seconds an owned object lingers after its last reference drops
    # (absorbs the async borrow-registration race)
    owned_object_grace_s: float = 1.0
    # entries whose ref was serialized out of this process but never saw a
    # registered borrow wait this much longer instead: the owner waits for
    # the explicit borrow-release, and the timer is only the leak backstop
    # for borrowers that died before registering
    owned_object_leak_backstop_s: float = 30.0

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config():
    global _config
    _config = None
