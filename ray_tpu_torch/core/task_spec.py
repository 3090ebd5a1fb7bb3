"""A serialized value in transit (port of ``Payload`` from
ray_tpu/core/task_spec.py). The task and actor specifications and
``ArgSpec`` wait for the runtime (ROADMAP.md, queue 1, the runtime)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ray_tpu_torch.core.object_store import ShmDescriptor
from ray_tpu_torch.core.serialization import Serialized


@dataclass
class Payload:
    """Inline bytes or an shm locator. ``contained``: the ObjectIDs of any
    ObjectRefs pickled inside the value (the borrow protocol's pins)."""

    inline: Serialized | None = None
    shm: ShmDescriptor | None = None
    contained: list = field(default_factory=list)
