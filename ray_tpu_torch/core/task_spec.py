"""Task and actor specifications and the argument payloads (port of
ray_tpu/core/task_spec.py): ``Payload`` (a serialized value in transit),
``ArgSpec`` (an argument by value or by reference), ``SchedulingOptions``,
``TaskSpec`` and the actor table's ``ActorInfo``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core.ids import ActorID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.object_store import ShmDescriptor
from ray_tpu_torch.core.serialization import Serialized


@dataclass
class Payload:
    """Inline bytes or an shm locator. ``contained``: the ObjectIDs of any
    ObjectRefs pickled inside the value (the borrow protocol's pins)."""

    inline: Serialized | None = None
    shm: ShmDescriptor | None = None
    contained: list = field(default_factory=list)


@dataclass
class ArgSpec:
    """One task argument: a payload (by value) or an object ref (by
    reference, resolved by the head before dispatch, or fetched by the
    executing worker). ``owner`` is the owner address of an object owned on
    the direct plane: the worker pulls it from its owner, not the head."""

    payload: Payload | None = None
    ref: ObjectID | None = None
    owner: str | None = None


@dataclass
class SchedulingOptions:
    resources: dict[str, float] = field(default_factory=dict)
    node_id: str | None = None  # hard node affinity
    soft_node_id: str | None = None  # locality preference
    placement_group: PlacementGroupID | None = None
    bundle_index: int = -1
    scheduling_strategy: str = "DEFAULT"  # DEFAULT | SPREAD
    label_selector: dict[str, str] = field(default_factory=dict)


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    func_id: str  # the hash of the function's reference (module and qualified name)
    args: list[ArgSpec]
    num_returns: int = 1
    streaming: bool = False  # num_returns="streaming"
    scheduling: SchedulingOptions = field(default_factory=SchedulingOptions)
    max_retries: int = 0
    retry_exceptions: bool | list | None = False
    runtime_env: dict | None = None
    # actor fields
    actor_id: ActorID | None = None
    is_actor_creation: bool = False
    method_name: str | None = None
    seq_no: int = -1
    # actor creation fields
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_async_actor: bool = False
    # bookkeeping
    attempt: int = 0
    submitter: str = "driver"
    # tracing: (trace_id, parent_span_id) from the submitting side
    trace_ctx: tuple | None = None

    def return_ids(self) -> list[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]

    def generator_id(self) -> ObjectID:
        return ObjectID.for_task_return(self.task_id, 0)

    def desc(self) -> str:
        return f"{self.name}[{self.task_id.hex()[:8]}]"


@dataclass
class ActorInfo:
    """The head's record of an actor: its restart state machine
    (PENDING, ALIVE, RESTARTING, DEAD) and where it runs."""

    actor_id: ActorID
    name: str | None
    namespace: str = "default"
    class_id: str = ""
    state: str = "PENDING"
    node_id: Any = None
    worker_id: Any = None
    num_restarts: int = 0
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_async: bool = False
    creation_spec: TaskSpec | None = None
    death_cause: str = ""
    resources: dict = field(default_factory=dict)
    placement_group: PlacementGroupID | None = None
    bundle_index: int = -1
    detached: bool = False
