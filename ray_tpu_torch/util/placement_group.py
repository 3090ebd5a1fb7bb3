"""Placement groups (port of ray_tpu/util/placement_group.py):
``placement_group()``, ``PlacementGroup.ready()``/``wait()``, the PACK,
SPREAD, STRICT_PACK and STRICT_SPREAD strategies, over the head's
all-or-nothing bundle reservation (``core/runtime.py``)."""

from __future__ import annotations

from ray_tpu_torch.core.context import get_client
from ray_tpu_torch.core.ids import ObjectID, PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def _pg_ready_oid(pg_id: PlacementGroupID) -> ObjectID:
    return ObjectID(pg_id.binary() + b"\xfd\xfd\xfd\xfd")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict] | None = None):
        self.id = pg_id
        self._bundles = bundles

    def ready(self) -> ObjectRef:
        """ObjectRef sealed (True) once every bundle is reserved."""
        return ObjectRef(_pg_ready_oid(self.id))

    def wait(self, timeout_seconds: float | None = None) -> bool:
        return get_client().pg("wait", pg_id=self.id, timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> list[dict]:
        if self._bundles is None:
            for row in get_client().pg("table"):
                if row["pg_id"] == self.id.hex():
                    self._bundles = row["bundles"]
                    break
        return self._bundles or []

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
    lifetime: str | None = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"invalid strategy {strategy!r}; one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty resource dicts")
    pg_id = get_client().pg("create", bundles=bundles, strategy=strategy, name=name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    get_client().pg("remove", pg_id=pg.id)


def placement_group_table() -> list[dict]:
    return get_client().pg("table")


def get_current_placement_group() -> PlacementGroup | None:
    return None  # capture-child-tasks semantics not yet wired
