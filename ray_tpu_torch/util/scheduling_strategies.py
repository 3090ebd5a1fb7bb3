"""Scheduling strategy objects (port of
ray_tpu/util/scheduling_strategies.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
