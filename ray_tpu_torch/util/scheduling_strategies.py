"""User-facing scheduling strategies.

Reference: python/ray/util/scheduling_strategies.py. String strategies
"DEFAULT" and "SPREAD" are accepted directly by ``.options()``.
"""

from __future__ import annotations

from typing import Any, Optional


class PlacementGroupSchedulingStrategy:
    """Schedule a task/actor onto a placement group's reserved bundles.

    placement_group_bundle_index = -1 means any bundle of the group.
    """

    def __init__(self, placement_group: Any,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = \
            placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    """Pin to one node. soft=True falls back to the default policy when
    the node is missing/dead (if the node exists but is busy, the task
    waits for it)."""

    def __init__(self, node_id: Any, soft: bool = False):
        self.node_id = node_id
        self.soft = soft
