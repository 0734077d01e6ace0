"""Placement groups — public API.

Reference: python/ray/util/placement_group.py (placement_group(),
PlacementGroup.ready()/wait(), remove_placement_group,
placement_group_table, get_current_placement_group).

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    ray_tpu_torch.get(pg.ready(), timeout=10)
    f.options(placement_group=pg).remote()
"""

from __future__ import annotations

import contextvars
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID

# set while executing a task whose PG has capture_child_tasks=True;
# nested .remote() calls inherit the group (thread-mode workers).
_current_pg: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_pg", default=None)


class PlacementGroup:
    """Handle to a placement group (serializable by id)."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None):
        self.id = pg_id
        self._bundles = bundles

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            entry = _manager().get(self.id)
            self._bundles = entry.bundles if entry else []
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """ObjectRef fulfilled when the group is placed; ray_tpu_torch.get() on
        it raises PlacementGroupUnschedulableError if it can never fit."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        entry = _manager().get(self.id)
        if entry is None:
            raise ValueError(f"unknown placement group {self.id.hex()}")
        return ObjectRef(entry.ready_oid)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self.ready(), timeout=timeout_seconds)
            return True
        except Exception:
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))

    def __repr__(self) -> str:
        return f"PlacementGroup({self.id.hex()[:16]})"


def _manager():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.get_worker().placement_groups


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    priority: int = 0) -> PlacementGroup:
    """Reserve resource bundles across the cluster.

    strategy: PACK | SPREAD | STRICT_PACK | STRICT_SPREAD (reference
    semantics: STRICT_* fail rather than degrade).

    priority: QoS tier of the gang — while the group is pending, freed
    or autoscaled capacity goes to higher tiers first (FIFO within a
    tier). Inert at the default 0."""
    entry = _manager().create(bundles, strategy, name, priority=priority)
    return PlacementGroup(entry.pg_id, list(entry.bundles))


def remove_placement_group(pg: PlacementGroup) -> None:
    _manager().remove(pg.id)


def placement_group_table() -> Dict[str, Dict]:
    return _manager().table()


def get_current_placement_group() -> Optional[PlacementGroup]:
    """Inside a task/actor scheduled with capture_child_tasks=True, the
    group it runs in; else None."""
    pg_id = _current_pg.get()
    return PlacementGroup(pg_id) if pg_id is not None else None
