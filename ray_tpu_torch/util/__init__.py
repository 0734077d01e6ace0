"""ray_tpu_torch.util — utility APIs (reference: python/ray/util/).

Ported: placement groups, scheduling strategies, user metrics
(``util.metrics``), ``ActorPool`` and the queue (``util.queue``, import it
by name). The state API (``util.state``) of
the reference is not ported yet (ROADMAP.md, the runtime's next items)."""

from ray_tpu_torch.util.placement_group import (placement_group,  # noqa: F401
                                                placement_group_table,
                                                remove_placement_group,
                                                get_current_placement_group,
                                                PlacementGroup)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)
from ray_tpu_torch.util import metrics  # noqa: F401
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401

__all__ = [
    "placement_group", "remove_placement_group", "placement_group_table",
    "get_current_placement_group", "PlacementGroup",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "metrics", "ActorPool",
]
