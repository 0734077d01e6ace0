"""ray_tpu_torch.util — utility APIs (reference: python/ray/util/).

Ported: placement groups, scheduling strategies, user metrics
(``util.metrics``), ``ActorPool``, the queue (``util.queue``) and the
state API (``util.state``); import the last two by name."""

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
