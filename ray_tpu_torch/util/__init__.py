"""Utility APIs layered on the core primitives.

Parity: reference `python/ray/util/` (placement groups, scheduling
strategies, ActorPool, queue, collective, state API).
"""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    placement_group,
    placement_group_table,
    remove_placement_group,
    PlacementGroup,
)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
