"""Scheduling strategies attached to task/actor options.

Parity: reference `python/ray/util/scheduling_strategies.py:15,41,135`
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy and the
"DEFAULT"/"SPREAD" string strategies). TPU-native addition: strategies are
plain picklable records interpreted by the head scheduler; the
ICI_CONTIGUOUS placement-group strategy maps bundles onto topologically
contiguous TPU sub-slices.
"""

from __future__ import annotations


class PlacementGroupSchedulingStrategy:
    """Run the task/actor inside a placement-group bundle's reservation."""

    __slots__ = ("placement_group", "placement_group_bundle_index",
                 "placement_group_capture_child_tasks")

    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)

    def __reduce__(self):
        return (PlacementGroupSchedulingStrategy,
                (self.placement_group, self.placement_group_bundle_index,
                 self.placement_group_capture_child_tasks))


class NodeAffinitySchedulingStrategy:
    """Pin to a node (parity: scheduling_strategies.py:135). On the
    single-node runtime every node id resolves to the head; the multi-node
    plane honors it for real."""

    __slots__ = ("node_id", "soft")

    def __init__(self, node_id, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def __reduce__(self):
        return (NodeAffinitySchedulingStrategy, (self.node_id, self.soft))


DEFAULT = "DEFAULT"
SPREAD = "SPREAD"
