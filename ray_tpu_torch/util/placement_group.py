"""Placement groups: atomically-reserved resource bundles.

Parity: reference `python/ray/util/placement_group.py:145` (placement_group,
PlacementGroup.ready/wait, remove_placement_group, placement_group_table)
with the strategies of `bundle_scheduling_policy.h:31-106`
(PACK/SPREAD/STRICT_PACK/STRICT_SPREAD). TPU-native addition:
``ICI_CONTIGUOUS`` asks for bundles mapped onto topologically contiguous
TPU sub-slices (generalizing the reference's `TPU-{type}-head` resource
trick, `_private/accelerators/tpu.py:422`, into the scheduler).

On the single-node runtime the reservation is a carve-out of the head's
resource pool per bundle; the 2-phase-commit across raylets
(`gcs_placement_group_scheduler.h:288`) collapses to one atomic reserve.
"""

from __future__ import annotations

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.ids import ObjectID

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
              "ICI_CONTIGUOUS")


class PlacementGroup:
    """Handle to a created (or pending) placement group."""

    __slots__ = ("id", "bundle_specs", "_ready_oid")

    def __init__(self, pg_id: PlacementGroupID, bundle_specs, ready_oid=None):
        self.id = pg_id
        self.bundle_specs = bundle_specs
        self._ready_oid = ready_oid

    def ready(self) -> ObjectRef:
        """ObjectRef fulfilled once every bundle is reserved."""
        return ObjectRef(ObjectID(self._ready_oid))

    def wait(self, timeout_seconds: float | None = None) -> bool:
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(self.ready(), timeout=timeout_seconds)
            return True
        except Exception:  # noqa: BLE001 — timeout or removal
            return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self._ready_oid))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]}, {self.bundle_specs})"


def placement_group(bundles, strategy: str = "PACK", name: str = "",
                    lifetime=None) -> PlacementGroup:
    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    clean = []
    for b in bundles:
        if not isinstance(b, dict):
            raise ValueError(f"bundle must be a dict, got {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"bundle amounts must be >= 0: {b!r}")
        c = {k: float(v) for k, v in b.items() if v}
        if not c:
            raise ValueError(
                f"bundle must request a positive amount of at least one "
                f"resource, got {b!r}")
        clean.append(c)
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    pg_id = PlacementGroupID.from_random()
    if isinstance(rt, Runtime):
        ready_oid = rt.create_placement_group(
            pg_id.binary(), clean, strategy, name)
    else:
        ready_oid = rt.request(
            "create_pg", (pg_id.binary(), clean, strategy, name))
    return PlacementGroup(pg_id, clean, ready_oid)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        rt.remove_placement_group(pg.id.binary())
    else:
        rt.request("remove_pg", pg.id.binary())


def placement_group_table() -> dict:
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return rt.placement_group_table()
    return rt.request("pg_table")


def get_current_placement_group() -> PlacementGroup | None:
    """The placement group of the currently-executing task/actor, if any
    (parity: util/placement_group.py get_current_placement_group)."""
    from ray_tpu_torch.core.runtime import current_runtime
    rt = current_runtime()
    strat = (getattr(rt, "current_scheduling_strategy", None)
             or getattr(rt, "actor_scheduling_strategy", None))
    return getattr(strat, "placement_group", None)
