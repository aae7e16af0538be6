"""DataContext: execution knobs (a copy of `ray_tpu/data/context.py`;
parity: reference `data/context.py`)."""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class DataContext:
    target_min_block_size: int = 1 * 1024 * 1024
    read_parallelism: int = 8          # default override_num_blocks for reads
    max_tasks_in_flight: int = 8       # per-operator streaming window
    # Global byte budget for in-flight operator outputs across the whole
    # pipeline (parity: execution/resource_manager.py + backpressure
    # policies). 0 = unlimited. Liveness rule: a stage with nothing in
    # flight may always submit one task regardless of the budget.
    memory_budget_bytes: int = 0
    # Locality-aware submission: map/split tasks carry a soft
    # NodeAffinity hint for the node owning their input block (resolved
    # through the head's object directory), so map-heavy pipelines stay
    # node-local instead of objxfer-pulling every block. Placement falls
    # back to the hybrid policy when the owner is saturated or dead.
    locality_hints: bool = True

    _local = threading.local()

    @staticmethod
    def get_current() -> "DataContext":
        ctx = getattr(DataContext._local, "ctx", None)
        if ctx is None:
            ctx = DataContext()
            DataContext._local.ctx = ctx
        return ctx
