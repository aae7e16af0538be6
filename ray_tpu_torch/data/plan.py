"""Logical plan + optimizer for Datasets (counterpart of
`ray_tpu/data/plan.py`).

Parity: reference `data/_internal/logical/` (LogicalPlan `interfaces/
logical_plan.py:10`, operators in `logical/operators/`, rule-based optimizer
`logical/optimizers.py`). Ops are lazy records; the optimizer fuses adjacent
block transforms so a fused chain runs as ONE task per block (the reference's
OperatorFusionRule), which is the main thing that keeps the object plane
out of the per-row path.

Every function an op holds travels to the workers, where a host without
cloudpickle unpickles it by reference: so ops hold module-level callables
(functions, `functools.partial`s of them, instances of module-level
classes), and a fused chain is a `_Compose`/`_ComposeRead` of them, never
a closure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class LogicalOp:
    name: str


@dataclasses.dataclass
class Read(LogicalOp):
    """N read tasks, each () -> block."""
    read_fns: list  # list[Callable[[], dict]]


@dataclasses.dataclass
class InputData(LogicalOp):
    """Pre-materialized blocks (from_items/from_numpy/...)."""
    refs: list      # list[(ObjectRef, BlockMetadata)]


@dataclasses.dataclass
class MapBlocks(LogicalOp):
    """One block in, one block out (map/map_batches/filter/flat_map...)."""
    fn: Callable    # block -> block
    compute: Any = None          # None = task pool; int = actor pool size
    fn_constructor: Any = None   # class UDF: constructed once per actor
    # Resources of each task or actor of the stage (num_cpus, num_gpus):
    # map_batches' own arguments, as Ray's are
    ray_remote_args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AllToAll(LogicalOp):
    """Materializing exchange: repartition/shuffle/sort/groupby."""
    kind: str       # "repartition" | "shuffle" | "sort" | "groupby"
    args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Limit(LogicalOp):
    n: int = 0


@dataclasses.dataclass
class Union(LogicalOp):
    others: list = dataclasses.field(default_factory=list)  # [LogicalPlan]


@dataclasses.dataclass
class Zip(LogicalOp):
    other: Any = None  # LogicalPlan


class LogicalPlan:
    def __init__(self, ops: list[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def optimized(self) -> "LogicalPlan":
        """Operator fusion (parity: the reference's rule-based optimizer
        fusing read->map and map->map chains into single tasks): adjacent
        task-pool MapBlocks with the same resources compose; a task-pool
        MapBlocks that asks for no resources of its own directly after a
        Read folds into the read tasks themselves — one task reads AND
        transforms, halving task count and intermediate block traffic."""
        out: list[LogicalOp] = []
        for op in self.ops:
            fusable_map = (isinstance(op, MapBlocks) and op.compute is None
                           and op.fn_constructor is None)
            if (fusable_map and out and isinstance(out[-1], MapBlocks)
                    and out[-1].compute is None
                    and out[-1].fn_constructor is None
                    and out[-1].ray_remote_args == op.ray_remote_args):
                prev = out.pop()
                out.append(MapBlocks(
                    name=f"{prev.name}->{op.name}",
                    fn=_Compose(prev.fn, op.fn),
                    ray_remote_args=op.ray_remote_args))
            elif (fusable_map and not op.ray_remote_args and out
                  and isinstance(out[-1], Read)):
                prev = out.pop()
                out.append(Read(
                    name=f"{prev.name}->{op.name}",
                    read_fns=[_ComposeRead(rf, op.fn)
                              for rf in prev.read_fns]))
            else:
                out.append(op)
        return LogicalPlan(out)

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)


class _Compose:
    """block -> g(f(block))."""

    def __init__(self, f, g):
        self.f, self.g = f, g

    def __call__(self, block):
        return self.g(self.f(block))


class _ComposeRead:
    """() -> map_fn(read_fn())."""

    def __init__(self, read_fn, map_fn):
        self.read_fn, self.map_fn = read_fn, map_fn

    def __call__(self):
        return self.map_fn(self.read_fn())
