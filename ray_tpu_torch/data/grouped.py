"""GroupedData: groupby aggregations and map_groups (counterpart of
`ray_tpu/data/grouped.py`).

Parity: reference `data/grouped_data.py` — sort-based shuffle colocates each
key's rows in one partition (range partition on the key, then a stable
sort within it), then per-partition aggregates / per-group UDFs run as
reduce tasks. A partition's groups come out in key order, each with the
key column first, as pyarrow's group_by gives them in the JAX package.
The aggregate functions are partials of module-level functions: they
travel to the reduce tasks by reference.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from ray_tpu_torch.data import plan as plan_mod
from ray_tpu_torch.data.block import (_item, block_from_batch,
                                     block_from_rows, concat_blocks)


def _column_agg(key: str, op: str, cols: list, block: dict) -> dict:
    """One row a group: the key, then `op(col)` of each column (all but
    the key when `cols` is empty). std is the population std, as the JAX
    package's pyarrow "stddev" (ddof 0)."""
    use = cols or [c for c in block if c != key]
    rows = []
    for kv, group in _iter_groups(block, key):
        row = {key: kv}
        for c in use:
            vals = group[c]
            row[f"{op}({c})"] = _item(
                np.std(vals) if op == "stddev" else getattr(np, op)(vals))
        rows.append(row)
    return block_from_rows(rows)


def _count(key: str, block: dict) -> dict:
    return block_from_rows([{key: kv, "count()": len(group[key])}
                            for kv, group in _iter_groups(block, key)])


def _aggregate_fns(key: str, aggs: tuple, block: dict) -> dict:
    rows = []
    for kv, group in _iter_groups(block, key):
        row = {key: kv}
        for agg in aggs:
            row[agg.name] = agg.apply(group)
        rows.append(row)
    return block_from_rows(rows)


def _map_groups(key: str, fn: Callable, batch_format: str,
                block: dict) -> dict:
    from ray_tpu_torch.data.dataset import _batch_of
    outs = [fn(_batch_of(group, batch_format))
            for _kv, group in _iter_groups(block, key)]
    return concat_blocks([block_from_batch(o) for o in outs])


class GroupedData:
    def __init__(self, ds, key: str):
        self._ds = ds
        self._key = key

    def _agg_dataset(self, aggregate: Callable):
        from ray_tpu_torch.data.dataset import Dataset
        return Dataset(self._ds._plan.with_op(plan_mod.AllToAll(
            name="GroupByAgg", kind="groupby",
            args={"key": self._key, "aggregate": aggregate})))

    def _column_agg(self, op: str, on):
        cols = [on] if isinstance(on, str) else list(on or [])
        return self._agg_dataset(functools.partial(
            _column_agg, self._key, op, cols))

    def sum(self, on=None):
        return self._column_agg("sum", on)

    def min(self, on=None):
        return self._column_agg("min", on)

    def max(self, on=None):
        return self._column_agg("max", on)

    def mean(self, on=None):
        return self._column_agg("mean", on)

    def std(self, on=None):
        return self._column_agg("stddev", on)

    def count(self):
        return self._agg_dataset(functools.partial(_count, self._key))

    def aggregate(self, *aggs):
        """AggregateFn-style: each agg (ray_tpu_torch.data.aggregate) has
        a name and an `apply(group_block) -> scalar`."""
        return self._agg_dataset(functools.partial(
            _aggregate_fns, self._key, aggs))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        return self._agg_dataset(functools.partial(
            _map_groups, self._key, fn, batch_format))


def _iter_groups(block: dict, key: str):
    """Yield (key_value, sub_block) from a block sorted by key."""
    col = block.get(key)
    if col is None or len(col) == 0:
        return
    # Boundaries where the key changes (the block arrives sorted by key).
    change = np.nonzero(col[1:] != col[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(col)]])
    for s, e in zip(starts, ends):
        yield _item(col[s]), {k: v[s:e] for k, v in block.items()}
