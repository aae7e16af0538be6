"""AggregateFn helpers for GroupedData.aggregate (counterpart of
`ray_tpu/data/aggregate.py`).

Parity: reference `data/aggregate.py` (AggregateFn, Sum/Min/Max/Mean/Std/
Count classes). Each is a module-level class whose `apply` reduces one
group's block with numpy to a Python scalar: they travel to the reduce
tasks by reference.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.data.block import _item


class AggregateFn:
    def __init__(self, name: str, apply):
        self.name = name
        self.apply = apply  # (sub_block) -> scalar


class _ColumnAgg(AggregateFn):
    _op = ""

    def __init__(self, on: str, alias_name: str | None = None):
        self.on = on
        self.name = alias_name or f"{self._op}({on})"

    def apply(self, block: dict):
        return _item(getattr(np, self._op)(block[self.on]))


class Sum(_ColumnAgg):
    _op = "sum"


class Min(_ColumnAgg):
    _op = "min"


class Max(_ColumnAgg):
    _op = "max"


class Mean(_ColumnAgg):
    _op = "mean"


class Std(AggregateFn):
    def __init__(self, on: str, ddof: int = 1,
                 alias_name: str | None = None):
        self.on, self.ddof = on, ddof
        self.name = alias_name or f"std({on})"

    def apply(self, block: dict):
        vals = block[self.on]
        return (float(np.std(vals, ddof=self.ddof)) if len(vals) > self.ddof
                else None)


class Count(AggregateFn):
    def __init__(self, alias_name: str | None = None):
        self.name = alias_name or "count()"

    def apply(self, block: dict):
        for col in block.values():
            return len(col)
        return 0
