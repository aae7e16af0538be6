"""Blocks: the unit of distributed data, as numpy column dicts in the
object plane (counterpart of `ray_tpu/data/block.py`).

Parity: reference `python/ray/data/block.py` (Block/BlockAccessor/
BlockMetadata). A block is a dict of equal-length numpy columns: numbers
and booleans are numeric arrays, tensor columns n-d arrays (row i is
`col[i]`), strings, bytes and ragged values object arrays. The JAX
package's blocks are pyarrow Tables; the card's machine has no pyarrow,
so pyarrow and pandas appear only at the edges (`from_arrow`,
`from_pandas`, `to_pandas`, the "pandas" and "pyarrow" batch formats),
imported where used. A block pickles with protocol 5, its numeric
columns out of band, into the port's object store.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Any = None          # Schema


class Schema:
    """Column names, each column's numpy dtype and its per-row shape (()
    for a scalar column, the tensor's shape for a tensor column)."""

    def __init__(self, names, types, shapes):
        self.names = list(names)
        self.types = list(types)
        self.shapes = list(shapes)

    def __len__(self):
        return len(self.names)

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}{list(s) if s else ''}" for n, t, s in
                         zip(self.names, self.types, self.shapes))
        return f"Schema({cols})"


def _object_column(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _column(v) -> np.ndarray:
    """One batch column as a block column: strings and bytes become object
    arrays, ragged sequences an object array of their rows."""
    if isinstance(v, np.ndarray):
        arr = v
    else:
        try:
            arr = np.asarray(v)
        except ValueError:   # ragged: numpy refuses inhomogeneous shapes
            return _object_column([np.asarray(x) if isinstance(
                x, (list, tuple)) else x for x in v])
    if arr.ndim == 0:
        raise ValueError(f"a column needs one value a row, got {v!r}")
    if arr.dtype.kind in "USV":
        return arr.astype(object)
    return arr


def _column_from_values(values: list) -> np.ndarray:
    """A column from one Python value a row (the rows path): numbers and
    booleans as numeric arrays, equal-shaped sequences and arrays stacked
    into a tensor column, anything else (strings, bytes, None, ragged
    sequences, dicts) as an object array."""
    if all(isinstance(x, (bool, np.bool_)) for x in values):
        return np.asarray(values, dtype=bool)
    if all(isinstance(x, (int, float, np.integer, np.floating))
           and not isinstance(x, (bool, np.bool_)) for x in values):
        return np.asarray(values)
    if all(isinstance(x, (list, tuple, np.ndarray)) for x in values):
        try:
            arrs = [np.asarray(x) for x in values]
        except ValueError:   # a row of mixed items: (tensor, label)
            return _object_column(values)
        if (len({a.shape for a in arrs}) == 1 and arrs[0].ndim
                and all(a.dtype.kind in "biuf" for a in arrs)):
            return np.stack(arrs)
        return _object_column(arrs)
    return _object_column(values)


def _to_block(data) -> dict:
    """Normalize rows/batch/pandas/arrow into a block."""
    if isinstance(data, dict):          # column batch: {name: array}
        block = {k: _column(v) for k, v in data.items()}
        if len({len(c) for c in block.values()}) > 1:
            raise ValueError("a batch's columns differ in length: "
                             f"{ {k: len(c) for k, c in block.items()} }")
        return block
    if hasattr(data, "column_names") and hasattr(data, "to_pylist"):
        return _from_arrow(data)        # a pyarrow Table
    if hasattr(data, "to_dict") and hasattr(data, "columns"):  # DataFrame
        return {str(c): _column(data[c].to_numpy()) for c in data.columns}
    if isinstance(data, list):
        if not data:
            return {}
        if isinstance(data[0], dict):
            names: dict = {}
            for r in data:
                names.update(dict.fromkeys(r))
            return {n: _column_from_values([r.get(n) for r in data])
                    for n in names}
        return {"item": _column_from_values(data)}
    raise TypeError(f"cannot make a block from {type(data)}")


def _from_arrow(table) -> dict:
    out = {}
    for name in table.column_names:
        out[name] = _column(table.column(name).to_numpy(
            zero_copy_only=False))
        if out[name].dtype == object and len(out[name]) and all(
                isinstance(x, np.ndarray) for x in out[name]):
            out[name] = _column_from_values(list(out[name]))
    return out


class BlockAccessor:
    """Uniform view over a block (parity: data/block.py BlockAccessor)."""

    def __init__(self, block: dict):
        self._b = block

    @staticmethod
    def of(block) -> "BlockAccessor":
        return BlockAccessor(_to_block(block))

    @property
    def block(self) -> dict:
        return self._b

    def num_rows(self) -> int:
        for col in self._b.values():
            return len(col)
        return 0

    def size_bytes(self) -> int:
        return sum(col.nbytes + (len(pickle.dumps(col, protocol=5))
                                 if col.dtype == object else 0)
                   for col in self._b.values())

    def schema(self) -> Schema:
        return Schema(self._b, [c.dtype for c in self._b.values()],
                      [c.shape[1:] for c in self._b.values()])

    def metadata(self) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(), size_bytes=self.size_bytes(),
            schema=self.schema())

    # ---- conversions ----

    def to_batch(self) -> dict[str, np.ndarray]:
        """Columnar numpy batch (the "numpy"/default batch format)."""
        return dict(self._b)

    def to_pandas(self):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError("to_pandas and batch_format='pandas' need "
                              "pandas, which is not installed") from e
        return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                             for k, v in self._b.items()})

    def to_arrow(self):
        try:
            import pyarrow as pa
        except ImportError as e:
            raise ImportError("batch_format='pyarrow' needs pyarrow, which "
                              "is not installed") from e
        return pa.table({k: (list(v) if v.ndim > 1 else v)
                         for k, v in self._b.items()})

    def to_rows(self) -> list[dict]:
        names = list(self._b)
        return [{n: _item(self._b[n][i]) for n in names}
                for i in range(self.num_rows())]

    def iter_rows(self) -> Iterator[dict]:
        yield from self.to_rows()

    def slice(self, start: int, end: int) -> dict:
        return {k: v[start:end] for k, v in self._b.items()}

    def take_indices(self, idx) -> dict:
        idx = np.asarray(idx, dtype=np.int64)
        return {k: v[idx] for k, v in self._b.items()}

    def sample(self, n: int, key: str):
        k = min(n, self.num_rows())
        if k == 0:
            return []
        idx = np.random.default_rng(0).choice(self.num_rows(), k,
                                               replace=False)
        return [_item(v) for v in self._b[key][idx]]


def _item(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def concat_blocks(blocks: list) -> dict:
    """One block of the blocks' rows in order. A column missing from a
    block is None there; columns whose dtypes or row shapes differ
    across blocks (one block's token lists equal in length, another's
    ragged) become object arrays of their rows."""
    blocks = [b for b in blocks if b]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return dict(blocks[0])
    names: dict = {}
    for b in blocks:
        names.update(dict.fromkeys(b))
    out = {}
    for n in names:
        parts = [b[n] if n in b else np.full(
            BlockAccessor(b).num_rows(), None, dtype=object) for b in blocks]
        if (len({p.shape[1:] for p in parts}) == 1
                and (all(p.dtype != object for p in parts)
                     or all(p.dtype == object for p in parts))):
            out[n] = np.concatenate(parts)
        else:
            out[n] = _object_column([r for p in parts for r in p])
    return out


def block_from_batch(batch) -> dict:
    return _to_block(batch)


def block_from_rows(rows: list) -> dict:
    return _to_block(rows)
