"""Dataset: lazy, distributed data transformed by tasks over the object plane
(counterpart of `ray_tpu/data/dataset.py`).

Parity: reference `python/ray/data/dataset.py:154` — lazy logical plan,
transforms (map/map_batches/filter/flat_map/...), all-to-all ops
(sort/shuffle/repartition/groupby), consumption (take/iter_batches/
iter_torch_batches), split/streaming_split for Train. Blocks are numpy
column dicts (block.py); execution is the windowed streaming executor
(execution.py).

Every transform wraps the user's function in a `functools.partial` of a
module-level function (a class UDF's constructor in a partial of the
class): what travels to the workers pickles by reference, on a host
without cloudpickle too. The user's own functions must then be
importable module-level names there.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import plan as plan_mod
from ray_tpu_torch.data.block import (
    BlockAccessor,
    Schema,
    _item,
    block_from_batch,
    block_from_rows,
    concat_blocks,
)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.execution import execute


def _batch_of(block: dict, fmt: str):
    acc = BlockAccessor(block)
    if fmt in ("numpy", "default", None):
        return acc.to_batch()
    if fmt == "pandas":
        return acc.to_pandas()
    if fmt == "pyarrow":
        return acc.to_arrow()
    raise ValueError(f"unknown batch_format {fmt!r}")


def _get(bref) -> dict:
    return ray_tpu_torch.get(bref, timeout=600)


# ------------- the transforms' block functions (module-level) -------------


def _map_rows(fn, block):
    return block_from_rows([fn(r) for r in BlockAccessor(block).to_rows()])


def _flat_map_rows(fn, block):
    out = []
    for r in BlockAccessor(block).to_rows():
        out.extend(fn(r))
    return block_from_rows(out)


def _filter_rows(fn, block):
    return block_from_rows([r for r in BlockAccessor(block).to_rows()
                            if fn(r)])


def _add_column(name, fn, block):
    batch = BlockAccessor(block).to_batch()
    batch[name] = np.asarray(fn(batch))
    return block_from_batch(batch)


def _drop_columns(cols, block):
    return {k: v for k, v in block.items() if k not in cols}


def _select_columns(cols, block):
    return {k: v for k, v in block.items() if k in cols}


def _rename_columns(mapping, block):
    return {mapping.get(k, k): v for k, v in block.items()}


def _apply_batches(fn, block, batch_size, batch_format):
    acc = BlockAccessor(block)
    outs = []
    n = acc.num_rows()
    step = batch_size or max(n, 1)
    for start in _brange(0, max(n, 1), step):
        batch = _batch_of(acc.slice(start, start + step), batch_format)
        outs.append(block_from_batch(fn(batch)))
    return concat_blocks(outs)


def _apply_batches_of(batch_size, batch_format, instance, block):
    """An actor-pool stage's chain: the actor's UDF instance over the
    block's batches."""
    return _apply_batches(instance, block, batch_size, batch_format)


class Dataset:
    def __init__(self, logical_plan: plan_mod.LogicalPlan):
        self._plan = logical_plan

    # ------------- transforms (lazy) -------------

    def _with(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def _map_op(self, name: str, fn, *args) -> "Dataset":
        return self._with(plan_mod.MapBlocks(
            name=name, fn=functools.partial(fn, *args)))

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._map_op("Map", _map_rows, fn)

    def map_batches(self, fn, *, batch_size: int | None = None,
                    batch_format: str = "numpy", concurrency=None,
                    fn_constructor_args=(),
                    num_cpus: float | None = None,
                    num_gpus: float | None = None) -> "Dataset":
        """`fn` over the blocks' batches: a function in a task pool, or a
        class (constructed with `fn_constructor_args` once per actor) in
        an actor pool of `concurrency` actors (2 by default). `num_cpus`
        and `num_gpus` are each task's or actor's resources, as in Ray:
        a stage that runs on the card reserves a share of it."""
        remote_args = {k: v for k, v in (("num_cpus", num_cpus),
                                         ("num_gpus", num_gpus))
                       if v is not None}
        if isinstance(fn, type):
            size = concurrency if isinstance(concurrency, int) else 2
            return self._with(plan_mod.MapBlocks(
                name="MapBatches",
                fn=functools.partial(_apply_batches_of, batch_size,
                                     batch_format),
                compute=size,
                fn_constructor=functools.partial(
                    fn, *tuple(fn_constructor_args)),
                ray_remote_args=remote_args))
        return self._with(plan_mod.MapBlocks(
            name="MapBatches", fn=functools.partial(
                _apply_batches, fn, batch_size=batch_size,
                batch_format=batch_format),
            ray_remote_args=remote_args))

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._map_op("FlatMap", _flat_map_rows, fn)

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._map_op("Filter", _filter_rows, fn)

    def add_column(self, name: str, fn) -> "Dataset":
        return self._map_op("AddColumn", _add_column, name, fn)

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self._map_op("DropColumns", _drop_columns, list(cols))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self._map_op("SelectColumns", _select_columns, list(cols))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        return self._map_op("RenameColumns", _rename_columns, dict(mapping))

    # ------------- all-to-all -------------

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(plan_mod.AllToAll(
            name="Repartition", kind="repartition",
            args={"num_blocks": num_blocks}))

    def random_shuffle(self, *, seed: int | None = None,
                       num_blocks: int | None = None) -> "Dataset":
        if seed is None:
            # Fresh entropy per plan so every epoch's shuffle differs.
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        return self._with(plan_mod.AllToAll(
            name="RandomShuffle", kind="shuffle",
            args={"seed": seed, "num_blocks": num_blocks}))

    def randomize_block_order(self, *, seed: int | None = None) -> "Dataset":
        # Cheap shuffle: permute block order only (parity: dataset.py
        # randomize_block_order).
        refs = list(self.iter_internal())
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(refs))
        return Dataset(plan_mod.LogicalPlan(
            [plan_mod.InputData(name="RandomizeBlocks",
                                refs=[refs[i] for i in order])]))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(plan_mod.AllToAll(
            name="Sort", kind="sort",
            args={"key": key, "descending": descending}))

    def groupby(self, key: str):
        from ray_tpu_torch.data.grouped import GroupedData
        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        return self._with(plan_mod.Limit(name="Limit", n=n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(plan_mod.Union(
            name="Union", others=[o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(plan_mod.Zip(name="Zip", other=other._plan))

    # ------------- execution / consumption -------------

    def iter_internal(self) -> Iterator[tuple]:
        return execute(self._plan)

    def materialize(self) -> "Dataset":
        refs = list(self.iter_internal())
        return Dataset(plan_mod.LogicalPlan(
            [plan_mod.InputData(name="Materialized", refs=refs)]))

    def count(self) -> int:
        return sum(meta.num_rows for _ref, meta in self.iter_internal())

    def num_blocks(self) -> int:
        return sum(1 for _ in self.iter_internal())

    def size_bytes(self) -> int:
        return sum(meta.size_bytes for _ref, meta in self.iter_internal())

    def schema(self) -> Schema | None:
        for _ref, meta in self.iter_internal():
            if meta.schema is not None and len(meta.schema) > 0:
                return meta.schema
        return None

    def columns(self) -> list[str]:
        s = self.schema()
        return s.names if s else []

    def take(self, n: int = 20) -> list[dict]:
        out = []
        for bref, _meta in self.limit(n).iter_internal():
            out.extend(BlockAccessor(_get(bref)).to_rows())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list[dict]:
        out = []
        for bref, _meta in self.iter_internal():
            out.extend(BlockAccessor(_get(bref)).to_rows())
        return out

    def take_batch(self, batch_size: int = 20, *,
                   batch_format: str = "numpy"):
        block = concat_blocks([
            _get(b) for b, _m in self.limit(batch_size).iter_internal()])
        return _batch_of(block, batch_format)

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def iter_rows(self) -> Iterator[dict]:
        for bref, _meta in self.iter_internal():
            yield from BlockAccessor(_get(bref)).iter_rows()

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: int | None = None,
                     local_shuffle_seed: int | None = None) -> Iterator:
        """Re-batches across block boundaries to exact batch_size. With
        local_shuffle_buffer_size, each batch is drawn uniformly from a
        buffer kept at >= that many rows (parity: iterator shuffle buffer) —
        rows move across batch boundaries, unlike a per-batch permute."""
        carry: dict | None = None
        rng = (np.random.default_rng(local_shuffle_seed)
               if local_shuffle_buffer_size else None)

        def rows(block):
            return BlockAccessor(block).num_rows()

        def head_and_rest(block, k: int):
            acc = BlockAccessor(block)
            if rng is None:
                return acc.slice(0, k), acc.slice(k, acc.num_rows())
            idx = rng.choice(acc.num_rows(), k, replace=False)
            rest = np.setdiff1d(np.arange(acc.num_rows()), idx,
                                assume_unique=True)
            return acc.take_indices(idx), acc.take_indices(rest)

        min_buffer = local_shuffle_buffer_size or 0
        for bref, _meta in self.iter_internal():
            block = _get(bref)
            carry = block if carry is None else concat_blocks([carry, block])
            if batch_size is None:
                yield _batch_of(carry, batch_format)
                carry = None
                continue
            while rows(carry) >= batch_size + min_buffer:
                head, carry = head_and_rest(carry, batch_size)
                yield _batch_of(head, batch_format)
        if carry is not None and batch_size is not None:
            # Stream exhausted: drain the shuffle buffer.
            while rows(carry) >= batch_size:
                head, carry = head_and_rest(carry, batch_size)
                yield _batch_of(head, batch_format)
            if rows(carry) and not drop_last:
                if rng is not None:
                    carry = BlockAccessor(carry).take_indices(
                        rng.permutation(rows(carry)))
                yield _batch_of(carry, batch_format)

    def iter_torch_batches(self, *, batch_size: int | None = 256,
                           drop_last: bool = False,
                           device=None, dtypes=None) -> Iterator:
        """iter_batches as torch tensors, cast to `dtypes` (one dtype, or
        one a column) and moved to `device` (None: left on the host, as
        the reference leaves them). device="cuda" in a worker that
        reserved a card puts them on its card; a worker that sees no card
        raises."""
        import torch

        from ray_tpu_torch import resolve_device
        dev = None if device is None else resolve_device(device)
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                if not v.flags.writeable:   # a view of the object store
                    v = v.copy()
                tv = torch.as_tensor(v)
                if dtypes is not None:
                    tv = tv.to(dtypes.get(k) if isinstance(dtypes, dict)
                               else dtypes)
                if dev is not None:
                    tv = tv.to(dev)
                out[k] = tv
            yield out

    def to_pandas(self, limit: int | None = None):
        ds = self.limit(limit) if limit else self
        blocks = [_get(b) for b, _m in ds.iter_internal()]
        return BlockAccessor(concat_blocks(blocks)).to_pandas()

    # ------------- splits -------------

    def split(self, n: int, *, equal: bool = False) -> list["Dataset"]:
        refs = list(self.iter_internal())
        if equal:
            # EXACT equal-row shards: lockstep SPMD consumers
            # (streaming_split in Train) need identical iteration counts
            # per rank — a one-row-ragged shard hangs the epoch-end
            # collective. Like the reference's equal split, the remainder
            # rows (total % n) are dropped; boundaries slice through
            # blocks where needed.
            total = sum(m.num_rows for _b, m in refs)
            per = total // n
            cuts = [per * i for i in _brange(1, n + 1)]
            from ray_tpu_torch.data.execution import split_refs_at
            shards = split_refs_at(refs, cuts)[:n]  # [n] = dropped tail
        else:
            shards = [[] for _ in _brange(n)]
            for i, pair in enumerate(refs):
                shards[i % n].append(pair)
        return [Dataset(plan_mod.LogicalPlan(
            [plan_mod.InputData(name=f"Split{i}", refs=s)]))
            for i, s in enumerate(shards)]

    def split_at_indices(self, indices: list[int]) -> list["Dataset"]:
        rows = self.take_all()
        cuts = [0] + list(indices) + [len(rows)]
        out = []
        for i in _brange(len(cuts) - 1):
            out.append(from_items(rows[cuts[i]:cuts[i + 1]]))
        return out

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: int | None = None) -> tuple:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        n_test = (int(test_size) if test_size >= 1
                  else int(total * test_size))
        a, b = ds.split_at_indices([total - n_test])
        return a, b

    def streaming_split(self, n: int, *, equal: bool = False
                        ) -> list["DataIterator"]:
        """Parity: dataset.py streaming_split — the Train ingest path."""
        return [DataIterator(s) for s in self.split(n, equal=equal)]

    def iterator(self) -> "DataIterator":
        return DataIterator(self)

    # ------------- aggregates -------------

    def sum(self, on: str):
        return self._simple_agg("sum", on)

    def min(self, on: str):
        return self._simple_agg("min", on)

    def max(self, on: str):
        return self._simple_agg("max", on)

    def mean(self, on: str):
        s = self._stats(on)
        return s["sum"] / s["n"] if s["n"] else None

    def std(self, on: str, ddof: int = 1):
        s = self._stats(on)
        n = s["n"]
        if n <= ddof:
            return None
        var = (s["sumsq"] - s["sum"] ** 2 / n) / (n - ddof)
        return float(np.sqrt(max(var, 0.0)))

    def _nonempty_columns(self, on: str):
        for bref, m in self.iter_internal():
            if m.num_rows:
                yield _get(bref)[on]

    def _simple_agg(self, op: str, on: str):
        vals = [_item(getattr(np, op)(col))
                for col in self._nonempty_columns(on)]
        if not vals:
            return None
        if op == "sum":
            return sum(vals)
        return min(vals) if op == "min" else max(vals)

    def _stats(self, on: str):
        n = 0
        total = 0.0
        sumsq = 0.0
        for col in self._nonempty_columns(on):
            n += len(col)
            total += _item(np.sum(col))
            sumsq += _item(np.sum(col * col))
        return {"n": n, "sum": total, "sumsq": sumsq}

    # ------------- writes -------------

    def write_tfrecord(self, path: str) -> None:
        """One TFRecord shard per block; rows become tf.train.Examples
        (dependency-free codec, readable by any TF input pipeline)."""
        self._write(path, "tfrecord")

    def write_avro(self, path: str) -> None:
        """One avro object container file per block (built-in codec)."""
        self._write(path, "avro")

    def _write(self, path: str, fmt: str) -> None:
        os.makedirs(path, exist_ok=True)
        from ray_tpu_torch.data.datasource import write_block_task
        refs = [write_block_task.remote(bref, path, i, fmt)
                for i, (bref, _m) in enumerate(self.iter_internal())]
        ray_tpu_torch.get(refs, timeout=600)

    def write_parquet(self, path: str) -> None:
        _pyarrow_half("write_parquet")

    def write_csv(self, path: str) -> None:
        _pyarrow_half("write_csv")

    def write_json(self, path: str) -> None:
        _pyarrow_half("write_json")

    def write_bigquery(self, *args, **kwargs) -> None:
        _pyarrow_half("write_bigquery")

    def write_clickhouse(self, *args, **kwargs) -> None:
        _pyarrow_half("write_clickhouse")

    def write_hudi(self, path: str) -> None:
        _pyarrow_half("write_hudi")

    def write_iceberg(self, path: str) -> None:
        _pyarrow_half("write_iceberg")

    # ------------- misc -------------

    def stats(self) -> str:
        return f"Dataset(plan: {self._plan.describe()})"

    def __repr__(self):
        return f"Dataset({self._plan.describe()})"


def _pyarrow_half(name: str):
    raise NotImplementedError(
        f"Dataset.{name} writes through pyarrow, the data library's "
        f"pyarrow half (ROADMAP queue 1 item 7 (e)2), which the PyTorch "
        f"port has not ported yet; write_tfrecord and write_avro need no "
        f"pyarrow")


class DataIterator:
    """Parity: reference `data/iterator.py` DataIterator — the object Train
    workers consume via get_dataset_shard."""

    def __init__(self, ds: Dataset):
        self._ds = ds

    def iter_batches(self, **kw):
        return self._ds.iter_batches(**kw)

    def iter_torch_batches(self, **kw):
        return self._ds.iter_torch_batches(**kw)

    def iter_rows(self):
        return self._ds.iter_rows()

    def materialize(self) -> Dataset:
        return self._ds.materialize()

    def count(self) -> int:
        return self._ds.count()


# ------------- sources (parity: data/read_api.py) -------------


_brange = __import__("builtins").range  # `range` below shadows the builtin


def _range_block(lo: int, hi: int) -> dict:
    return {"id": np.arange(lo, hi)}


def range(n: int, *, override_num_blocks: int | None = None) -> Dataset:
    k = override_num_blocks or min(
        DataContext.get_current().read_parallelism, max(n, 1))
    cuts = [n * i // k for i in _brange(k + 1)]
    fns = [functools.partial(_range_block, cuts[i], cuts[i + 1])
           for i in _brange(k)]
    return Dataset(plan_mod.LogicalPlan(
        [plan_mod.Read(name="ReadRange", read_fns=fns)]))


def _from_blocks(name: str, blocks: list) -> Dataset:
    refs = [(ray_tpu_torch.put(b), BlockAccessor(b).metadata())
            for b in blocks]
    return Dataset(plan_mod.LogicalPlan(
        [plan_mod.InputData(name=name, refs=refs)]))


def from_items(items: list, *, override_num_blocks: int | None = None
               ) -> Dataset:
    k = override_num_blocks or min(
        DataContext.get_current().read_parallelism, max(len(items), 1))
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    return _from_blocks("FromItems", [
        block_from_rows(rows[len(rows) * i // k: len(rows) * (i + 1) // k])
        for i in _brange(k)])


def from_pandas(dfs) -> Dataset:
    """Blocks from pandas DataFrames (pandas is needed only by the
    caller, who made them)."""
    if not isinstance(dfs, list):
        dfs = [dfs]
    return _from_blocks("FromPandas", [block_from_batch(df) for df in dfs])


def from_numpy(arrays) -> Dataset:
    if not isinstance(arrays, list):
        arrays = [arrays]
    return _from_blocks("FromNumpy", [block_from_batch(
        {"data": np.asarray(arr)}) for arr in arrays])


def from_arrow(tables) -> Dataset:
    """Blocks from pyarrow Tables, converted to numpy columns here."""
    if not isinstance(tables, list):
        tables = [tables]
    return _from_blocks("FromArrow", [block_from_batch(t) for t in tables])
