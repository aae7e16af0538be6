"""PyTorch port, the data library (`ray_tpu_torch.data`, numpy column
blocks) on the CPU, against the JAX package's `ray_tpu.data` (pyarrow
blocks).

Blocks without a runtime: blocks made from rows, batches (a tensor column,
strings) and empty inputs give the JAX BlockAccessor's batches and rows.

Pipelines through both runtimes, one module-scoped runtime each in this
process: every case builds the same pipeline with each package's `data`
module on the same UDFs (`tests/test_torch_dist_workers.py`, imported by
name in the workers) and must give the JAX package's rows in order:
integers and strings exactly, floats within 1e-12 relative (summation
order may differ), the seeded shuffles included. Then the plan's fusion,
the executor's memory budget and the Trainer's ingest of a port Dataset.
"""

import math
import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as j_rd
from ray_tpu.data import block as j_block
from ray_tpu_torch import data as t_rd
from ray_tpu_torch.data import block as t_block
from tests import test_torch_dist_workers as W

REL = 1e-12


def _same(a, b, where="") -> None:
    """a (JAX) == b (port): ints, strings and bytes exactly, floats
    within REL, arrays elementwise, containers item by item in order."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = _as_numpy(np.asarray(a)), _as_numpy(np.asarray(b))
        assert a.shape == b.shape, (where, a.shape, b.shape)
        for i, (x, y) in enumerate(zip(a.reshape(-1), b.reshape(-1))):
            _same(x.item() if isinstance(x, np.generic) else x,
                  y.item() if isinstance(y, np.generic) else y,
                  f"{where}[{i}]")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (
            where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    if isinstance(a, float) or isinstance(b, float):
        assert type(a) is type(b) and (a == b or math.isclose(
            a, b, rel_tol=REL)), (where, a, b)
        return
    assert type(a) is type(b) and a == b, (where, a, b)


def _as_numpy(col: np.ndarray) -> np.ndarray:
    """An object column of equal-shaped numeric arrays (pyarrow's list
    columns) stacked into the tensor column the port keeps."""
    if (col.dtype == object and col.ndim == 1 and len(col)
            and all(isinstance(x, np.ndarray) for x in col)
            and len({x.shape for x in col}) == 1):
        return np.stack(list(col))
    return col


# ---- blocks, no runtime ----


BLOCK_INPUTS = {
    "rows": [{"a": 1, "b": "x", "c": 1.5, "d": [1, 2], "e": True},
             {"a": 2, "b": "yy", "c": 2.5, "d": [3, 4], "e": False}],
    "ragged_rows": [{"r": [1]}, {"r": [1, 2]}, {"r": []}],
    "items": [3, 1, 2],
    "strings": ["a", "bb"],
    "batch": {"id": np.arange(4), "t": np.arange(24.).reshape(4, 3, 2),
              "s": ["a", "b", "c", "d"], "f": np.linspace(0, 1, 4)},
    "empty_rows": [],
    "empty_batch": {},
}


@pytest.mark.parametrize("name", list(BLOCK_INPUTS))
def test_block_batches_and_rows_match_jax(name):
    data = BLOCK_INPUTS[name]
    j = j_block.BlockAccessor.of(data)
    t = t_block.BlockAccessor.of(data)
    jb, tb = j.to_batch(), t.to_batch()
    assert list(jb) == list(tb)
    for k in jb:
        _same(jb[k], tb[k], k)
    _same(j.to_rows(), t.to_rows())
    assert t.num_rows() == j.num_rows()
    assert t.schema().names == [n for n in j.schema().names
                                if not n.startswith("__shape__")]
    n = t.num_rows()
    if n:
        key = list(tb)[0]
        _same(j_block.BlockAccessor(j.slice(1, n)).to_rows(),
              t_block.BlockAccessor(t.slice(1, n)).to_rows())
        idx = list(range(n))[::-1]
        _same(j_block.BlockAccessor(j.take_indices(idx)).to_rows(),
              t_block.BlockAccessor(t.take_indices(idx)).to_rows())
        _same(j.sample(2, key), t.sample(2, key))


def test_block_concat_and_metadata():
    """Blocks concatenate in order, a tensor column stays n-d, columns
    whose row shapes differ across blocks become object columns, and the
    metadata counts the object columns' pickled bytes."""
    a = t_block.block_from_batch({"t": np.ones((2, 3)), "s": ["a", "b"]})
    b = t_block.block_from_rows([{"t": [1.0, 2.0], "s": "c"}])
    c = t_block.concat_blocks([a, {}, b])
    assert c["t"].dtype == object and len(c["t"]) == 3
    assert c["s"].tolist() == ["a", "b", "c"]
    d = t_block.concat_blocks([a, a])
    assert d["t"].shape == (4, 3) and d["t"].dtype == np.float64
    meta = t_block.BlockAccessor(a).metadata()
    assert meta.num_rows == 2 and meta.size_bytes > a["t"].nbytes
    assert meta.schema.shapes == [(3,), ()]
    assert t_block.concat_blocks([]) == {}


# ---- pipelines through both runtimes ----


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=64 << 20)
    rt.init(num_cpus=4, object_store_memory=128 << 20)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _transforms(rd):
    return rd.range(20).map(W.double_id).filter(W.id_div3).flat_map(
        W.twice).take_all()


def _map_batches(rd):
    return [rd.range(33, override_num_blocks=3).map_batches(
                W.square_batch, batch_size=8).take_all(),
            rd.range(12).map_batches(W.Scaler, fn_constructor_args=(3,),
                                     concurrency=2, batch_size=5).take_all()]


def _tensor_column(rd):
    ds = rd.from_numpy(np.arange(24, dtype=np.float32).reshape(6, 2, 2))
    return [ds.take_batch(6)["data"],
            ds.map_batches(W.double_data).take_all()]


def _column_ops(rd):
    ds = rd.range(6).map(W.double_id).add_column("ten", W.id_times_ten)
    return [ds.take_all(), ds.columns(),
            ds.rename_columns({"ten": "t"}).take_all(),
            ds.select_columns(["name", "ten"]).take_all(),
            ds.drop_columns(["name"]).take_all()]


def _exchanges(rd):
    ds = rd.range(40).repartition(4)
    return [ds.num_blocks(),
            [len(b["id"]) for b in ds.iter_batches(batch_size=None)],
            ds.take_all(),
            rd.range(50).random_shuffle(seed=7).take_all(),
            rd.range(50).random_shuffle(seed=8, num_blocks=3).take_all(),
            rd.range(40).randomize_block_order(seed=3).take_all()]


def _sort(rd):
    items = [{"k": (i * 7) % 5, "v": i, "f": i * 0.25} for i in range(40)]
    ds = rd.from_items(items).random_shuffle(seed=2)
    return [ds.sort("k").take_all(),
            ds.sort("k", descending=True).take_all(),
            ds.sort("f", descending=True).take_all()]


def _groupby(rd):
    agg = rd.aggregate
    ds = rd.from_items([{"k": (i * 5) % 3, "v": i * 0.37, "w": i}
                        for i in range(30)]).random_shuffle(seed=4)
    g = ds.groupby("k")
    return [g.count().take_all(), g.sum("v").take_all(),
            g.sum().take_all(), g.mean("w").take_all(),
            g.std("v").take_all(), g.min("w").take_all(),
            g.max(["v", "w"]).take_all(),
            g.aggregate(agg.Sum("v"), agg.Mean("w"), agg.Std("v"),
                        agg.Count(), agg.Min("w"), agg.Max("v")).take_all(),
            g.map_groups(W.group_extremes).take_all()]


def _limit_union_zip(rd):
    return [rd.range(100).limit(7).take_all(),
            rd.range(5).union(rd.range(3), rd.range(2)).take_all(),
            rd.range(12).repartition(3).zip(
                rd.range(12).map(W.with_b).repartition(4)).take_all(),
            rd.range(4).zip(rd.range(4)).take_all()]


def _iter_batches(rd):
    ds = rd.range(53)

    def ids(**kw):
        return [b["id"].tolist() for b in ds.iter_batches(**kw)]
    return [ids(batch_size=7), ids(batch_size=7, drop_last=True),
            ids(batch_size=7, local_shuffle_buffer_size=20,
                local_shuffle_seed=3),
            ids(batch_size=10, local_shuffle_buffer_size=15,
                local_shuffle_seed=5, drop_last=True),
            ids(batch_size=None)]


def _splits(rd):
    return [[s.take_all() for s in rd.range(10).split(3, equal=True)],
            [s.take_all() for s in rd.range(10).split(3)],
            [s.take_all() for s in rd.range(20).split_at_indices([3, 11])],
            [s.take_all() for s in rd.range(20).train_test_split(0.25)],
            [s.take_all() for s in rd.range(20).train_test_split(
                3, shuffle=True, seed=5)],
            [it.count() for it in rd.range(17).streaming_split(
                2, equal=True)]]


def _aggregates(rd):
    ds = rd.from_items([{"x": i * 0.5, "n": i} for i in range(17)])
    return [ds.sum("n"), ds.min("x"), ds.max("n"), ds.mean("x"),
            ds.std("x"), ds.std("n", ddof=0), ds.count(),
            ds.schema().names, ds.take(3)]


def _empty(rd):
    ds = rd.from_items([])
    return [ds.count(), ds.take_all(), ds.sum("x"), ds.mean("x"),
            rd.range(0).count(), rd.range(0).take_all(),
            rd.range(10).filter(W.id_div3).limit(0).take_all()]


PIPELINES = {f.__name__[1:]: f for f in (
    _transforms, _map_batches, _tensor_column, _column_ops, _exchanges,
    _sort, _groupby, _limit_union_zip, _iter_batches, _splits, _aggregates,
    _empty)}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_matches_jax(runtimes, name):
    run = PIPELINES[name]
    _same(run(j_rd), run(t_rd), name)


def test_plan_fusion_matches_jax():
    """read->map->map fuses into one Read, map->map chains compose, an
    actor-pool stage does not fuse: the same optimized plan as the JAX
    package's, its fused functions module-level objects. A task stage
    that reserves resources of its own keeps its own tasks."""
    import pickle

    def chain(rd):
        return (rd.range(8).map(W.double_id).filter(W.id_div3)
                .map_batches(W.Scaler, fn_constructor_args=(2,))
                .map_batches(W.square_batch).flat_map(W.twice)
                .random_shuffle(seed=1).map(W.double_id))
    j, t = chain(j_rd)._plan.optimized(), chain(t_rd)._plan.optimized()
    assert t.describe() == j.describe(), (t.describe(), j.describe())
    assert t.describe() == ("ReadRange->Map->Filter -> MapBatches -> "
                            "MapBatches->FlatMap -> RandomShuffle -> Map")
    travels = [f for op in t.ops for f in getattr(op, "read_fns", [])
               + [getattr(op, "fn", None), getattr(op, "fn_constructor",
                                                   None)] if f is not None]
    assert len(travels) == 8 + 4   # 8 fused reads, 3 maps, 1 class UDF
    for fn in travels:   # module-level objects: they pickle by reference
        assert pickle.loads(pickle.dumps(fn)) is not None
    gpu = t_rd.range(8).map_batches(W.square_batch, num_gpus=0.5)
    assert gpu.map(W.double_id)._plan.optimized().describe() == (
        "ReadRange -> MapBatches -> Map")


def test_memory_budget_backpressure_no_deadlock(runtimes):
    """Streaming far more total bytes than the budget completes without
    deadlock, and in-flight output bytes respect the budget (the liveness
    rule lets a starved stage still run one task at a time)."""
    ctx = t_rd.DataContext.get_current()
    old = ctx.memory_budget_bytes
    ctx.memory_budget_bytes = 4 << 20  # 4 MB budget
    try:
        # 32 blocks x ~0.8MB = ~26MB total >> 4MB budget.
        ds = t_rd.range(32 * 100_000, override_num_blocks=32)
        ds = ds.map_batches(W.float_batch)
        total = 0
        for batch in ds.iter_batches(batch_size=None):
            total += len(batch["x"])
        assert total == 32 * 100_000
        budget = ctx._budget
        assert budget.limit == 4 << 20
        assert budget.peak > 0
        # Liveness may overshoot by one forced block per starved stage;
        # anything beyond that means backpressure is not engaging.
        assert budget.peak <= budget.limit + 2 * (1 << 20), budget.peak
    finally:
        ctx.memory_budget_bytes = old


def test_edges_convert_pandas_and_arrow(runtimes):
    """from_pandas, from_arrow, to_pandas and the "pandas"/"pyarrow"
    batch formats convert at the edges, to the JAX package's rows."""
    import pandas as pd
    import pyarrow as pa
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    table = pa.table({"a": [4, 5], "b": ["u", "v"]})
    for rd in (j_rd, t_rd):
        assert rd.from_pandas(df).to_pandas()["b"].tolist() == ["x", "y",
                                                                 "z"]
        assert rd.range(4).take_batch(4, batch_format="pyarrow").num_rows \
            == 4
    out = t_rd.from_pandas(df).union(t_rd.from_arrow(table)).to_pandas()
    assert out["a"].tolist() == [1, 2, 3, 4, 5]
    assert out["b"].tolist() == ["x", "y", "z", "u", "v"]
    _same(j_rd.from_arrow(table).take_all(),
          t_rd.from_arrow(table).take_all())
    _same(j_rd.from_pandas(df).take_all(), t_rd.from_pandas(df).take_all())


def test_read_text_binary_numpy(runtimes, tmp_path):
    (tmp_path / "t.txt").write_text("a\nbb\nccc\n")
    np.save(tmp_path / "x.npy", np.arange(12, dtype=np.int32).reshape(4, 3))
    for rd in (j_rd, t_rd):
        assert [r["text"] for r in rd.read_text(
            str(tmp_path / "t.txt")).take_all()] == ["a", "bb", "ccc"]
        got = rd.read_binary_files(str(tmp_path / "t.txt"),
                                   include_paths=True).take_all()
        assert got[0]["bytes"] == b"a\nbb\nccc\n"
        assert got[0]["path"].endswith("t.txt")
    _same(j_rd.read_numpy(str(tmp_path / "x.npy")).take_all(),
          t_rd.read_numpy(str(tmp_path / "x.npy")).take_all())


def test_iter_torch_batches_dtypes(runtimes):
    import torch
    ds = t_rd.range(10).map_batches(W.square_batch)
    batches = list(ds.iter_torch_batches(batch_size=4, device="cpu",
                                         dtypes={"half": torch.float32}))
    assert [len(b["id"]) for b in batches] == [4, 4, 2]
    assert batches[0]["half"].dtype == torch.float32
    assert batches[0]["id"].dtype == torch.int64
    assert batches[2]["sq"].tolist() == [64, 81]


def test_actor_pool_is_killed_when_a_take_ends_early(runtimes):
    """The actor pool lives for one execution: a take() that stops after
    the first block still kills every actor of the pool."""
    import gc
    import time

    from ray_tpu_torch.util.state import list_actors

    def alive():
        return sum(a["state"] == "ALIVE" for a in list_actors())
    before = alive()
    ds = t_rd.range(64, override_num_blocks=8).map_batches(
        W.Scaler, fn_constructor_args=(2,), concurrency=3)
    assert [r["id"] for r in ds.take(3)] == [0, 2, 4]
    gc.collect()
    deadline = time.monotonic() + 30
    while alive() > before and time.monotonic() < deadline:
        time.sleep(0.1)
    assert alive() == before


def test_trainer_ingest_two_gloo_workers(runtimes, tmp_path):
    """A port Dataset through the Trainer's equal split: two ranks under
    TorchDistributedConfig (gloo) each read 20 rows of their shard as
    torch batches, and together they see every row once."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchDistributedConfig, Trainer)
    seen_dir = tmp_path / "seen"
    seen_dir.mkdir()
    t_rd.DataContext.get_current().memory_budget_bytes = 1 << 20
    try:
        ds = t_rd.from_items([{"idx": i, "x": float(i)} for i in range(41)])
        res = Trainer(W.ingest_loop, train_loop_config={
            "seen_dir": str(seen_dir), "batch_size": 6},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
            torch_config=TorchDistributedConfig(),
            datasets={"train": ds}).fit()
    finally:
        t_rd.DataContext.get_current().memory_budget_bytes = 0
    assert res.error is None, res.error
    seen = {}
    for f in sorted(os.listdir(seen_dir)):
        with open(seen_dir / f) as fh:
            seen[f] = [int(x) for x in fh.read().split(",")]
    assert sorted(seen) == ["rank0.txt", "rank1.txt"]
    assert [len(v) for v in seen.values()] == [20, 20]
    assert sorted(seen["rank0.txt"] + seen["rank1.txt"]) == list(range(40))


@pytest.mark.parametrize("offset, world", [(0, 3), (13, 3), (13, 2)])
def test_trainer_resplit_matches_jax(runtimes, tmp_path, offset, world):
    """The Trainer's split of a port Dataset, fresh and past a committed
    manifest's dataset offset (an elastic restart at another world size):
    the same equal shards, row for row, as the JAX package's Trainer
    gives its Dataset."""
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import checkpoint as j_ckpt
    from ray_tpu_torch.train import Trainer
    path = j_ckpt.step_dir(str(tmp_path), 4)
    os.makedirs(path)
    j_ckpt.commit_manifest(path, step=4, world_size=2, shards=[],
                           dataset_offsets={"train": offset})
    items = [{"idx": i, "x": i * 0.5} for i in range(41)]
    j_shards, j_off = JaxTrainer(
        W.ingest_loop, datasets={"train": j_rd.from_items(items)}
    )._split_datasets(world, path)
    t_shards, t_off = Trainer(
        W.ingest_loop, datasets={"train": t_rd.from_items(items)}
    )._split_datasets(world, path)
    assert t_off == j_off == {"train": offset}
    _same([s["train"].take_all() for s in j_shards],
          [s["train"].take_all() for s in t_shards])
    assert [s["train"].count() for s in t_shards] == [(41 - offset)
                                                      // world] * world
