"""File datasources and sinks that need no pyarrow (counterpart of the
numpy half of `ray_tpu/data/datasource.py`).

Parity: reference `data/_internal/datasource/` (text, binary, numpy,
TFRecord, Avro, WebDataset and image readers, one read task per file;
`from_torch`, one read task per index range) and the write path (one
file per block). Each read task is a `functools.partial` of a
module-level reader: it travels by reference. PIL is imported where an
image is read. The pyarrow readers and sinks (parquet, csv, json, the
table formats, SQL and the HTTP warehouses) belong to ROADMAP queue 1
item 7 (e)2.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import avro
from ray_tpu_torch.data import plan as plan_mod
from ray_tpu_torch.data import tfrecord as tfr
from ray_tpu_torch.data.block import (
    BlockAccessor,
    _column_from_values,
    _object_column,
    block_from_batch,
    block_from_rows,
)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                f = os.path.join(p, name)
                if os.path.isfile(f) and not name.startswith((".", "_")):
                    out.append(f)
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files under {paths}")
    return out


def _make_read(paths, one_file: Callable[[str], dict],
               name: str) -> Dataset:
    """One read task a file: `one_file(path)`, a module-level function or
    a partial of one."""
    return Dataset(plan_mod.LogicalPlan(
        [plan_mod.Read(name=name, read_fns=[
            functools.partial(one_file, f) for f in _expand_paths(paths)])]))


def _read_text_file(f: str) -> dict:
    with open(f, "r") as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    return {"text": _object_column(lines)}


def _read_binary_file(include_paths: bool, f: str) -> dict:
    with open(f, "rb") as fh:
        data = fh.read()
    cols = {"bytes": _object_column([data])}
    if include_paths:
        cols["path"] = _object_column([f])
    return cols


def _read_numpy_file(f: str) -> dict:
    return block_from_batch({"data": np.load(f)})


def read_text(paths) -> Dataset:
    return _make_read(paths, _read_text_file, "ReadText")


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    return _make_read(paths, functools.partial(_read_binary_file,
                                               include_paths), "ReadBinary")


def read_numpy(paths) -> Dataset:
    return _make_read(paths, _read_numpy_file, "ReadNumpy")


# ---------------- TFRecord, Avro, WebDataset, images ----------------


def _read_tfrecord_file(verify_crc: bool, lists, f: str) -> dict:
    rows = [tfr.parse_example(rec)
            for rec in tfr.read_records(f, verify=verify_crc)]
    names: list = []
    for r in rows:  # union, first-seen order: no silent column loss
        for name in r:
            if name not in names:
                names.append(name)
    cols: dict = {}
    for name in names:
        vals = [r.get(name) for r in rows]
        as_list = (lists if lists is not None
                   else not all(v is not None and len(v) == 1
                                for v in vals))
        cols[name] = _column_from_values(
            vals if as_list else [None if not v else v[0] for v in vals])
    return cols


def read_tfrecord(paths, *, verify_crc: bool = True,
                  lists: bool | None = None) -> Dataset:
    """TFRecord files of tf.train.Example rows (parity:
    data/_internal/datasource/tfrecords_datasource.py); one read task per
    shard file, the codec of `tfrecord.py`.

    Column shapes: the Example format cannot tell a scalar from a
    one-element list, so `lists=None` (default) infers per file
    (all-length-1 -> scalars, else lists). Variable-length features whose
    lengths differ across shard files should pass `lists=True` for a
    stable schema; `lists=False` forces scalars (first element)."""
    return _make_read(paths, functools.partial(
        _read_tfrecord_file, verify_crc, lists), "ReadTFRecord")


def _read_avro_file(f: str) -> dict:
    _schema, records = avro.read_file(f)
    if not records:
        return {}
    return {k: _column_from_values([r.get(k) for r in records])
            for k in records[0]}


def read_avro(paths) -> Dataset:
    """Avro object container files through the built-in codec (parity:
    avro_datasource.py, minus the fastavro dependency)."""
    return _make_read(paths, _read_avro_file, "ReadAvro")


def _read_webdataset_file(f: str) -> dict:
    import tarfile
    samples: dict[str, dict] = {}
    order: list[str] = []
    with tarfile.open(f) as tf:
        for m in tf.getmembers():
            if not m.isfile():
                continue
            # WebDataset keys are the path up to the basename's first
            # dot: same-named files in different subdirectories are
            # distinct samples.
            d = os.path.dirname(m.name)
            stem, _, ext = os.path.basename(m.name).partition(".")
            key = f"{d}/{stem}" if d else stem
            if key not in samples:
                samples[key] = {}
                order.append(key)
            samples[key][ext] = tf.extractfile(m).read()
    exts = sorted({e for s in samples.values() for e in s})
    cols = {"__key__": _object_column(order)}
    for e in exts:
        cols[e] = _object_column([samples[k].get(e) for k in order])
    return cols


def read_webdataset(paths) -> Dataset:
    """WebDataset tar shards (parity:
    data/_internal/datasource/webdataset_datasource.py): files sharing a
    basename form one sample; each extension becomes a bytes column, plus
    the sample's '__key__'. One read task per shard tar."""
    return _make_read(paths, _read_webdataset_file, "ReadWebDataset")


def _read_image_file(include_paths: bool, mode, size, f: str) -> dict:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("read_images needs PIL (Pillow), which is not "
                          "installed") from e
    with Image.open(f) as img:
        if mode is not None:
            img = img.convert(mode)
        if size is not None:
            # The API takes (height, width) like ray.data.read_images;
            # PIL's resize wants (width, height).
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
    # Raw bytes + shape + dtype, as the JAX package keeps them;
    # decode_image(row) rebuilds the ndarray.
    cols = {"image": _object_column([arr.tobytes()]),
            "shape": np.asarray([arr.shape], dtype=np.int64),
            "dtype": _object_column([str(arr.dtype)])}
    if include_paths:
        cols["path"] = _object_column([f])
    return cols


def read_images(paths, *, include_paths: bool = False, mode: str | None = None,
                size: tuple | None = None) -> Dataset:
    """Decode image files into {"image", "shape", "dtype"} rows (parity:
    data/_internal/datasource/image_datasource.py; PIL decodes each
    file)."""
    return _make_read(paths, functools.partial(
        _read_image_file, include_paths, mode, size), "ReadImages")


def decode_image(row: dict):
    """Rebuild the HWC ndarray from a read_images row."""
    return np.frombuffer(row["image"], dtype=row["dtype"]).reshape(
        [int(s) for s in row["shape"]])


# ---------------- from_torch ----------------


def _torch_plain(v):
    """A torch item as block values: a tensor as a numpy array (a 0-d one
    as its Python scalar), tuples and lists item by item."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
        return v.item() if v.ndim == 0 else v
    if isinstance(v, (tuple, list)):
        return [_torch_plain(x) for x in v]
    return v


def _read_torch_range(ds_ref, lo: int, hi: int) -> dict:
    ds = ray_tpu_torch.get(ds_ref, timeout=120)
    return block_from_rows([{"item": _torch_plain(ds[i])}
                            for i in range(lo, hi)])


def from_torch(torch_dataset, *, override_num_blocks: int | None = None
               ) -> Dataset:
    """Ingest a torch map-style Dataset (parity: ray.data.from_torch): one
    row per item, under the "item" column.

    Lazy like the file readers: the dataset is put into the object store
    once and each read task materializes an index range, so the driver
    never holds the rows (the dataset object must pickle: by reference,
    where cloudpickle is missing)."""
    n = len(torch_dataset)
    k = override_num_blocks or min(
        DataContext.get_current().read_parallelism, max(n, 1))
    bounds = [(n * i // k, n * (i + 1) // k) for i in range(k)]
    ds_ref = ray_tpu_torch.put(torch_dataset)
    return Dataset(plan_mod.LogicalPlan(
        [plan_mod.Read(name="ReadTorch", read_fns=[
            functools.partial(_read_torch_range, ds_ref, lo, hi)
            for lo, hi in bounds if hi > lo])]))


# ---------------- sinks ----------------


def _write_block(block, path: str, index: int, fmt: str) -> str:
    out = os.path.join(path, f"part-{index:05d}.{fmt}")
    if fmt == "tfrecord":
        tfr.write_records(out, (tfr.encode_example(
            {k: v for k, v in row.items() if v is not None})
            for row in BlockAccessor(block).to_rows()))
    elif fmt == "avro":
        avro.write_file(out, avro.schema_for_block(block),
                        BlockAccessor(block).to_rows())
    else:
        raise ValueError(f"unknown write format {fmt}")
    return out


write_block_task = ray_tpu_torch.remote(_write_block)
