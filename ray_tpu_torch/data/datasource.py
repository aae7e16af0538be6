"""File datasources that need no pyarrow (counterpart of the first part of
`ray_tpu/data/datasource.py`).

Parity: reference `data/_internal/datasource/` (text, binary and numpy
readers, one read task per file). Each read task is a `functools.partial`
of a module-level reader over one path: it travels by reference.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np

from ray_tpu_torch.data import plan as plan_mod
from ray_tpu_torch.data.block import _object_column, block_from_batch
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
