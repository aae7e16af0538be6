"""Offline RL data: record rollouts to files and load them back,
counterpart of the JAX package's `rllib/offline.py` (parity: the
reference's `rllib/offline/` writers and readers feeding BC, MARWIL and
CQL).

Rows are flat transitions {obs, actions, rewards, next_obs, dones} of
Python lists and scalars, so the two packages read each other's files.
JSON lines need numpy only; Parquet imports pyarrow on use (the data
library's rule: pyarrow only at the edges).
"""

from __future__ import annotations

import glob as _glob
import json
import os

import numpy as np


def _pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as e:
        raise ImportError("offline Parquet files need pyarrow, which is not "
                          "installed; use fmt='json' (JSON lines)") from e
    return pyarrow


def record_transitions(env_name: str, module, params, *, num_steps: int,
                       path: str | None = None, fmt: str = "parquet",
                       seed: int = 0, env_config: dict | None = None,
                       explore: bool = True):
    """Roll `module` (with `params`, numpy or tensors) in `env_name` on a
    local CPU runner and record flat transitions {obs, actions, rewards,
    next_obs, dones}.

    Returns the row list; with `path`, also writes one Parquet or JSON
    lines file (the reference's output writer shape). `explore=False`
    records the greedy actions.
    """
    from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    runner = SingleAgentEnvRunner(env_name, module, seed=seed,
                                  env_config=env_config)
    frag = runner.sample(params, num_steps, explore=explore)
    actions_2d = getattr(module, "action_kind", "discrete") == "continuous"
    cols = Algorithm._replay_rows(frag, actions_2d=actions_2d)
    n = len(cols["obs"])
    rows = [{k: cols[k][i].tolist() if cols[k][i].ndim else cols[k][i].item()
             for k in cols} for i in range(n)]
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if fmt == "parquet":
            pa = _pyarrow()
            pa.parquet.write_table(pa.Table.from_pylist(rows), path)
        elif fmt == "json":
            with open(path, "w") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
        else:
            raise ValueError(f"unknown offline format {fmt!r}")
    return rows


def load_offline(input_):
    """Any offline input as a row list: a list of dicts, a
    `ray_tpu_torch.data` Dataset, or a path or glob of Parquet or JSON
    lines files (parity: the reference's `input_` accepting dataset
    paths)."""
    if input_ is None:
        return None
    if isinstance(input_, list):
        return input_
    if hasattr(input_, "take_all"):  # a ray_tpu_torch.data Dataset
        return input_.take_all()
    if isinstance(input_, str):
        paths = sorted(_glob.glob(input_)) or [input_]
        rows = []
        for p in paths:
            if p.endswith(".parquet"):
                rows.extend(_pyarrow().parquet.read_table(p).to_pylist())
            else:
                with open(p) as f:
                    rows.extend(json.loads(line) for line in f
                                if line.strip())
        return rows
    raise TypeError(f"cannot load offline input of type {type(input_)}")


def rows_to_arrays(rows: list[dict], *, continuous: bool = False) -> dict:
    """Columnar numpy arrays of a row list for replay and minibatching."""
    out = {
        "obs": np.asarray([r["obs"] for r in rows], np.float32),
        "rewards": np.asarray([r.get("rewards", 0.0) for r in rows],
                              np.float32),
        "dones": np.asarray([r.get("dones", 0.0) for r in rows], np.float32),
    }
    acts = [r["actions"] for r in rows]
    out["actions"] = (np.asarray(acts, np.float32) if continuous
                      else np.asarray(acts, np.int64))
    if rows and "next_obs" in rows[0]:
        out["next_obs"] = np.asarray([r["next_obs"] for r in rows],
                                     np.float32)
    return out
