"""Carry weights between the JAX package and the port.

`params_from_numpy` takes the JAX package's parameter tree (nested dicts
and lists) as numpy arrays
(e.g. `jax.tree.map(np.asarray, params)`) and returns the port's tree of
tensors; `params_to_numpy` is the inverse. bfloat16 crosses bit-exactly
through a uint16 view, without importing ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch import resolve_device


def tree_map(fn, tree):
    """fn over the leaves of a tree of dicts, lists and tuples (the RL
    modules keep their layers in lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device="cuda", dtype=None) -> dict:
    """tree (nested dicts and lists) of numpy arrays -> the same tree of
    tensors on `device` (cast to `dtype` when given). The input arrays are
    copied, never aliased."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(a).view(np.uint16).copy()
            t = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(conv, tree)


def params_to_numpy(params) -> dict:
    """tree of tensors -> the same tree of numpy arrays. bfloat16 tensors
    come back as numpy bfloat16 arrays, which needs the numpy bfloat16
    dtype to be registered by some library already loaded (ml_dtypes, as
    jax loads)."""

    def conv(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy().copy()
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError(
                "no numpy bfloat16 dtype is registered in this process "
                "(import ml_dtypes or jax first)") from e
        return t.view(torch.int16).numpy().view(np.uint16).copy().view(bf16)

    return tree_map(conv, params)
