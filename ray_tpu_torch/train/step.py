"""Train step construction (counterpart of `ray_tpu/train/step.py`).

`make_train_step` keeps the JAX package's signature and its return tuple
(init_fn, step_fn, compile_for, param_shardings). The step is PyTorch's
eager autograd plus the optimizer; `compile_for` returns the step itself.

On one device (`mesh=None`) there are no shardings. Under a mesh
(`parallel.make_mesh`; every rank builds the step and calls it alike)
`init_fn` places the params by the declared specs of `param_axes` and the
rules as DTensors, the AdamW moments mirror them, and `step_fn` hands the
loss function this rank's rows of the batch (the batch is placed on
("dp", "fsdp")) and, under sp, its block of the sequence; the model
gathers each layer over the data axes before use and the gradients come
back summed over them and over sp (models/transformer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.mesh import axis_rank, mesh_degrees
from ray_tpu_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                             declared_param_specs,
                                             local_shard, place, tree_map)
from ray_tpu_torch.train.optim import AdamW, shard_grads


@dataclasses.dataclass
class TrainState:
    params: Any                     # tree of leaf tensors (requires_grad)
    opt_state: torch.optim.Optimizer  # holds the moments of every leaf
    step: torch.Tensor              # 0-d int32 on the params' device


def sequence_block(batch: dict, mesh) -> dict:
    """This rank's contiguous block of every row under the mesh's sp
    degree (the rules table's "seq" -> "sp"): "inputs", "targets" and
    "mask" [b, s] cut along the sequence, a "tokens" [b, s + 1] batch
    shifted into inputs and targets before the cut. s must divide by sp
    (ValueError)."""
    sp = mesh_degrees(mesh).get("sp", 1)
    batch = dict(batch)
    if "tokens" in batch:
        tokens = batch.pop("tokens")
        batch["inputs"], batch["targets"] = tokens[:, :-1], tokens[:, 1:]
    s = batch["inputs"].shape[1]
    if s % sp:
        raise ValueError(f"a sequence of {s} positions does not cut into "
                         f"sp={sp} equal blocks")
    r = axis_rank(mesh, "sp")
    return {k: v[:, r * (s // sp):(r + 1) * (s // sp)]
            if k in ("inputs", "targets", "mask") else v
            for k, v in batch.items()}


def make_train_step(loss_fn: Callable, optimizer: AdamW, mesh=None,
                    param_axes=None, rules: ShardingRules | None = None,
                    batch_spec: tuple | None = None, device="cuda"):
    """Returns (init_fn, step_fn, compile_for, param_shardings).

    loss_fn(params, batch) -> fp32 scalar tensor; under a mesh it gets this
    rank's rows of the batch and returns the global batch's loss (the
    model's `loss_fn(..., mesh=mesh)` does). Under sp > 1 it gets this
    rank's contiguous block of every row (`sequence_block`): a
    {"tokens": [b, s + 1]} batch is shifted into "inputs" and "targets"
    first, and s must divide by sp (ValueError). `param_axes` is the
    logical-axis tree of the params, read under a mesh, where
    `param_shardings` is the tree of their NamedShardings (None without a
    mesh) and `compile_for.state_shardings(state)` the TrainState of
    shardings a restore lands in. `batch_spec` defaults to
    (("dp", "fsdp"),).

    step_fn(state, batch) -> (state, loss) updates the state in place (the
    port's counterpart of donation: no second copy of params or moments).
    `loss` is a 0-d tensor on the device: the step reads nothing back to
    the host. Batch tensors are moved to `device` (CUDA unless the caller
    asks for the CPU); under a mesh that is the mesh's device type."""
    dev = resolve_device(device)
    param_shardings = None
    if mesh is not None:
        sp = mesh_degrees(mesh).get("sp", 1)
        if param_axes is None:
            raise ValueError("make_train_step over a mesh needs param_axes")
        specs = declared_param_specs(param_axes, rules)
        param_shardings = tree_map(lambda s: NamedSharding(mesh, s), specs)
        batch_spec = batch_spec if batch_spec is not None else (
            ("dp", "fsdp"),)

    def init_fn(params) -> TrainState:
        """The state takes the params over: they become leaf tensors on
        the device (under a mesh: DTensors placed by the declared specs)
        that step_fn updates in place. Under a mesh every rank passes the
        same full params."""
        if mesh is None:
            params = tree_map(
                lambda t: t.detach().to(dev).requires_grad_(True), params,
                is_leaf=lambda t: not isinstance(t, dict))
        else:
            params = tree_map(
                lambda t, s: place(t.detach().to(dev), s).requires_grad_(
                    True),
                params, param_shardings,
                is_leaf=lambda t: not isinstance(t, dict))
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def step_fn(state: TrainState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        if mesh is not None:
            batch = {k: local_shard(v, mesh, batch_spec)
                     for k, v in batch.items()}
            if sp > 1:
                batch = sequence_block(batch, mesh)
        opt = state.opt_state
        loss = loss_fn(state.params, batch)
        loss.backward()
        if mesh is not None:
            shard_grads(state.params, opt)
        opt.step()
        opt.zero_grad(set_to_none=True)   # no grads live between steps
        state.step.add_(1)
        return state, loss.detach()

    def state_shardings(state: TrainState) -> TrainState:
        """The TrainState of shardings for THIS mesh: params and both AdamW
        moments by the declared specs, the step counts replicated (the
        restore target of the elastic re-mesh path)."""
        repl = NamedSharding(mesh, ())
        return TrainState(
            params=param_shardings,
            opt_state={"exp_avg": param_shardings,
                       "exp_avg_sq": param_shardings, "step": repl},
            step=repl)

    def compile_for(state: TrainState, sample_batch):
        """The step runs eagerly, nothing to compile."""
        return step_fn

    if mesh is not None:
        compile_for.state_shardings = state_shardings
    return init_fn, step_fn, compile_for, param_shardings
