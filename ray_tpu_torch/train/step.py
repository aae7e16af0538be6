"""Train step construction (counterpart of `ray_tpu/train/step.py`).

`make_train_step` keeps the JAX package's signature and its return tuple
(init_fn, step_fn, compile_for, param_shardings). On one device the step
is PyTorch's eager autograd plus the optimizer: `compile_for` returns the
step itself and there are no shardings. A mesh of more than one device is
the sharded slice of the port (`parallel/mesh.py`, `parallel/sharding.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.transformer import check_single_device
from ray_tpu_torch.train.optim import AdamW, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any                     # tree of leaf tensors (requires_grad)
    opt_state: torch.optim.Optimizer  # holds the moments of every leaf
    step: torch.Tensor              # 0-d int32 on the params' device


def make_train_step(loss_fn: Callable, optimizer: AdamW, mesh=None,
                    param_axes=None, device="cuda"):
    """Returns (init_fn, step_fn, compile_for, param_shardings).

    loss_fn(params, batch) -> fp32 scalar tensor. `param_axes` (the
    logical-axis tree) matters only on a mesh of more than one device,
    which raises NotImplementedError in this slice.

    step_fn(state, batch) -> (state, loss) updates the state in place (the
    port's counterpart of donation: no second copy of params or moments).
    `loss` is a 0-d tensor on the device: the step reads nothing back to
    the host. Batch tensors are moved to `device` (CUDA unless the caller
    asks for the CPU)."""
    check_single_device(mesh, "make_train_step")
    dev = resolve_device(device)

    def init_fn(params) -> TrainState:
        """The state takes the params over: they become leaf tensors on
        the device that step_fn updates in place."""
        params = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                          params)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def step_fn(state: TrainState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        opt = state.opt_state
        loss = loss_fn(state.params, batch)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)   # no grads live between steps
        state.step.add_(1)
        return state, loss.detach()

    def compile_for(state: TrainState, sample_batch):
        """One device: the step runs eagerly, nothing to compile."""
        return step_fn

    return init_fn, step_fn, compile_for, None
