"""AdamW as the JAX package uses it (`optax.adamw`).

`adamw(...)` takes optax's arguments and defaults (weight decay 1e-4, not
torch's 1e-2) and builds a `torch.optim.AdamW` over the leaf tensors of a
parameter tree. The two update rules are the same: moments in the param
dtype, bias-corrected m / (sqrt(v) + eps), and decoupled decay of every
leaf (optax's unmasked `adamw`) by lr * weight_decay * param.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in sorted-key order (a fixed order, so
    an optimizer's state lines up with the tree it was built over)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def local_leaves(params) -> list:
    """The tensors an optimizer updates: each leaf of the tree, a DTensor's
    local shard in its place (the same tensor object, aliasing the
    DTensor's storage)."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        return [p.to_local() if isinstance(p, DTensor) else p
                for p in tree_leaves(params)]


def shard_grads(params, opt: torch.optim.Optimizer) -> None:
    """Give each local shard the optimizer holds (`local_leaves`) the
    local block of its DTensor param's gradient, and clear the DTensor's
    (no gradient lives between steps)."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        for p, loc in zip(tree_leaves(params), opt.param_groups[0]["params"],
                          strict=True):
            if isinstance(p, DTensor):
                loc.grad = None if p.grad is None else p.grad.to_local()
                p.grad = None


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optimizer's hyperparameters; `init(params)` makes its state."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.AdamW:
        """A torch AdamW over the tree's leaves, which must be leaf tensors
        that require grad; `step()` updates them in place. A DTensor leaf
        (a param placed on a mesh) enters as its local shard, the same
        storage: AdamW is elementwise, so each rank updates its own shard,
        its moments shaped and placed like it, with no collective and no
        sharding propagation (whose cost grows with the mesh's dims);
        `shard_grads` hands each shard its gradient before `step()`. The
        moments exist from the start, zeros like each leaf, as optax's
        init makes them, so a fresh state can take a checkpoint in."""
        leaves = local_leaves(params)
        opt = torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay)
        with torch.no_grad():
            for p in leaves:
                opt.state[p] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}
        return opt


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """`optax.adamw`'s signature and defaults."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
