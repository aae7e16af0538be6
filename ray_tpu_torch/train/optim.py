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
        that require grad; `step()` updates them in place."""
        return torch.optim.AdamW(
            tree_leaves(params), lr=self.learning_rate,
            betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """`optax.adamw`'s signature and defaults."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
