"""Tensor-parallel collectives (the part of `ray_tpu/parallel/
collectives.py` this slice needs).

Megatron's pair of conjugate operators over the mesh's "tp" group, as
autograd Functions, and the vocab gather:
- `copy_to_tp`: identity forward, all-reduce backward (at the input of a
  column-parallel product: each rank's gradient of the shared input is a
  partial sum);
- `reduce_from_tp`: all-reduce forward, identity backward (after a
  row-parallel product: each rank holds a partial sum of the output);
- `gather_from_tp`: all-gather along the last dim forward, the rank's
  slice backward (vocab-parallel logits to full ones);
- `gather_weight_tp`: a param block all-gathered along a dim, for
  attention that tp does not split by whole heads; its backward is the
  rank's slice of the gradient, summed over the group first where ranks
  share the weight's columns (a kv head replicated over several ranks).
A group of None (no mesh, or tp = 1) makes each an identity, so the
one-device path is unchanged. The collectives are `torch.distributed`'s,
on whatever backend the process group runs (NCCL, or gloo, which takes
CUDA tensors through the host). The ring, all-to-all and pipeline
collectives of the JAX module come with the sp/ep/pp slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grad):
        ctx.group, ctx.dim, ctx.sum_grad = group, dim, sum_grad
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherTP.apply(x, group, -1, False)


def gather_weight_tp(w: torch.Tensor, group, dim: int,
                     sum_grad: bool) -> torch.Tensor:
    """The whole of a param split over tp along `dim`. `sum_grad`: each
    rank's gradient of the whole is a partial sum (the ranks use
    different parts of it), so the backward sums it over the group before
    each rank takes its slice; else every rank computes the same whole
    gradient and takes its slice as it is."""
    return w if group is None else _GatherTP.apply(w, group, dim, sum_grad)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of `x` over the group (no gradient)."""
    if group is None:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum of `x` over each group of `groups` in turn (no gradient): over
    the dp and the fsdp groups, the sum over the data-parallel ranks."""
    x = x.detach().contiguous().clone()
    for g in groups:
        if g is not None:
            dist.all_reduce(x, group=g)
    return x
