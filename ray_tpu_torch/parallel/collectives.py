"""Collectives (counterpart of `ray_tpu/parallel/collectives.py`).

The JAX package runs its collectives inside compiled programs over a mesh
axis (`jax.lax.psum`, `ppermute`, `all_to_all`, ...) and its control-plane
rendezvous over the runtime's KV. The port runs one process per device,
so a mesh axis is a `torch.distributed` process group (`parallel.mesh.
axis_group`) and each collective an autograd Function where it carries
gradients. A group of None (no mesh, or a degree of 1) makes each one an
identity on the rank's own data, so the one-device path is unchanged.

Megatron's pair of conjugate operators, and the vocab gather:
- `copy_to_tp`: identity forward, all-reduce backward (at the input of a
  column-parallel product, or of the experts under ep: each rank's
  gradient of the shared input is a partial sum);
- `reduce_from_tp` (= `psum`): all-reduce forward, identity backward
  (each rank holds a partial sum of the output and every rank computes
  the same loss from the sum);
- `gather_from_tp`: all-gather along the last dim forward, the rank's
  slice backward (vocab-parallel logits to full ones);
- `gather_weight_tp`: a param block all-gathered along a dim, for
  attention that tp does not split by whole heads; its backward is the
  rank's slice of the gradient, summed over the group first where ranks
  share the weight's columns (a kv head replicated over several ranks).
The sequence and pipeline collectives:
- `ppermute(x, group, perm)`: each rank sends its x to the ranks `perm`
  pairs it with and receives from its source (zeros where none sends);
  the backward sends the cotangent back along the inverse permutation;
- `all_to_all(x, group, split_dim, concat_dim)` (tiled, as the JAX
  package calls it): x split into group-size chunks along `split_dim`,
  chunk j to rank j, the chunks received concatenated along
  `concat_dim`; its backward is the all-to-all with the dims swapped;
- `reduce_scatter(x, group, scatter_dimension)`: the sum over the group,
  and the rank's tile of it along the dim (no gradient).
`Barrier` is the host-side rendezvous over the port runtime's atomic
`kv_incr`.

On the gloo backend (the card runs every multi-rank group as processes
over gloo: NCCL refuses two ranks on one device) all-reduce, all-gather
and broadcast take CUDA tensors. The rest is staged through host memory
here, named by the backend and not tried first:
- `ppermute`'s paired `isend`/`irecv` and `all_to_all`'s
  `all_to_all_single` copy a CUDA tensor to the host, exchange host
  tensors and copy the result back (gloo's point-to-point and all-to-all
  would read a device pointer as host memory);
- `reduce_scatter` on gloo is an all-reduce and the rank's slice: a
  probe of gloo's `reduce_scatter_tensor` on CUDA tensors hung.
The staging moves bytes and computes nothing on the host.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a point-to-point or all-to-all of `x` goes through host
    memory: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


# ---- Megatron's pair and the gathers ----


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


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group on every rank (`jax.lax.psum`). Its
    backward hands each rank the cotangent as it is: every rank computes
    the same loss from the replicated sum, so the gradient of a rank's own
    addend is that cotangent."""
    return reduce_from_tp(x, group)


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


# ---- the sequence and pipeline collectives ----


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """One exchange of `ppermute`: paired isend/irecv that every rank
    issues in the same order (the sends by destination, then the receive),
    through host memory where `_staged` says so."""
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: rank {me} receives from {srcs}")
    staged = _staged(x, group)
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[d], group) for d in dsts]
    ops += [dist.P2POp(dist.irecv, recv, ranks[s], group) for s in srcs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if staged else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """`jax.lax.ppermute` over the group: `perm` is a list of (source,
    destination) group ranks; a rank no pair sends to gets zeros. Every
    rank of the group must call it alike, and, where a gradient flows,
    use its result so that every rank runs the backward's exchange too.
    Without a group the one rank keeps its own x where (0, 0) is a pair."""
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, tuple(perm))


def ring_perm(n: int) -> list:
    """The ring shift i -> i + 1 (mod n) that the ring and the pipeline
    rotate by."""
    return [(i, (i + 1) % n) for i in range(n)]


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of a "
                         f"{tuple(x.shape)} tensor does not split {n} ways")
    # chunk j of the split dim leads, so all_to_all_single sends block j
    # of dim 0 to rank j and lays rank j's block at j of dim 0
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    staged = _staged(x, group)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g.contiguous(), ctx.group, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(..., tiled=True)` over the group."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def reduce_scatter(x: torch.Tensor, group,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """`jax.lax.psum_scatter(..., tiled=True)`: the sum of `x` over the
    group, cut into group-size tiles along `scatter_dimension`, this
    rank's tile. On gloo an all-reduce and the rank's slice (its
    `reduce_scatter_tensor` hung on CUDA tensors); elsewhere
    `reduce_scatter_tensor`."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[scatter_dimension] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} of a "
                         f"{tuple(x.shape)} tensor does not split {n} ways")
    x = x.detach()
    if dist.get_backend(group) == "gloo":
        full = x.contiguous().clone()
        dist.all_reduce(full, group=group)
        return full.chunk(n, dim=scatter_dimension)[
            dist.get_rank(group)].contiguous()
    send = x.movedim(scatter_dimension, 0).contiguous()
    out = send.new_empty((send.shape[0] // n,) + tuple(send.shape[1:]))
    dist.reduce_scatter_tensor(out, send, group=group)
    return out.movedim(0, scatter_dimension).contiguous()


# ---- host-side rendezvous over the runtime KV (control plane) ----


class Barrier:
    """N-party named barrier over the port runtime's head KV.

    Used by actor groups gang-entering an SPMD program: every member must
    arrive before any proceeds. Each arrival is the head's atomic
    `kv_incr` (a get-then-put would lose counts when members arrive
    concurrently)."""

    def __init__(self, name: str, world_size: int):
        self.name = name
        self.world_size = world_size
        self._round = 0

    def wait(self, timeout: float = 300.0):
        from ray_tpu_torch.core.runtime import Runtime, get_runtime
        rt = get_runtime()
        self._round += 1
        key = ("barrier", self.name, self._round)
        local = isinstance(rt, Runtime)

        def kv_read() -> int:
            if local:
                return int(rt.kv.get(key, b"0"))
            return int(rt.request("kv_get", key) or b"0")

        if local:
            rt.kv_incr(key)
        else:
            rt.request("kv_incr", key)
        deadline = time.monotonic() + timeout
        while kv_read() < self.world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"barrier {self.name} timed out")
            time.sleep(0.005)
