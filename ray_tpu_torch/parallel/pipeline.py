"""Pipeline parallelism: the GPipe microbatch schedule over the "pp" mesh
axis (counterpart of `ray_tpu/parallel/pipeline.py`).

The JAX package runs the schedule as one program under `shard_map`: the
stage params cut over "pp", activations passed between stages by
`jax.lax.ppermute` inside a `lax.scan`, and autodiff through the scan
giving the backward schedule. The port runs one process per stage: each
rank holds its stage's params, the same tick loop runs on every rank with
one `collectives.ppermute` exchange a tick, and autograd through the
loop and through `ppermute`'s backward (the cotangent sent back along the
inverse permutation) gives the backward schedule.

Every rank runs the same graph, as the JAX program does: a stage selects
its feed and banks its output with `torch.where` on its stage index,
where the JAX package uses `lax.cond` and `jnp.where`, and forwards zeros
on its inactive ticks. So every rank uses every exchange's result that a
gradient reaches, and issues the same backward exchanges in the same
order; a Python branch on the stage would leave a rank's backward
exchange out and deadlock its neighbours.

Schedule: plain GPipe, M microbatches through S stages in M + S - 1
ticks; bubble fraction (S - 1) / (M + S - 1).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import ppermute, psum, ring_perm
from ray_tpu_torch.parallel.mesh import axis_group, mesh_degrees


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def gpipe_inner(stage_fn, stage_params, microbatches, group,
                num_stages: int):
    """The schedule on this rank, its stage its place in `group` (the pp
    axis's process group; None for one stage).

    stage_fn: (params, x) -> y, the per-stage computation; y has x's
      shape and dtype (stage s + 1 takes stage s's output).
    stage_params: this stage's params (the stage axis removed).
    microbatches: [M, ...] every microbatch's input (the same on every
      rank; only stage 0 reads them).
    Returns [M, ...] stage outputs, the last stage's (zeros elsewhere)."""
    import torch.distributed as dist
    stage = 0 if group is None else dist.get_rank(group)
    m = microbatches.shape[0]
    perm = ring_perm(num_stages)
    dev = microbatches.device
    yes, no = (torch.tensor(b, device=dev) for b in (True, False))
    first = yes if stage == 0 else no
    zeros = torch.zeros_like(microbatches[0])
    out_buf = [zeros] * m
    incoming = zeros
    for t in range(m + num_stages - 1):
        mb_idx = t - stage          # the microbatch this stage works on
        at = min(max(mb_idx, 0), m - 1)
        active = 0 <= mb_idx < m
        # stage 0 reads the input queue, the others the wire
        feed = torch.where(first, microbatches[at], incoming)
        y = stage_fn(stage_params, feed)
        y = torch.where(yes if active else no, y, zeros)
        # the last stage banks its result; every stage forwards its own
        bank = active and stage == num_stages - 1
        out_buf[at] = torch.where(yes if bank else no, y, out_buf[at])
        incoming = ppermute(y, group, perm)
    return torch.stack(out_buf)


def gpipe(stage_fn, stacked_params, microbatches, mesh,
          axis_name: str = "pp"):
    """GPipe over the mesh axis `axis_name` (every rank of the mesh calls
    alike). `stacked_params`: this rank's block of the params stacked on
    a leading stage axis cut over pp (the JAX package's P("pp") in_spec:
    the block of one stage, leading axis 1); a tree of tensors.
    `microbatches`: [M, ...], the same on every rank. Returns [M, ...],
    the last stage's outputs on every rank (summed over pp, the other
    stages contributing zeros). `mesh` None is one stage."""
    s = 1 if mesh is None else mesh_degrees(mesh).get(axis_name, 1)
    group = axis_group(mesh, axis_name)
    params = _tree_map(lambda x: x[0], stacked_params)  # drop stage axis
    out = gpipe_inner(stage_fn, params, microbatches, group, s)
    return psum(out, group)
