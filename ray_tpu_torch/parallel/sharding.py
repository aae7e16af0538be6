"""Logical-axis sharding rules -> placements (counterpart of
`ray_tpu/parallel/sharding.py`).

The scaling-book recipe, as the JAX package writes it: annotate arrays
with *logical* axis names ("batch", "seq", "embed", "mlp", "heads",
"vocab", "expert", ...), map those to mesh axes with a rules table. FSDP is
"embed -> fsdp on params + gather before use"; TP is "mlp/heads/vocab ->
tp". `ShardingRules.spec` gives the same axis tuple as the JAX package's
`PartitionSpec`; `placements` turns it into DTensor placements (one
`Shard(dim)` or `Replicate()` per mesh dim), and a `NamedSharding` pairs a
spec with its mesh as JAX's does. Params are placed as
`distribute_tensor` places them, each rank cutting its block of the full
tensor it holds; the model gathers them before use
(`models/transformer.py`).

No counterpart yet: `shard_map_compat` (the sp/pp entry points, a later
slice) and the `__graphcheck__` hook (there is no lowered graph to check
in eager PyTorch).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import mesh_degrees


@dataclasses.dataclass
class ShardingRules:
    """logical name -> mesh axis (or None = replicated)."""

    rules: dict[str, str | tuple[str, ...] | None]

    @classmethod
    def default(cls) -> "ShardingRules":
        return cls({
            # activations
            "batch": ("dp", "fsdp"),
            "seq": "sp",
            "embed_act": None,
            # params
            "embed": "fsdp",       # ZeRO-3: shard the "long" param axis
            "mlp": "tp",
            "heads": "tp",
            "kv_heads": "tp",
            "head_dim": None,
            "vocab": "tp",
            "expert": "ep",
            "stage": "pp",
        })

    def spec(self, logical_axes: tuple[str | None, ...]) -> tuple:
        """The mesh axes of each tensor dim: None, an axis, or a tuple of
        axes (the JAX package's PartitionSpec entries); a mesh axis is
        used once at most."""
        out = []
        used: set[str] = set()
        for name in logical_axes:
            axis = None if name is None else self.rules.get(name)
            if isinstance(axis, tuple):
                axis = tuple(a for a in axis if a not in used)
                used.update(axis)
                out.append(axis if axis else None)
            else:
                if axis in used:
                    axis = None
                if axis is not None:
                    used.add(axis)
                out.append(axis)
        return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_map(fn, *trees, is_leaf=_is_axes):
    """fn over the leaves of nested dicts (a logical-axes tree's leaves are
    tuples, so a tuple is a leaf)."""
    first = trees[0]
    if isinstance(first, dict) and not is_leaf(first):
        return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in first}
    return fn(*trees)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: Shard(d) on each mesh dim
    that tensor dim d is split over, Replicate() on the others. A dim split
    over several mesh dims is split in mesh-dim order (major to minor, as
    a PartitionSpec's tuple entry)."""
    names = list(mesh_degrees(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}, which "
                                 f"the mesh {tuple(names)} lacks")
            out[names.index(axis)] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's `NamedSharding(mesh, spec)`)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def logical_to_physical(rules: ShardingRules, logical_tree):
    """Map a tree of logical-axis tuples to a tree of specs."""
    return tree_map(rules.spec, logical_tree)


def declared_param_specs(param_axes, rules: ShardingRules | None = None):
    """THE declared param specs: the single table the train step places
    params and moments by."""
    return logical_to_physical(rules or ShardingRules.default(), param_axes)


def _check_divisible(x: torch.Tensor, spec: tuple, mesh) -> None:
    deg = mesh_degrees(mesh)
    for dim, entry in enumerate(spec):
        n = 1
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            n *= deg.get(axis, 1) if axis else 1
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does "
                             f"not divide over {entry} ({n} ways)")


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A full tensor (the same on every rank) as a DTensor with
    `sharding`; each tensor dim must divide over its mesh axes, as a
    NamedSharding requires in JAX. Each rank cuts its own block
    (`distribute_tensor` without the copy from rank 0, which every rank
    holding the same tensor makes redundant): no collective runs."""
    local = local_shard(x, sharding.mesh, sharding.spec).clone(
        memory_format=torch.contiguous_format)    # its own storage
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def shard_params(params, logical_tree, rules: ShardingRules, mesh):
    """Place a param tree (full tensors, identical on every rank) by its
    logical axes: a tree of DTensors."""
    specs = logical_to_physical(rules, logical_tree)
    return tree_map(lambda x, s: place(x, NamedSharding(mesh, s)), params,
                    specs, is_leaf=lambda t: not isinstance(t, dict))


def reshard(tree, shardings):
    """Move every leaf onto its sharding: a redistribute on the same mesh,
    through the full tensor onto another one (the elastic restore step:
    state of an N-device mesh onto an M-device mesh). `shardings` is a
    matching tree of NamedShardings."""
    def move(x, s):
        if isinstance(x, DTensor) and x.device_mesh == s.mesh:
            return x.redistribute(s.mesh, s.placements)
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return place(full, s)
    return tree_map(move, tree, shardings,
                    is_leaf=lambda t: not isinstance(t, dict))


def with_sharding(x, mesh, spec: tuple):
    """`x` laid out by `spec`: a DTensor is redistributed, a full tensor
    placed."""
    s = NamedSharding(mesh, spec)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, s.placements)
    return place(x, s)


def local_shard(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of a full tensor `x` (the same on every rank)
    under `spec`, cut locally with no communication: the batch a rank
    feeds its step."""
    _check_divisible(x, spec, mesh)
    deg = mesh_degrees(mesh)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None or deg.get(axis, 1) == 1:
                continue
            x = x.chunk(deg[axis], dim)[mesh.get_local_rank(axis)]
    return x


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the batch dimension of activations, in rule
    order, so layouts built from it agree with batch_spec = (("dp",
    "fsdp"),) on any mesh shape."""
    names = mesh_degrees(mesh)
    return tuple(a for a in ("dp", "fsdp") if a in names)


def activation_batch_sharded(x, mesh):
    """A [batch, ...] activation in the canonical layout: batch over the
    data axes, everything else replicated."""
    axes = data_axes(mesh)
    return with_sharding(x, mesh, (axes if axes else None,
                                   *([None] * (x.dim() - 1))))
