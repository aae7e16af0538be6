"""Parallelism layer (counterpart of `ray_tpu.parallel`): device meshes
over the named axes, logical-axis sharding rules placed as DTensors, the
collectives, sequence parallelism (ring attention, Ulysses) and pipeline
stages (GPipe). One process per device under `torch.distributed`; entry
points under a mesh expect every rank to call them alike, each with its
own blocks."""

from ray_tpu_torch.parallel.mesh import (AXES, MeshConfig, elastic_config,
                                         get_abstract_mesh, make_hybrid_mesh,
                                         make_mesh, set_global_mesh)
from ray_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardingRules,
    logical_to_physical,
    placements,
    reshard,
    shard_params,
    with_sharding,
)
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "AXES", "MeshConfig", "make_mesh", "make_hybrid_mesh", "elastic_config",
    "get_abstract_mesh", "set_global_mesh", "ShardingRules",
    "NamedSharding", "placements", "logical_to_physical", "shard_params",
    "reshard", "with_sharding", "ring_attention", "ulysses_attention",
]
