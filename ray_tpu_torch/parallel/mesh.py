"""Device meshes over the dp/fsdp/pp/sp/tp/ep axes (counterpart of
`ray_tpu/parallel/mesh.py`).

PyTorch runs one process per device (SPMD under `torch.distributed`)
where the JAX package runs one controller over a `jax.sharding.Mesh`. The
names and the degree arithmetic are the JAX package's (`AXES`,
`MeshConfig.resolve`, `elastic_config`); the mesh itself is a
`torch.distributed.device_mesh.DeviceMesh` over the process group's ranks,
its dims named by `AXES`. Every rank calls `make_mesh` alike.

Axis conventions (scaling-book style):
- "dp"   pure data parallelism (gradient all-reduce)
- "fsdp" data parallelism + parameter/optimizer sharding (ZeRO-3)
- "tp"   tensor parallelism (heads, mlp and vocab split; Megatron's
         all-reduces)
- "sp"   sequence parallelism (each rank a contiguous block of every
         row; ring attention or Ulysses across the blocks)
- "ep"   expert parallelism (each rank moe_experts / ep experts; their
         outputs summed over ep)
- "pp"   pipeline stages (`parallel.pipeline.gpipe`); the model's layer
         stack has no stage axis, so under the model the pp ranks
         replicate the step, as the JAX package's step does
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees per axis; -1 on at most one axis = absorb remaining devices."""

    dp: int = 1
    fsdp: int = -1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [a for a, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def _ensure_group(n: int, device_type: str) -> None:
    """A default process group of `n` ranks: the caller's, or, for a mesh
    of one device and no group yet, a group of one in this process (an
    in-process store, no port), so one process runs the sharded code
    unchanged."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(
                f"the mesh has {n} devices but the process group has "
                f"{dist.get_world_size()} ranks")
        return
    if n != 1:
        raise RuntimeError(
            f"a mesh of {n} devices needs torch.distributed initialized "
            f"with world size {n}: every rank calls init_process_group "
            f"first")
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)


def make_mesh(config: MeshConfig | None = None, device="cuda",
              axis_names=AXES):
    """A DeviceMesh over every rank of the default process group, shaped
    by `config` (default: all ranks on fsdp), its dims named by
    `axis_names`. Without a process group, a one-device mesh makes a group
    of one. The device type is CUDA unless the caller asks for the CPU;
    each rank's card is `rank % device_count()` (several ranks may share
    one card over gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh on CUDA needs a CUDA device; pass "
                           "device='cpu' for a CPU mesh")
    world = dist.get_world_size() if dist.is_initialized() else 1
    config = config or MeshConfig(fsdp=world)
    sizes = config.resolve(world)
    _ensure_group(world, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    shape = tuple(sizes[a] for a in axis_names)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(config: MeshConfig, dcn_axes=("dp", "pp"),
                     device="cuda", num_nodes: int | None = None):
    """Multi-node mesh: the axes that cross nodes outermost, the rest
    within a node. Ranks are numbered node-major (torchrun's order), so
    with `dcn_axes` outermost only their traffic crosses nodes. The node
    count (default: world size / cards per node) must factor entirely into
    the dcn axes, otherwise an intra-node axis would be forced across
    nodes: that is refused rather than mis-laid, as the JAX package
    refuses it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_nodes is None:
        per_node = (torch.cuda.device_count()
                    if torch.device(device).type == "cuda" else world)
        num_nodes = max(1, world // max(per_node, 1))
    if num_nodes <= 1:
        return make_mesh(config, device=device)
    sizes = config.resolve(world)
    rem = num_nodes
    for a in dcn_axes:
        rem //= math.gcd(sizes[a], rem)
    if rem != 1:
        raise ValueError(
            f"{num_nodes} nodes do not factor into dcn axes "
            f"{({a: sizes[a] for a in dcn_axes})}; an intra-node axis "
            f"({[a for a in AXES if a not in dcn_axes]}) would cross nodes")
    order = tuple(dcn_axes) + tuple(a for a in AXES if a not in dcn_axes)
    return make_mesh(config, device=device, axis_names=order)


def elastic_config(config: MeshConfig, n_devices: int) -> MeshConfig:
    """Refit a mesh config to a new device count (the gang re-mesh after a
    worker/host death). Model-parallel axes (tp/sp/ep/pp) are baked into
    the program's shardings and kept fixed; the DATA axes (dp, fsdp)
    absorb the change — dp keeps the largest divisor of its old degree
    that fits, fsdp takes the rest. Raises if the model axes alone no
    longer fit (a tp=4 program cannot re-mesh onto 2 chips)."""
    model = 1
    for a in ("pp", "sp", "tp", "ep"):
        model *= max(getattr(config, a), 1)
    if n_devices % model:
        raise ValueError(
            f"cannot re-mesh onto {n_devices} devices: model axes need "
            f"multiples of {model} "
            f"(pp={config.pp} sp={config.sp} tp={config.tp} ep={config.ep})")
    data = n_devices // model
    old_dp = max(config.dp, 1)
    dp = math.gcd(old_dp, data)
    return dataclasses.replace(config, dp=dp, fsdp=data // dp)


def mesh_degrees(mesh) -> dict[str, int]:
    """{axis name: degree} of a DeviceMesh (any object with
    `mesh_dim_names` and a `shape` tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"expected a torch DeviceMesh with named dims "
                        f"(parallel.make_mesh), got {type(mesh).__name__}")
    return dict(zip(names, tuple(mesh.shape)))


def axis_group(mesh, axis: str):
    """The process group of `axis` (any of AXES: the data, tp, sp, ep and
    pp collectives run on it), or None where the mesh lacks the axis or
    its degree is 1 (nothing to communicate)."""
    if mesh is None or mesh_degrees(mesh).get(axis, 1) == 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 where the mesh lacks it)."""
    if mesh is None or axis not in mesh_degrees(mesh):
        return 0
    return mesh.get_local_rank(axis)


_current_mesh = None


def set_global_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh


def get_abstract_mesh():
    return _current_mesh
