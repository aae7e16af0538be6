"""Collective communication between actors/tasks outside the object path
(counterpart of `ray_tpu/util/collective/`, on numpy arrays and torch
tensors on the CPU or a card).

Parity: reference `python/ray/util/collective/collective.py:123`
(init_collective_group, allreduce:268, barrier, reduce, broadcast,
allgather, reducescatter, send/recv) with its NCCL
(`collective_group/nccl_collective_group.py:128`) and GLOO
(`gloo_collective_group.py:184`) backends.

Port stance: dense-math communication inside a model runs on
`torch.distributed` (`ray_tpu_torch.parallel.collectives`). This module
is the HOST-side backend, the analogue of the reference's GLOO group,
used for control-plane exchange (weight broadcast to env-runners, metric
reduction, rendezvous): contributions ride the head KV, with
KV-sequenced rendezvous. A CUDA tensor crosses through the host and its
result is written back into it in place on its own card.
"""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    join_group,
    recv,
    reduce,
    reducescatter,
    send,
)
