"""TorchTrainer: the reference's flagship trainer surface, on this runtime.

Parity: reference `train/torch/torch_trainer.py:11` (TorchTrainer),
`train/torch/config.py` (TorchConfig -> dist.init_process_group) and
`train/torch/train_loop_utils.py` (prepare_model / prepare_data_loader).

Counterpart of `ray_tpu/train/torch/__init__.py`: the reference's torch
loops (gloo DDP across worker actors) on the port's runtime, beside the
port's own Trainer; `get_device()` is the rank's card where it holds one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ray_tpu_torch.train.backend import Backend, rank_gpus
from ray_tpu_torch.train.trainer import (
    RunConfig,
    ScalingConfig,
    Trainer,
)


@dataclasses.dataclass
class TorchConfig(Backend):
    """Parity: train/torch/config.py TorchConfig."""

    backend: str = "gloo"          # CPU image: gloo (nccl has no place here)
    init_timeout_s: float = 120.0

    needs_coordinator = True

    def on_worker_start(self, rank: int, world_size: int,
                        coordinator: str | None):
        if world_size <= 1 or coordinator is None:
            return  # single worker: no process group needed
        import datetime

        import torch.distributed as dist
        if dist.is_initialized():
            return
        dist.init_process_group(
            backend=self.backend,
            init_method=f"tcp://{coordinator}",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=self.init_timeout_s))

    def on_worker_shutdown(self):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


class TorchTrainer(Trainer):
    """Same controller/worker-group/failure machinery as Trainer, with a
    torch process-group backend set up before the user loop."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: dict | None = None,
                 torch_config: TorchConfig | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 resume_from_checkpoint=None):
        super().__init__(train_loop_per_worker,
                         train_loop_config=train_loop_config,
                         scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.backend = torch_config or TorchConfig()


def get_device():
    """Parity: ray.train.torch.get_device: the rank's card (its
    CUDA_VISIBLE_DEVICES' first) where it reserved GPUs, else the CPU;
    raises when it reserved GPUs and CUDA sees none (`rank_gpus`)."""
    import torch
    return (torch.device("cuda", 0) if rank_gpus() > 0
            else torch.device("cpu"))


def prepare_model(model, *, wrap_ddp: bool = True):
    """Wrap the model for the worker group (parity: train_loop_utils.py
    prepare_model): DDP when a multi-worker process group is up."""
    import torch.distributed as dist
    if wrap_ddp and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        return DistributedDataParallel(model)
    return model


class _EpochSteppingLoader:
    """DataLoader wrapper that bumps DistributedSampler.set_epoch on every
    full iteration, so multi-epoch loops reshuffle per epoch without the
    user having to call set_epoch themselves (the reference's
    prepare_data_loader wraps the iterator the same way)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0

    def __iter__(self):
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


def prepare_data_loader(data_loader):
    """Shard a DataLoader across the worker group with a DistributedSampler
    (parity: train_loop_utils.py prepare_data_loader).

    Loaders that already carry a custom sampling scheme are left alone: a
    batch_sampler= loader (batch_size is None) or a non-default sampler
    (e.g. WeightedRandomSampler) cannot be re-sharded without changing the
    user's sampling distribution."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import (
        DataLoader,
        RandomSampler,
        SequentialSampler,
    )
    from torch.utils.data.distributed import DistributedSampler
    if data_loader.batch_size is None:  # batch_sampler= construction
        return data_loader
    if not isinstance(data_loader.sampler,
                      (RandomSampler, SequentialSampler)):
        return data_loader  # custom sampler: keep the user's distribution
    shuffle = isinstance(data_loader.sampler, RandomSampler)
    sampler = DistributedSampler(data_loader.dataset,
                                 num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank(), shuffle=shuffle)
    kw = dict(
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        pin_memory=data_loader.pin_memory,
        drop_last=data_loader.drop_last,
        timeout=data_loader.timeout,
        worker_init_fn=data_loader.worker_init_fn,
        generator=data_loader.generator,
        persistent_workers=data_loader.persistent_workers,
        multiprocessing_context=data_loader.multiprocessing_context,
    )
    if data_loader.num_workers > 0:  # only valid with loader workers
        kw["prefetch_factor"] = data_loader.prefetch_factor
    loader = DataLoader(data_loader.dataset, **kw)
    return _EpochSteppingLoader(loader, sampler)


__all__ = ["TorchTrainer", "TorchConfig", "get_device", "prepare_model",
           "prepare_data_loader"]
