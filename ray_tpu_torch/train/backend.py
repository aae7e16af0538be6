"""Framework backends for the train worker group.

Parity: reference `train/_internal/backend_executor.py:73` driving
`Backend.on_start` hooks (`train/backend.py` in the reference; torch's
`train/torch/config.py` runs `dist.init_process_group`). Counterpart of
`ray_tpu/train/backend.py`, whose JaxDistributedConfig joins the workers
into one jax runtime: here `TorchDistributedConfig` joins them into one
torch.distributed group, over which the port's meshes build.
"""

from __future__ import annotations


class Backend:
    """Worker-group framework hooks, executed inside each worker actor."""

    #: whether _make_group must mint a rendezvous address for the gang
    needs_coordinator: bool = False

    def on_worker_start(self, rank: int, world_size: int,
                        coordinator: str | None):
        """Called on every worker before the user loop starts."""

    def on_worker_shutdown(self):
        """Called when the worker group is torn down (best effort)."""


def rendezvous_address() -> str:
    """A torch.distributed rendezvous address on this host, for the
    process that binds it (a gang's rank 0): the loopback, as the port's
    runtime spans one host (a multi-node gang needs the interface other
    hosts reach, with the multi-node slice)."""
    import os
    import socket
    ip = "127.0.0.1"
    # Probe-bind BELOW the kernel's ephemeral floor: bind(0) mints a
    # port from the ephemeral range (net.ipv4.ip_local_port_range,
    # 32768+ by default), which any unrelated outgoing connection can
    # grab in the close -> torch-rebind window — the EADDRINUSE flake
    # on a busy host. A sub-ephemeral port can only lose a race to
    # another deliberate binder, and the pid-spread start keeps
    # concurrent gangs on disjoint probes.
    base, span = 20000, 8000
    start = (os.getpid() * 97) % span
    for off in range(512):
        port = base + (start + off) % span
        s = socket.socket()
        try:
            s.bind((ip, port))
        except OSError:
            s.close()
            continue
        s.close()
        return f"{ip}:{port}"
    s = socket.socket()  # range exhausted (pathological): old path
    s.bind((ip, 0))
    port = s.getsockname()[1]
    s.close()
    return f"{ip}:{port}"


# Set by the Trainer in each worker's environment: the GPUs one rank
# holds (a fraction when ranks share a card).
GPUS_PER_WORKER_ENV = "RAY_TPU_TORCH_TRAIN_GPUS_PER_WORKER"


def rank_gpus() -> float:
    """The GPUs this rank reserved (GPUS_PER_WORKER_ENV, 0 outside a
    trainer's worker). Raises RuntimeError when it reserved some and CUDA
    sees no device: such a rank must not go on on the CPU."""
    import os

    import torch
    gpus = float(os.environ.get(GPUS_PER_WORKER_ENV, "0") or 0)
    if gpus > 0 and not torch.cuda.device_count():
        raise RuntimeError(
            f"this rank reserved {gpus} GPU(s) but CUDA sees no device "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    return gpus


class TorchDistributedConfig(Backend):
    """One torch.distributed group over the worker group, the
    counterpart of the JAX package's JaxDistributedConfig. Pass as
    `Trainer(..., torch_config=TorchDistributedConfig())`; rank 0 mints
    the rendezvous address (tcp, on its host). `backend` None picks nccl
    when every rank holds a card of its own (GPUs per worker >= 1, CUDA
    present) and gloo on the CPU or when ranks share a card (NCCL refuses
    two ranks on one device). Over gloo, CUDA tensors take all-reduce,
    all-gather and broadcast (the calls the port's tp path uses); a probe
    that also ran all_gather_into_tensor and reduce_scatter_tensor on CUDA
    tensors over gloo hung. The port's `parallel.make_mesh` then builds
    over the group."""

    needs_coordinator = True

    def __init__(self, *, backend: str | None = None,
                 init_timeout_s: float = 120.0):
        self.backend = backend
        self.init_timeout_s = init_timeout_s

    def pick_backend(self) -> str:
        """nccl or gloo, as the class docstring says, from this rank's
        reservation; raises when the rank reserved GPUs and CUDA sees
        none (no quiet fall back to the CPU)."""
        if self.backend:
            return self.backend
        gpus = rank_gpus()
        return "nccl" if gpus >= 1 else "gloo"

    def on_worker_start(self, rank: int, world_size: int,
                        coordinator: str | None):
        if world_size <= 1 or coordinator is None:
            return
        import datetime

        import torch
        import torch.distributed as dist
        if dist.is_initialized():
            return
        backend = self.pick_backend()
        if backend == "nccl":
            torch.cuda.set_device(0)  # this rank's own card
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator}",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=self.init_timeout_s))

    def on_worker_shutdown(self):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
