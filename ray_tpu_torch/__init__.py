"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu: its core runtime
(tasks, actors, objects, resources; `init`, `remote`, `get`, ...) and its
model, kernel, LLM-serving and training stack, for NVIDIA H100s.

Module names mirror the JAX package (`ray_tpu.core`, `ray_tpu.ops`,
`ray_tpu.models`, `ray_tpu.llm`, `ray_tpu.train`) so each counterpart is
easy to find. The package imports
torch and numpy only: never jax, never anything of `ray_tpu` (it keeps its
own copies of the pure-data modules it needs).

Every TPU kernel on the ported path is a CUDA C++ kernel written for
Hopper (`ops/csrc/*.cu`), built with nvcc at first use. Entry points run
on the card unless the caller passes `device="cpu"`; there they take each
kernel's plain PyTorch version.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA on a host without a card raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:  # "cuda" -> the current card, as tensors say
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from ray_tpu_torch._version import version as __version__  # noqa: E402
from ray_tpu_torch.core.api import (  # noqa: E402
    available_resources,
    cancel,
    cluster_resources,
    cpp_function,
    get,
    get_actor,
    get_node_id,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch.core.status import (  # noqa: E402
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)

from ray_tpu_torch import util  # noqa: E402,F401  (parity: ray.util)
from ray_tpu_torch import data  # noqa: E402,F401  (parity: ray.data)

__all__ = [
    "resolve_device", "__version__", "init", "shutdown", "is_initialized",
    "remote", "method", "get", "put", "wait", "kill", "cancel",
    "get_actor", "cluster_resources", "cpp_function",
    "available_resources", "nodes", "get_node_id", "timeline", "ObjectRef",
    "RayTpuError", "TaskError", "TaskCancelledError", "ActorDiedError",
    "WorkerCrashedError", "ObjectLostError", "GetTimeoutError", "util",
    "data",
]
