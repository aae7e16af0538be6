"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model, kernel,
LLM-serving and training stack, for one NVIDIA H100.

Module names mirror the JAX package (`ray_tpu.ops`, `ray_tpu.models`,
`ray_tpu.llm`, `ray_tpu.train`) so each counterpart is easy to find. The package imports
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


__all__ = ["resolve_device"]
