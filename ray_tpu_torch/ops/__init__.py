"""Kernels (hand-written CUDA for Hopper) and layer ops.

Counterpart of `ray_tpu.ops`: the Pallas kernels of the JAX package become
CUDA C++ kernels under `csrc/`, each with its plain PyTorch version beside
it; the elementwise layer ops stay plain PyTorch.
"""

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.layers import apply_rope, rmsnorm, rope, swiglu
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_verify_attention,
    paged_verify_insert_attention)

__all__ = ["flash_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_verify_insert_attention",
           "rmsnorm", "rope", "apply_rope", "swiglu"]
