"""Transformer layer ops (counterpart of `ray_tpu/ops/layers.py`).

Plain PyTorch on purpose, as in the JAX package: RMSNorm/RoPE/SwiGLU are
bandwidth-bound elementwise chains around the matmuls. fp32 where the
reference accumulates in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, weight, eps: float = 1e-6):
    """fp32 math, output in the input dtype."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def rope(positions, head_dim: int, theta: float = 10000.0):
    """Rotary tables in float32. positions: [..., seq] -> (sin, cos) each
    [..., seq, head_dim/2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """Half-split rotation. x: [batch, seq, heads, head_dim]; sin/cos:
    [batch?, seq, head_dim/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:  # [seq, half] -> broadcast over batch
        sin = sin[None]
        cos = cos[None]
    sin = sin[:, :, None, :]  # [batch, seq, 1, half]
    cos = cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """silu(x@Wg) * (x@Wu) @ Wd, outputs in x.dtype."""
    g = torch.einsum("bse,ef->bsf", x, w_gate)
    u = torch.einsum("bse,ef->bsf", x, w_up)
    return torch.einsum("bsf,fe->bse", F.silu(g) * u, w_down)
