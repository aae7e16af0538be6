"""Llama-family decoder: RMSNorm + RoPE + GQA attention + SwiGLU (or MoE).

Counterpart of `ray_tpu/models/transformer.py`: the same config fields,
the same parameter tree (plain dict, layers stacked on a leading axis) and
the same math, with a Python loop over layers in place of `lax.scan`.
Attention goes through `ops.flash_attention` (the CUDA forward kernel on
a card). bf16 params/activations, fp32 logits.

The mesh argument and the one-hot embedding, `loss_fn` and
`param_logical_axes` belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.layers import apply_rope, rmsnorm, rope, swiglu

# The model's fp32 products (the logits head, fp32 configs) run in full
# fp32: TF32 would keep ~3 decimal digits and break greedy exactness.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MoE: 0 = dense. When > 0 every layer is a top-k MoE layer.
    moe_experts: int = 0
    moe_top_k: int = 2
    dtype: str = "float32"
    # Training-time rematerialization; read by the training slice.
    remat: bool = False
    attn_impl: str = "auto"  # auto|pallas|reference|interpret|ring|ulysses
    tie_embeddings: bool = True
    # The JAX package's scan-vs-unroll switch; the port always runs a
    # Python loop over layers, so it only rides along with the config.
    unroll_layers: bool | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(config: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights with the JAX package's tree and scales, drawn in
    fp32 from `generator` (on its device) and moved to `device`. The
    numbers differ from `jax.random`'s; carry JAX weights across with
    `models.convert.params_from_numpy` instead."""
    dev = resolve_device(device)
    c = config
    dt = c.torch_dtype
    gdev = generator.device
    d, hd = c.d_model, c.head_dim

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(dtype=dt, device=dev)

    def dense_init(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def norm_init(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    L = c.n_layers
    embed = normal((c.vocab, d), 0.02)
    layer = {
        "attn_norm": norm_init((L, d)),
        "wq": dense_init((L, d, c.n_heads * hd), d),
        "wk": dense_init((L, d, c.n_kv_heads * hd), d),
        "wv": dense_init((L, d, c.n_kv_heads * hd), d),
        "wo": dense_init((L, c.n_heads * hd, d), c.n_heads * hd),
        "mlp_norm": norm_init((L, d)),
    }
    if c.moe_experts:
        X = c.moe_experts
        layer.update({
            "router": dense_init((L, d, X), d),
            "wg": dense_init((L, X, d, c.d_ff), d),
            "wu": dense_init((L, X, d, c.d_ff), d),
            "wd": dense_init((L, X, c.d_ff, d), c.d_ff),
        })
    else:
        layer.update({
            "wg": dense_init((L, d, c.d_ff), d),
            "wu": dense_init((L, d, c.d_ff), d),
            "wd": dense_init((L, c.d_ff, d), c.d_ff),
        })
    params = {"embed": embed, "layers": layer, "final_norm": norm_init((d,))}
    if not c.tie_embeddings:
        params["lm_head"] = dense_init((d, c.vocab), d)
    return params


def layer_params(params: dict, li: int) -> dict:
    """Layer `li`'s slice of the stacked layer tree (views, no copies)."""
    return {k: v[li] for k, v in params["layers"].items()}


def lm_head(params: dict, config: ModelConfig):
    return params["embed"].T if config.tie_embeddings else params["lm_head"]


def _attention(x, lp, c: ModelConfig, sin, cos):
    b, s, d = x.shape
    h, hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    q = torch.einsum("bsd,dk->bsk", x, lp["wq"]).reshape(b, s, h, hd)
    k = torch.einsum("bsd,dk->bsk", x, lp["wk"]).reshape(b, s, hkv, hd)
    v = torch.einsum("bsd,dk->bsk", x, lp["wv"]).reshape(b, s, hkv, hd)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = flash_attention(q, k, v, causal=True, impl=c.attn_impl)
    return torch.einsum("bsk,kd->bsd", o.reshape(b, s, h * hd), lp["wo"])


def _moe(x, lp, c: ModelConfig):
    """Top-k MoE in dense form: every expert computes, the router's top-k
    weights zero the rest (plain einsums, no kernel)."""
    logits = torch.einsum("bsd,dx->bsx", x.float(), lp["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, c.moe_top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    gate = torch.zeros_like(probs).scatter(-1, top_i, top_w)
    h = torch.einsum("bsd,xdf->bsxf", x, lp["wg"])
    u = torch.einsum("bsd,xdf->bsxf", x, lp["wu"])
    y = torch.einsum("bsxf,xfd->bsxd", F.silu(h) * u, lp["wd"])
    return torch.einsum("bsxd,bsx->bsd", y, gate.to(x.dtype))


def _mlp(x, lp):
    return swiglu(x, lp["wg"], lp["wu"], lp["wd"])


def hidden_states(params, tokens, config: ModelConfig):
    """tokens [batch, seq] -> final-norm hidden states [batch, seq, d]."""
    c = config
    if c.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={c.attn_impl!r} (sequence parallelism over a mesh) "
            f"belongs to a later slice of the PyTorch port")
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sin, cos = rope(positions, c.head_dim, c.rope_theta)
    for li in range(c.n_layers):
        lp = layer_params(params, li)
        h = x + _attention(rmsnorm(x, lp["attn_norm"], c.norm_eps), lp, c,
                           sin, cos)
        normed = rmsnorm(h, lp["mlp_norm"], c.norm_eps)
        x = h + (_moe(normed, lp, c) if c.moe_experts else _mlp(normed, lp))
    return rmsnorm(x, params["final_norm"], c.norm_eps)


def forward(params, tokens, config: ModelConfig):
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32).

    The head product takes the activations and head in their own dtype
    upcast to fp32 (exact for bf16) with an fp32 sum, as the JAX
    package's `preferred_element_type=float32` does."""
    x = hidden_states(params, tokens, config)
    return torch.matmul(x.float(), lm_head(params, config).float())
