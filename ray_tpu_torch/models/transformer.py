"""Llama-family decoder: RMSNorm + RoPE + GQA attention + SwiGLU (or MoE).

Counterpart of `ray_tpu/models/transformer.py`: the same config fields,
the same parameter tree (plain dict, layers stacked on a leading axis) and
the same math, with a Python loop over layers in place of `lax.scan`.
Attention goes through `ops.flash_attention` (the CUDA forward and
backward kernels on a card). bf16 params/activations, fp32 logits.
`loss_fn` is the training objective (chunked, rematerialized cross
entropy); `remat` recomputes each layer in the backward with
`torch.utils.checkpoint` where the JAX package uses `jax.checkpoint`.

A mesh of more than one device (and with it the one-hot embedding the
JAX package uses under sharding) belongs to the sharded slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def param_logical_axes(config: ModelConfig) -> dict:
    """Logical sharding axes per param (leading stacked axis = "layer"); a
    copy of the JAX package's table, which is pure data, for the sharded
    slice of the port."""
    c = config
    layer = {
        "attn_norm": ("layer", None),
        "wq": ("layer", "embed", "heads"),
        "wk": ("layer", "embed", "kv_heads"),
        "wv": ("layer", "embed", "kv_heads"),
        "wo": ("layer", "heads", "embed"),
        "mlp_norm": ("layer", None),
    }
    if c.moe_experts:
        layer.update({
            "router": ("layer", "embed", None),
            "wg": ("layer", "expert", "embed", "mlp"),
            "wu": ("layer", "expert", "embed", "mlp"),
            "wd": ("layer", "expert", "mlp", "embed"),
        })
    else:
        layer.update({
            "wg": ("layer", "embed", "mlp"),
            "wu": ("layer", "embed", "mlp"),
            "wd": ("layer", "mlp", "embed"),
        })
    axes = {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": (None,),
    }
    if not c.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def check_single_device(mesh, what: str) -> None:
    """`mesh` (None, or a mesh whose `devices` array the JAX package's
    Mesh shape gives) must hold one device in this slice."""
    n = 1 if mesh is None else mesh.devices.size
    if n > 1:
        raise NotImplementedError(
            f"{what} over a mesh of {n} devices is the sharded slice of the "
            f"PyTorch port (parallel/mesh.py, parallel/sharding.py); this "
            f"slice runs on one device")


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


def hidden_states(params, tokens, config: ModelConfig, mesh=None):
    """tokens [batch, seq] -> final-norm hidden states [batch, seq, d]."""
    c = config
    check_single_device(mesh, "hidden_states")
    if c.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={c.attn_impl!r} (sequence parallelism over a mesh) "
            f"belongs to a later slice of the PyTorch port")
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sin, cos = rope(positions, c.head_dim, c.rope_theta)

    def layer_body(x, lp):
        h = x + _attention(rmsnorm(x, lp["attn_norm"], c.norm_eps), lp, c,
                           sin, cos)
        normed = rmsnorm(h, lp["mlp_norm"], c.norm_eps)
        mlp = _moe(normed, lp, c) if c.moe_experts else _mlp(normed, lp)
        return h + mlp

    for li in range(c.n_layers):
        lp = layer_params(params, li)
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(layer_body, x, lp, use_reentrant=False)
        else:
            x = layer_body(x, lp)
    return rmsnorm(x, params["final_norm"], c.norm_eps)


def forward(params, tokens, config: ModelConfig, mesh=None):
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32).

    The head product takes the activations and head in their own dtype
    upcast to fp32 (exact for bf16) with an fp32 sum, as the JAX
    package's `preferred_element_type=float32` does."""
    x = hidden_states(params, tokens, config, mesh)
    return torch.matmul(x.float(), lm_head(params, config).float())


# loss_fn chunks the head + softmax when the full fp32 logits tensor would
# pass this many bytes (the JAX package's threshold).
CHUNK_MIN_BYTES = 1 << 30


def _xent(x, head, targets):
    """Log-likelihood of `targets` under one chunk's logits [b, s]: the
    target logit minus the row logsumexp, without materializing the full
    log-softmax. Logits never leave this function."""
    logits = torch.matmul(x.float(), head.float())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    return tgt - lse


def uses_loss_chunks(b: int, s: int, vocab: int, loss_chunk: int) -> bool:
    """Whether `loss_fn` runs the head in rematerialized sequence chunks:
    only when the fp32 logits would be large enough to matter."""
    return (s % loss_chunk == 0 and s > loss_chunk
            and 4 * b * s * vocab > CHUNK_MIN_BYTES)


def log_likelihood(x, head, targets, loss_chunk: int = 512):
    """Per-position log-likelihood [b, s] of `targets` under the logits
    x @ head, in rematerialized chunks of `loss_chunk` positions when
    `uses_loss_chunks` says the fp32 logits are large."""
    b, s, _d = x.shape
    if not uses_loss_chunks(b, s, head.shape[-1], loss_chunk):
        return _xent(x, head, targets)
    return torch.cat([
        checkpoint(_xent, x[:, i:i + loss_chunk], head,
                   targets[:, i:i + loss_chunk], use_reentrant=False)
        for i in range(0, s, loss_chunk)], dim=1)


def loss_fn(params, batch, config: ModelConfig, mesh=None,
            loss_chunk: int = 512):
    """Next-token cross entropy (fp32 scalar); batch = {"tokens": [b, s+1]}
    or {"inputs": [b, s], "targets": [b, s]}, with an optional "mask"
    [b, s] weighting the positions.

    The [b, s, vocab] fp32 logits tensor dominates training memory, so the
    head + softmax runs in sequence chunks of `loss_chunk` that the
    backward recomputes: peak logits memory is b * loss_chunk * vocab."""
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    x = hidden_states(params, inputs, config, mesh)
    ll = log_likelihood(x, lm_head(params, config), targets.long(),
                        loss_chunk)
    mask = batch.get("mask")
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
