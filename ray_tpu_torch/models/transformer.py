"""Llama-family decoder: RMSNorm + RoPE + GQA attention + SwiGLU (or MoE).

Counterpart of `ray_tpu/models/transformer.py`: the same config fields,
the same parameter tree (plain dict, layers stacked on a leading axis) and
the same math, with a Python loop over layers in place of `lax.scan`.
Attention goes through `ops.flash_attention` (the CUDA forward and
backward kernels on a card). bf16 params/activations, fp32 logits.
`loss_fn` is the training objective (chunked, rematerialized cross
entropy); `remat` recomputes each layer in the backward with
`torch.utils.checkpoint` where the JAX package uses `jax.checkpoint`.

Under a mesh (`parallel.make_mesh`; every rank calls alike, each with its
own rows of the batch) the params are DTensors placed by the rules table
(`parallel.sharding`, the train step's `init_fn`) and each rank runs
the model on its share:
- fsdp/dp: each layer's params are gathered over the data axes just
  before use (`redistribute` to Replicate), and `to_local` declares the
  gradient of the gathered tensor a partial sum over those axes, so the
  backward reduce-scatters (fsdp) and all-reduces (dp) it. Without that
  declaration each rank would keep its own local gradient: a step that
  trains without error on gradients wrong by the data degree.
- tp: each rank runs its d_ff / tp columns and, where tp divides the
  head counts, its n_heads / tp query heads and n_kv_heads / tp kv heads
  (`local_config`), so the flash kernels see the local head counts;
  Megatron's all-reduce after `wo` and `wd` (`parallel.collectives`).
  Where tp is a multiple of n_kv_heads, each rank runs its query heads
  with the one kv head they read, gathered whole (Megatron's GQA rule;
  the kv head's gradient sums over the ranks that share it). Where a
  split cuts inside a head, the attention block's weights are gathered
  and attention runs whole on every rank. The params are placed as the
  JAX package's table places them in every case (tp need only divide
  the flat head widths, d_ff and vocab). The embedding is vocab-parallel
  (masked lookup + all-reduce) and the loss the vocab-parallel cross
  entropy.
- sp: each rank runs a contiguous block of every row (the rules table's
  "seq" -> "sp"; the train step cuts it), its RoPE positions offset by
  the block's start; attention crosses the blocks by ring attention or
  Ulysses (`attn_impl` "ring" / "ulysses", `parallel.ring_attention`,
  `parallel.ulysses`; any other attn_impl is refused under sp, since
  attention within a block alone would be wrong). The params are
  replicated over sp and each rank's gradient is a partial sum, so the
  gathers all-reduce it over sp in the backward, and the loss is the mean
  over every rank's positions.
- ep: each rank holds moe_experts / ep experts (the rules table's
  "expert" -> "ep") and runs them on the same rows; their gated outputs
  are summed over ep (Megatron's pair, as for tp), so the gradient of the
  experts' input is summed over ep in the backward and the attention and
  norm gradients come out whole on every rank. The router is replicated
  and its gradient, partial over ep (each rank gates its own experts), is
  summed over ep.
- pp: the layer stack has no stage axis (the rules table maps "stage",
  which no param of the model carries), so the pp ranks replicate the
  step, as the JAX package's step does over a pp mesh; GPipe over stages
  is `parallel.pipeline.gpipe`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.layers import apply_rope, rmsnorm, rope, swiglu
from ray_tpu_torch.parallel.collectives import (copy_to_tp, gather_from_tp,
                                                gather_weight_tp, max_over,
                                                reduce_from_tp, sum_over)
from ray_tpu_torch.parallel.mesh import axis_group, axis_rank, mesh_degrees
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention

# attn_impl values that attend across the sequence blocks of the sp axis
SEQUENCE_PARALLEL = ("ring", "ulysses")

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


# How attention splits over tp (`ShardedConfig.attn_split`).
SPLIT_HEADS = "heads"              # each rank its h / tp and hkv / tp heads
SPLIT_KV_REPLICATED = "kv_replicated"  # its h / tp heads, their kv head
SPLIT_REPLICATED = "replicated"    # every head on every rank


@dataclasses.dataclass(frozen=True)
class ShardedConfig(ModelConfig):
    """A rank's view of a ModelConfig under a mesh: its local d_ff (the
    global one / tp), the heads it runs (`attn_split`: its n_heads / tp
    and n_kv_heads / tp; its n_heads / tp and 1 kv head; or all of them),
    the global head_dim (`hd`), the tp group (None at tp = 1) its
    collectives run on, and under ep its moe_experts / ep experts, the
    first of them global expert `ep_rank * moe_experts`, and the ep group
    (None at ep = 1)."""
    tp: int = 1
    tp_rank: int = 0
    tp_group: object = dataclasses.field(default=None, compare=False,
                                         repr=False)
    attn_split: str = SPLIT_HEADS
    hd: int = 0
    ep_rank: int = 0
    ep_group: object = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def head_dim(self) -> int:
        return self.hd


def local_config(config: ModelConfig, mesh) -> ModelConfig:
    """This rank's ShardedConfig under `mesh`. tp must divide what the
    rules table splits over it (the flat n_heads * head_dim and
    n_kv_heads * head_dim widths, d_ff and vocab) and ep the experts of
    an MoE model, as placing the params needs; else ValueError, as the
    JAX package's placement refuses. Under sp > 1 attn_impl must be
    "ring" or "ulysses" (ValueError)."""
    c = config
    deg = mesh_degrees(mesh)
    tp, ep = deg.get("tp", 1), deg.get("ep", 1)
    if deg.get("sp", 1) > 1 and c.attn_impl not in SEQUENCE_PARALLEL:
        raise ValueError(
            f"a mesh with sp={deg['sp']} cuts every row into blocks: "
            f"attention must cross them (attn_impl 'ring' or 'ulysses'), "
            f"not run within a block (attn_impl={c.attn_impl!r})")
    hd = c.head_dim
    for what, n in (("n_heads * head_dim", c.n_heads * hd),
                    ("n_kv_heads * head_dim", c.n_kv_heads * hd),
                    ("d_ff", c.d_ff), ("vocab", c.vocab)):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what}={n}: the params "
                             f"are split over tp along it")
    if c.moe_experts % ep:
        raise ValueError(f"ep={ep} must divide moe_experts="
                         f"{c.moe_experts}: the experts are split over ep")
    if c.n_heads % tp == 0 and c.n_kv_heads % tp == 0:
        split, h, hkv = SPLIT_HEADS, c.n_heads // tp, c.n_kv_heads // tp
    elif c.n_heads % tp == 0 and tp % c.n_kv_heads == 0:
        split, h, hkv = SPLIT_KV_REPLICATED, c.n_heads // tp, 1
    else:
        split, h, hkv = SPLIT_REPLICATED, c.n_heads, c.n_kv_heads
    fields = {f.name: getattr(c, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(n_heads=h, n_kv_heads=hkv, d_ff=c.d_ff // tp,
                  moe_experts=c.moe_experts // ep)
    return ShardedConfig(**fields, tp=tp, tp_rank=axis_rank(mesh, "tp"),
                         tp_group=axis_group(mesh, "tp"), attn_split=split,
                         hd=hd, ep_rank=axis_rank(mesh, "ep"),
                         ep_group=axis_group(mesh, "ep"))


def tp_group(config: ModelConfig):
    """The tp group of a ShardedConfig; None for a plain ModelConfig."""
    return getattr(config, "tp_group", None)


def _data_gather(dt, mesh, name: str) -> torch.Tensor:
    """A placed param (DTensor) gathered over the data axes: the rank's tp
    (and ep) block, whole along every other dim. Its gradient is declared
    a partial sum over dp and fsdp, so the backward sums it over the data
    ranks (reduce-scatter onto the fsdp shards, all-reduce over dp). Where
    the param (`name`) is replicated over an axis and each rank's gradient
    is its own share of it, the gradient is all-reduced over that axis as
    well (Megatron's copy, a plain all-reduce in the backward): over sp
    for every param (each rank a block of the sequence), over ep for the
    router (each rank gating its own experts)."""
    from torch.distributed.tensor import Partial, Replicate
    names = list(mesh_degrees(mesh))
    data = [i for i, n in enumerate(names) if n in ("dp", "fsdp")]
    target = [Replicate() if i in data else p
              for i, p in enumerate(dt.placements)]
    grads = [Partial() if i in data else p
             for i, p in enumerate(dt.placements)]
    x = dt.redistribute(mesh, target).to_local(grad_placements=grads)
    x = copy_to_tp(x, axis_group(mesh, "sp"))
    if name == "router":
        x = copy_to_tp(x, axis_group(mesh, "ep"))
    return x


def _mesh_layers(params, mesh, n_layers: int):
    """Layer li's params gathered over the data axes, layer by layer (the
    FSDP gather before use): a stacked param's local block is split along
    its layer dim (never sharded) and each slice re-placed on the mesh."""
    from torch.distributed.tensor import DTensor, Shard
    split, per_layer = {}, {}
    for k, v in params["layers"].items():
        if not isinstance(v, DTensor):
            raise TypeError(f"params['layers'][{k!r}] is not placed on the "
                            f"mesh (shard_params / the train step's init_fn)")
        if any(isinstance(p, Shard) and p.dim == 0 for p in v.placements):
            raise ValueError(f"params['layers'][{k!r}] is sharded along its "
                             f"layer dim")
        split[k] = v.to_local().unbind(0)
        per_layer[k] = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                        for p in v.placements]
    for li in range(n_layers):
        yield {k: _data_gather(DTensor.from_local(
                   split[k][li], mesh, per_layer[k], run_check=False), mesh,
                   k)
               for k in split}


def _mesh_top(params, mesh) -> dict:
    """The non-layer params (embed, final_norm, lm_head) gathered over the
    data axes."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in params.items():
        if k == "layers":
            continue
        if not isinstance(v, DTensor):
            raise TypeError(f"params[{k!r}] is not placed on the mesh")
        out[k] = _data_gather(v, mesh, k)
    return out


def layer_params(params: dict, li: int) -> dict:
    """Layer `li`'s slice of the stacked layer tree (views, no copies)."""
    return {k: v[li] for k, v in params["layers"].items()}


def lm_head(params: dict, config: ModelConfig):
    return params["embed"].T if config.tie_embeddings else params["lm_head"]


def _attention_weights(lp, c: ModelConfig):
    """(wq, wk, wv, wo, group) as this rank runs attention: its blocks
    where tp splits whole heads; the one kv head its query heads read,
    gathered (Megatron's GQA rule); or the whole block, run replicated
    with no tp collective (group None), where a split cuts a head."""
    g = tp_group(c)
    wq, wk, wv, wo = lp["wq"], lp["wk"], lp["wv"], lp["wo"]
    if g is None or c.attn_split == SPLIT_HEADS:
        return wq, wk, wv, wo, g
    hd = c.head_dim
    if c.attn_split == SPLIT_KV_REPLICATED:
        # the rank's query heads read kv head j of the gathered n_kv_heads
        wk, wv = (gather_weight_tp(w, g, -1, sum_grad=True) for w in (wk, wv))
        j = c.tp_rank * (wk.shape[-1] // hd) // c.tp
        cols = slice(j * hd, (j + 1) * hd)
        return wq, wk[..., cols], wv[..., cols], wo, g
    wq, wk, wv = (gather_weight_tp(w, g, -1, sum_grad=False)
                  for w in (wq, wk, wv))
    return wq, wk, wv, gather_weight_tp(wo, g, 0, sum_grad=False), None


def _attention(x, lp, c: ModelConfig, sin, cos, mesh=None):
    b, s, d = x.shape
    h, hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    wq, wk, wv, wo, g = _attention_weights(lp, c)
    x = copy_to_tp(x, g)
    q = torch.einsum("bsd,dk->bsk", x, wq).reshape(b, s, h, hd)
    k = torch.einsum("bsd,dk->bsk", x, wk).reshape(b, s, hkv, hd)
    v = torch.einsum("bsd,dk->bsk", x, wv).reshape(b, s, hkv, hd)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if c.attn_impl in SEQUENCE_PARALLEL:
        if hkv != h:    # GQA broadcast before the sp collective
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
        sp_attention = (ring_attention if c.attn_impl == "ring"
                        else ulysses_attention)
        o = sp_attention(q, k, v, mesh, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True, impl=c.attn_impl)
    return reduce_from_tp(
        torch.einsum("bsk,kd->bsd", o.reshape(b, s, h * hd), wo), g)


def _moe(x, lp, c: ModelConfig):
    """Top-k MoE in dense form: every expert computes, the router's top-k
    weights zero the rest (plain einsums, no kernel). Under tp each rank
    holds d_ff / tp columns of every expert; the experts' outputs are
    summed over tp before the gate weights them, so the router's gradient
    sees whole outputs. Under ep each rank holds moe_experts of them (its
    ShardedConfig's) and gates their outputs with its slice of the whole
    router's gate; the gated outputs are summed over ep."""
    g, e = tp_group(c), getattr(c, "ep_group", None)
    x = copy_to_tp(x, e)
    logits = torch.einsum("bsd,dx->bsx", x.float(), lp["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, c.moe_top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    gate = torch.zeros_like(probs).scatter(-1, top_i, top_w)
    if e is not None:
        first = c.ep_rank * c.moe_experts
        gate = gate[..., first:first + c.moe_experts]
    xt = copy_to_tp(x, g)
    h = torch.einsum("bsd,xdf->bsxf", xt, lp["wg"])
    u = torch.einsum("bsd,xdf->bsxf", xt, lp["wu"])
    y = reduce_from_tp(
        torch.einsum("bsxf,xfd->bsxd", F.silu(h) * u, lp["wd"]), g)
    return reduce_from_tp(torch.einsum("bsxd,bsx->bsd", y, gate.to(x.dtype)),
                          e)


def _mlp(x, lp, group=None):
    """SwiGLU; under tp (`group`) column-parallel gate/up and a
    row-parallel down product, all-reduced."""
    return reduce_from_tp(
        swiglu(copy_to_tp(x, group), lp["wg"], lp["wu"], lp["wd"]), group)


def decoder_layer(x, lp, c: ModelConfig, sin, cos, mesh=None):
    """One decoder layer on x [b, s, d]: attention and the MLP (or MoE),
    each behind its RMSNorm and residual; `lp` the layer's params, `c`
    the config the rank runs (its ShardedConfig under a mesh), (sin, cos)
    the RoPE tables of x's positions."""
    h = x + _attention(rmsnorm(x, lp["attn_norm"], c.norm_eps), lp, c, sin,
                       cos, mesh)
    normed = rmsnorm(h, lp["mlp_norm"], c.norm_eps)
    mlp = (_moe(normed, lp, c) if c.moe_experts
           else _mlp(normed, lp, tp_group(c)))
    return h + mlp


def embed_tokens(table, tokens, config: ModelConfig):
    """The embedding rows of `tokens`; under tp the table is this rank's
    vocab block, so the lookup is masked to it and all-reduced."""
    g = tp_group(config)
    if g is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - config.tp_rank * n
    ok = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_tp(torch.where(ok[..., None], rows, 0.0), g)


def _hidden(params, tokens, config: ModelConfig, mesh):
    """(final-norm hidden states, this rank's config view, the non-layer
    params as used: gathered over the data axes under a mesh)."""
    c = config
    start = 0           # the global position of this rank's first token
    if mesh is None:
        top = params
        layers = (layer_params(params, li) for li in range(c.n_layers))
    else:
        c = local_config(c, mesh)
        top = _mesh_top(params, mesh)
        layers = _mesh_layers(params, mesh, c.n_layers)
        start = axis_rank(mesh, "sp") * tokens.shape[1]
    x = embed_tokens(top["embed"], tokens, c)
    positions = torch.arange(start, start + tokens.shape[1],
                             device=tokens.device)
    sin, cos = rope(positions, c.head_dim, c.rope_theta)
    for lp in layers:
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(decoder_layer, x, lp, c, sin, cos, mesh,
                           use_reentrant=False)
        else:
            x = decoder_layer(x, lp, c, sin, cos, mesh)
    return rmsnorm(x, top["final_norm"], c.norm_eps), c, top


def hidden_states(params, tokens, config: ModelConfig, mesh=None):
    """tokens [batch, seq] -> final-norm hidden states [batch, seq, d].
    Under a mesh, `tokens` are this rank's rows of the batch and, under
    sp, its contiguous block of each row (block r of sp: positions r *
    seq onward)."""
    return _hidden(params, tokens, config, mesh)[0]


def forward(params, tokens, config: ModelConfig, mesh=None):
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32).

    The head product takes the activations and head in their own dtype
    upcast to fp32 (exact for bf16) with an fp32 sum, as the JAX
    package's `preferred_element_type=float32` does. Under tp each rank's
    vocab block of the logits is gathered."""
    x, c, top = _hidden(params, tokens, config, mesh)
    g = tp_group(c)
    logits = torch.matmul(copy_to_tp(x, g).float(), lm_head(top, c).float())
    return gather_from_tp(logits, g)


# loss_fn chunks the head + softmax when the full fp32 logits tensor would
# pass this many bytes (the JAX package's threshold).
CHUNK_MIN_BYTES = 1 << 30


def _xent(x, head, targets, config=None):
    """Log-likelihood of `targets` under one chunk's logits [b, s]: the
    target logit minus the row logsumexp, without materializing the full
    log-softmax. Logits never leave this function. Under tp (`config` a
    ShardedConfig) `head` is this rank's vocab block: the vocab-parallel
    cross entropy, the row max and the sum of exps all-reduced over tp
    and the target logit taken from the rank that holds it."""
    logits = torch.matmul(x.float(), head.float())
    g = tp_group(config)
    if g is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
        return tgt - lse
    m = max_over(logits.amax(-1), g)
    lse = m + torch.log(reduce_from_tp(
        torch.exp(logits - m[..., None]).sum(-1), g))
    n = logits.shape[-1]
    local = targets - config.tp_rank * n
    ok = (local >= 0) & (local < n)
    tgt = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
    return reduce_from_tp(torch.where(ok, tgt.squeeze(-1), 0.0), g) - lse


def uses_loss_chunks(b: int, s: int, vocab: int, loss_chunk: int) -> bool:
    """Whether `loss_fn` runs the head in rematerialized sequence chunks:
    only when the fp32 logits would be large enough to matter."""
    return (s % loss_chunk == 0 and s > loss_chunk
            and 4 * b * s * vocab > CHUNK_MIN_BYTES)


def log_likelihood(x, head, targets, loss_chunk: int = 512, config=None):
    """Per-position log-likelihood [b, s] of `targets` under the logits
    x @ head, in rematerialized chunks of `loss_chunk` positions when
    `uses_loss_chunks` says the fp32 logits are large (`config`: see
    `_xent`)."""
    b, s, _d = x.shape
    if not uses_loss_chunks(b, s, head.shape[-1], loss_chunk):
        return _xent(x, head, targets, config)
    return torch.cat([
        checkpoint(_xent, x[:, i:i + loss_chunk], head,
                   targets[:, i:i + loss_chunk], config, use_reentrant=False)
        for i in range(0, s, loss_chunk)], dim=1)


def loss_fn(params, batch, config: ModelConfig, mesh=None,
            loss_chunk: int = 512):
    """Next-token cross entropy (fp32 scalar); batch = {"tokens": [b, s+1]}
    or {"inputs": [b, s], "targets": [b, s]}, with an optional "mask"
    [b, s] weighting the positions.

    The [b, s, vocab] fp32 logits tensor dominates training memory, so the
    head + softmax runs in sequence chunks of `loss_chunk` that the
    backward recomputes: peak logits memory is b * loss_chunk * vocab.

    Under a mesh `batch` holds this rank's rows (the train step cuts
    them) and, under sp, its block of every row ("inputs", "targets" and
    "mask" cut alike; a "tokens" batch then holds the block and the token
    after it), and the loss is the global batch's, as the JAX step's:
    each rank's share is its sum over the global count (the sum of
    counts over the data axes and sp), its value the sum of the shares;
    the gradient is the rank's own share, which the params' gathers sum
    over the data axes and sp. Under ep and pp every rank computes the
    same loss on the same rows."""
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    x, c, top = _hidden(params, inputs, config, mesh)
    ll = log_likelihood(copy_to_tp(x, tp_group(c)), lm_head(top, c),
                        targets.long(), loss_chunk, c)
    mask = batch.get("mask")
    if mesh is None:
        if mask is None:
            return -ll.mean()
        mask = mask.to(ll.dtype)
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    # (At data and sp degree 1 both forms reduce to the one-device loss's
    # exact arithmetic: the mean times 1.0, the share plus 0.0.)
    data = [axis_group(mesh, a) for a in ("dp", "fsdp", "sp")]
    if mask is None:
        total = sum_over(torch.tensor(float(ll.numel()), device=ll.device),
                         data)
        share = -ll.mean() * (ll.numel() / total)
    else:
        mask = mask.to(ll.dtype)
        share = -(ll * mask).sum() / torch.clamp(sum_over(mask.sum(), data),
                                                 min=1.0)
    return share + (sum_over(share, data) - share.detach())
