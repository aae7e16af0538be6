"""Continuous-batching LLM inference engine over a paged (or dense) KV
cache.

Counterpart of `ray_tpu/llm/engine.py`. The scheduling is the JAX engine's,
line for line where it can be: slot-based continuous batching, a page pool
with an LRU of reusable prefix pages, prefix-cache hits, chunked prefill,
recompute preemption, decode windows that read tokens back once per
window, guided decoding, the disaggregated prefill engine and its KV
handoff, and the dense fixed-slot layout. What changes is the execution
model:

- PyTorch runs eagerly, so there are no compile buckets to share; the
  prompt, page-table and window buckets stay because they shape the
  schedule (and the bounded page tables bound the decode kernel's work).
- The KV pool is updated in place (index_put_), which takes the place of
  the JAX engine's buffer donation.
- A decode window is a Python loop of decode+sample steps whose tokens,
  lengths and `active` flags stay on the device; the host reads back one
  [n_steps, B] block per window, as the `lax.scan` version does.
- Decode attention is the hand-written paged-decode CUDA kernel
  (`ops/paged_attention.py`); prefill attention stays the plain dense
  masked softmax of the JAX code (matrix products left to the library, as
  the JAX package leaves them to XLA).
- Speculative decoding (`speculation="ngram"`) runs the same way: a
  speculative window is a Python loop of draft, verify and accept
  iterations (`decode_window_spec`) whose history, tokens, lengths and
  generator stay on the device, with one readback per window; the verify
  forward's attention is the fused verify-insert CUDA kernel.
- Guided decoding keeps the stacked per-slot token-transition tables
  (`llm/guided.py`) on the device and carries the per-slot DFA state
  through the window's loop, so a window never reads it back.
- `PrefillEngine.prefill_export` returns CPU tensors of the model's dtype
  (numpy has no bfloat16); `import_kv` takes those or numpy arrays.

Pool layout: [L, hkv, num_pages, page, hd] (each token's head row
contiguous; see `ops/csrc/paged_decode.cu`). Dense layout
(`kv_layout="dense"`): [L, max_slots, max_len, hkv, hd], attended by plain
PyTorch as the JAX engine attends it with plain jnp (no kernel).

Tensor parallelism (`mesh=` with tp > 1, as the JAX engine's "tp" axis;
every rank builds the engine and calls it alike): the params are placed
by the rules table and each rank keeps its blocks, so the KV pool holds
the rank's kv heads, the kernels run on its heads, `wo` and `wd` are
followed by an all-reduce and the vocab-parallel logits are all-gathered
before sampling. Every rank draws from the same seeded generator on the
same logits, so every rank picks the same tokens and the host state
(slots, pages, prefix cache, guides) stays identical with no broadcast.
The KV handoff exports and imports the rank's heads. dp, fsdp, sp, pp and
ep above 1 raise NotImplementedError (an engine replica's data axes are
separate engines; the rest are later slices).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.transformer import (ModelConfig, _mlp, _moe,
                                              check_mesh, embed_tokens,
                                              init_params, layer_params,
                                              lm_head, local_config,
                                              param_logical_axes, tp_group)
from ray_tpu_torch.parallel.collectives import gather_from_tp, reduce_from_tp
from ray_tpu_torch.parallel.sharding import (ShardingRules, shard_params,
                                             tree_map)
from ray_tpu_torch.ops._build import pad_cols, padded_head_dim
from ray_tpu_torch.ops.layers import apply_rope, rmsnorm, rope
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_verify_insert_attention)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8             # concurrent decoding sequences
    max_len: int = 2048            # per-sequence context bound (prompt + gen)
    prompt_buckets: tuple = (64, 256, 1024)  # prefill length buckets
    eos_token: int = 2
    default_max_new_tokens: int = 128
    default_temperature: float = 0.0  # 0 = greedy
    kv_layout: str = "paged"       # "paged" | "dense" (fixed slots)
    page_size: int = 128           # tokens per KV page
    num_pages: int | None = None   # pool size; None = slots*ceil(max_len/
    #                                page)+1
    prefix_cache: bool = True      # reuse full prompt pages across requests
    speculation: str | None = None  # None | "ngram"
    spec_k: int = 4                 # drafts verified per model pass


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list
    max_new_tokens: int
    temperature: float
    top_p: float = 1.0     # 1.0 = no nucleus truncation
    top_k: int = 0         # 0 = no top-k truncation
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Set when the request was preempted mid-decode: the token that was
    # sampled but never fed back. Re-admission resumes from it instead of
    # re-sampling the position.
    resume_token: int | None = None
    # Guided decoding: a compiled TokenGuide (guided.py) and the host
    # mirror of the slot's DFA state (advanced as tokens are read back;
    # survives preemption and re-admission).
    guide: object | None = None
    guide_state: int = 0
    # OpenAI logprobs: log p(token) for each generated token.
    logprobs: bool = False
    token_logprobs: list = dataclasses.field(default_factory=list)
    # Disaggregated serving: a (ks, vs) prompt-KV handoff exported by a
    # prefill engine (PrefillEngine.prefill_export), imported into the
    # prefix cache right before this request's admission.
    kv_handoff: tuple | None = None


# ---------------- pure model steps ----------------


def _qkv(x, lp, c: ModelConfig):
    b, s, _ = x.shape
    h, hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    q = torch.einsum("bsd,dq->bsq", x, lp["wq"]).reshape(b, s, h, hd)
    k = torch.einsum("bsd,dk->bsk", x, lp["wk"]).reshape(b, s, hkv, hd)
    v = torch.einsum("bsd,dk->bsk", x, lp["wv"]).reshape(b, s, hkv, hd)
    return q, k, v


def _mlp_block(x, lp, c: ModelConfig):
    normed = rmsnorm(x, lp["mlp_norm"], c.norm_eps)
    return x + (_moe(normed, lp, c) if c.moe_experts
                else _mlp(normed, lp, tp_group(c)))


def _dense_attend(q, kk, vv, mask, c: ModelConfig, dtype):
    """Masked softmax attention of the prefill paths. q [n, S, h, hd],
    kk/vv [n, T, hkv, hd], mask broadcastable to [n, h, S, T]. The
    probabilities are cast to the activation dtype before the PV product,
    as in the JAX engine."""
    n_rep = c.n_heads // c.n_kv_heads
    if n_rep > 1:
        kk = kk.repeat_interleave(n_rep, dim=2)
        vv = vv.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(c.head_dim)
    scores = torch.where(mask, scores.float(), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return attn.reshape(q.shape[0], q.shape[1], c.n_heads * c.head_dim)


def prefill_batch(params, tokens, config: ModelConfig):
    """tokens [n, S] (right-padded) -> (logits [n, S, vocab] fp32,
    k,v caches [L, n, S, hkv, hd]). Causal; padding contributes garbage
    KV beyond each true length, which insert never reads (length mask)."""
    c = config
    x = embed_tokens(params["embed"], tokens, c)
    n, s = tokens.shape
    sin, cos = rope(torch.arange(s, device=tokens.device), c.head_dim,
                    c.rope_theta)
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    ks, vs = [], []
    for li in range(c.n_layers):
        lp = layer_params(params, li)
        normed = rmsnorm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(normed, lp, c)
        q = apply_rope(q, sin[None], cos[None])
        k = apply_rope(k, sin[None], cos[None])
        attn = _dense_attend(q, k, v, causal[None, None], c, x.dtype)
        h = x + reduce_from_tp(
            torch.einsum("bsq,qd->bsd", attn, lp["wo"]), tp_group(c))
        x = _mlp_block(h, lp, c)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    logits = gather_from_tp(
        torch.matmul(x.float(), lm_head(params, c).float()), tp_group(c))
    return logits, torch.stack(ks), torch.stack(vs)


def prefill(params, tokens, config: ModelConfig):
    """tokens [1, S] -> (logits [S, vocab], k/v [L, S, hkv, hd])."""
    logits, ks, vs = prefill_batch(params, tokens, config)
    return logits[0], ks[:, 0], vs[:, 0]


def insert_kv(cache_k, cache_v, ks, vs, slot, length):
    """Splice a prefill's KV into dense slot `slot`, in place. ks/vs
    [L, S, hkv, hd]; the padded tail (positions >= length) is zeroed so
    stale garbage cannot alias later positions. Returns the caches."""
    S = ks.shape[1]
    mask = (torch.arange(S, device=ks.device) < length)[None, :, None, None]
    cache_k[:, slot, :S] = torch.where(mask, ks, 0).to(cache_k.dtype)
    cache_v[:, slot, :S] = torch.where(mask, vs, 0).to(cache_v.dtype)
    return cache_k, cache_v


def decode_step(params, cache_k, cache_v, tokens, lengths, active,
                config: ModelConfig, fused=None):
    """One token for every slot of the dense cache [L, B, T, hkv, hd],
    updated in place. tokens [B] (last sampled), lengths [B] (cache fill =
    position of the new token), active [B] bool. Each slot's new K/V lands
    at its position (clamped into the cache, as dynamic_update_slice
    clamps); attention is plain PyTorch over positions <= lengths, scores
    in the activation dtype, softmax in fp32, as in the JAX step. `fused`
    is `decode_weights(params, config)`, built here when not given.
    Returns (logits [B, vocab] fp32 with inactive rows masked, cache_k,
    cache_v)."""
    c = config
    if fused is None:
        fused = decode_weights(params, c)
    B, T = cache_k.shape[1], cache_k.shape[2]
    dev = tokens.device
    n_rep = c.n_heads // c.n_kv_heads
    x = embed_tokens(params["embed"], tokens.long(), c)[:, None, :]
    sin, cos = rope(lengths[:, None], c.head_dim, c.rope_theta)
    pos_mask = (torch.arange(T, device=dev)[None]
                <= lengths[:, None])                        # [B, T]
    rows = torch.arange(B, device=dev)
    w_pos = lengths.long().clamp(0, T - 1)
    for li in range(c.n_layers):
        lp = layer_params(params, li)
        q, k, v = _fused_qkv(rmsnorm(x, lp["attn_norm"], c.norm_eps), fused,
                             li, c)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        ck, cv = cache_k[li], cache_v[li]    # views: writes land in place
        ck[rows, w_pos] = k[:, 0].to(ck.dtype)
        cv[rows, w_pos] = v[:, 0].to(cv.dtype)
        kk = ck.repeat_interleave(n_rep, dim=2) if n_rep > 1 else ck
        vv = cv.repeat_interleave(n_rep, dim=2) if n_rep > 1 else cv
        scores = torch.einsum("bqhd,bthd->bhqt", q, kk.to(q.dtype))[:, :, 0]
        scores = scores / math.sqrt(c.head_dim)              # [B, h, T]
        scores = torch.where(pos_mask[:, None], scores.float(),
                             float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bht,bthd->bhd", probs, vv.to(x.dtype))
        attn = attn.reshape(B, 1, c.n_heads * c.head_dim)
        h = x + reduce_from_tp(
            torch.einsum("bsq,qd->bsd", attn, lp["wo"]), tp_group(c))
        x = _fused_mlp_block(h, lp, fused, li, c)
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    logits = gather_from_tp(torch.matmul(x[:, 0].float(), fused["head"]),
                            tp_group(c))
    return _mask_inactive(logits, active), cache_k, cache_v


def prefill_with_prefix_batch(params, tokens, pool_k, pool_v,
                              prefix_pages, prefix_len,
                              config: ModelConfig):
    """Prefill only the SUFFIX of prompts whose prefix pages are already
    cached. tokens [n, S] = suffixes (right-padded); prefix_pages [n, Pp]
    page ids into the pool (0-padded); prefix_len [n] true prefix token
    counts. Cached K is stored post-RoPE at absolute positions, so it is
    reused as-is; suffix positions offset by prefix_len. Returns (suffix
    logits [n, S, vocab] fp32, suffix k/v caches [L, n, S, hkv, hd])."""
    c = config
    dev = tokens.device
    x = embed_tokens(params["embed"], tokens, c)
    n, s = tokens.shape
    page = pool_k.shape[3]
    pre_t = prefix_pages.shape[1] * page
    positions = prefix_len[:, None] + torch.arange(s, device=dev)[None]
    sin, cos = rope(positions, c.head_dim, c.rope_theta)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    pre_mask = (torch.arange(pre_t, device=dev)[None, None]
                < prefix_len[:, None, None]).expand(n, s, pre_t)
    full_mask = torch.cat([pre_mask, causal[None].expand(n, s, s)], dim=2)
    idx = prefix_pages.long()
    ks, vs = [], []
    for li in range(c.n_layers):
        lp = layer_params(params, li)
        normed = rmsnorm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(normed, lp, c)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        # [hkv, n, Pp, page, hd] -> [n, Pp, page, hkv, hd] -> [n, preT, ...]
        hd = c.head_dim   # the pools may be padded past it (pad_cols)
        prek = pool_k[li][:, idx, :, :hd].permute(1, 2, 3, 0, 4).reshape(
            n, pre_t, c.n_kv_heads, hd)
        prev = pool_v[li][:, idx, :, :hd].permute(1, 2, 3, 0, 4).reshape(
            n, pre_t, c.n_kv_heads, hd)
        kk = torch.cat([prek.to(k.dtype), k], dim=1)
        vv = torch.cat([prev.to(v.dtype), v], dim=1)
        attn = _dense_attend(q, kk, vv, full_mask[:, None], c, x.dtype)
        h = x + reduce_from_tp(
            torch.einsum("bsq,qd->bsd", attn, lp["wo"]), tp_group(c))
        x = _mlp_block(h, lp, c)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    logits = gather_from_tp(
        torch.matmul(x.float(), lm_head(params, c).float()), tp_group(c))
    return logits, torch.stack(ks), torch.stack(vs)


def insert_pages_batch(pool_k, pool_v, ks, vs, page_ids, lengths):
    """Write a whole admission burst's prefill KV into its pages, in place.
    ks/vs [L, n, S, hkv, hd]; page_ids [n, n_tab] (0 = scratch, where
    duplicate writes may race — scratch holds garbage by contract);
    lengths [n]. Rows narrower than the pools (padded past an hd that is
    no multiple of 8) get zero columns."""
    ks, vs = pad_cols(pool_k.shape[-1], ks, vs)
    L, n, S, hkv, hd = ks.shape
    page = pool_k.shape[3]
    n_tab = page_ids.shape[1]
    s_pad = n_tab * page
    if s_pad != S:
        ks = F.pad(ks, (0, 0, 0, 0, 0, s_pad - S))
        vs = F.pad(vs, (0, 0, 0, 0, 0, s_pad - S))
    pos = torch.arange(s_pad, device=ks.device)
    mask = (pos[None] < lengths[:, None])[None, :, :, None, None]
    ks = torch.where(mask, ks, 0).permute(0, 3, 1, 2, 4).reshape(
        L, hkv, n * n_tab, page, hd)
    vs = torch.where(mask, vs, 0).permute(0, 3, 1, 2, 4).reshape(
        L, hkv, n * n_tab, page, hd)
    flat = page_ids.reshape(-1).long()
    pool_k[:, :, flat] = ks.to(pool_k.dtype)
    pool_v[:, :, flat] = vs.to(pool_v.dtype)


def decode_weights(params, config: ModelConfig) -> dict:
    """Loop-invariant weights of the decode step, built once per engine:
    fused [d, (h+2hkv)*hd] QKV and [d, 2*d_ff] gate+up matrices (one
    product each instead of three and two; the JAX engine concatenates
    inside the jit, where XLA hoists it) and the fp32 logits head."""
    lay = params["layers"]
    out = {"wqkv": torch.cat([lay["wq"], lay["wk"], lay["wv"]], dim=2),
           "head": lm_head(params, config).float()}
    if not config.moe_experts:
        out["wgu"] = torch.cat([lay["wg"], lay["wu"]], dim=2)
    return out


def _fused_qkv(x, fused, li, c: ModelConfig):
    """q [B, S, h, hd] and k, v [B, S, hkv, hd] of normed activations x
    [B, S, d] through layer li's fused QKV product."""
    B, S, _ = x.shape
    h_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    qkv = torch.einsum("bsd,dq->bsq", x, fused["wqkv"][li])
    q = qkv[..., :h_dim].reshape(B, S, c.n_heads, c.head_dim)
    k = qkv[..., h_dim:h_dim + kv_dim].reshape(B, S, c.n_kv_heads, c.head_dim)
    v = qkv[..., h_dim + kv_dim:].reshape(B, S, c.n_kv_heads, c.head_dim)
    return q, k, v


def _fused_mlp_block(h, lp, fused, li, c: ModelConfig):
    """h + MLP(rmsnorm(h)) with layer li's fused gate+up product (MoE
    layers take the unfused block)."""
    if c.moe_experts:
        return _mlp_block(h, lp, c)
    normed = rmsnorm(h, lp["mlp_norm"], c.norm_eps)
    gu = torch.einsum("bsd,df->bsf", normed, fused["wgu"][li])
    f = gu.shape[-1] // 2
    act = F.silu(gu[..., :f]) * gu[..., f:]
    return h + reduce_from_tp(torch.einsum("bsf,fd->bsd", act, lp["wd"]),
                              tp_group(c))


def _mask_inactive(logits, active):
    """Inactive slots' logits rows -> all mass on token 0."""
    neg = torch.full_like(logits, -1e30)
    neg[..., 0] = 0.0
    return torch.where(active.view(-1, *[1] * (logits.dim() - 1)), logits,
                       neg)


def decode_paged(params, pool_k, pool_v, tokens, lengths, active,
                 page_tables, config: ModelConfig, fused=None):
    """One token for every slot against the paged pool, updating the pools
    in place. tokens/lengths [B] int32 (lengths = position of the new
    token), active [B] bool, page_tables [B, P] int32 (0 = unused ->
    scratch page, whose garbage the position mask hides). The new token's
    KV scatters into (write_page, lengths % page); inactive and
    overshooting slots write the scratch page. `fused` is
    `decode_weights(params, config)`, built here when not given.
    Returns logits [B, vocab] fp32."""
    c = config
    if fused is None:
        fused = decode_weights(params, c)
    B, P = page_tables.shape
    page = pool_k.shape[3]
    x = embed_tokens(params["embed"], tokens.long(), c)[:, None, :]
    sin, cos = rope(lengths[:, None], c.head_dim, c.rope_theta)
    w_idx = torch.clamp(lengths // page, 0, P - 1)
    w_page = page_tables.gather(1, w_idx[:, None].long())[:, 0]
    w_page = torch.where(lengths // page >= P, 0, w_page)
    w_page = torch.where(active, w_page, 0).long()
    w_off = (lengths % page).long()
    attend = (lengths + 1).to(torch.int32)   # inclusive of the new token

    for li in range(c.n_layers):
        lp = layer_params(params, li)
        q, k, v = _fused_qkv(rmsnorm(x, lp["attn_norm"], c.norm_eps), fused,
                             li, c)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        pk, pv = pool_k[li], pool_v[li]      # views: writes land in the pool
        kw, vw = pad_cols(pk.shape[-1], k[:, 0], v[:, 0])  # padded pools
        pk[:, w_page, w_off] = kw.transpose(0, 1).to(pk.dtype)
        pv[:, w_page, w_off] = vw.transpose(0, 1).to(pv.dtype)
        attn = paged_decode_attention(q[:, 0].contiguous(), pk, pv, attend,
                                      page_tables)
        attn = attn.reshape(B, 1, c.n_heads * c.head_dim).to(x.dtype)
        h = x + reduce_from_tp(
            torch.einsum("bsq,qd->bsd", attn, lp["wo"]), tp_group(c))
        x = _fused_mlp_block(h, lp, fused, li, c)

    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    return _mask_inactive(gather_from_tp(
        torch.matmul(x[:, 0].float(), fused["head"]), tp_group(c)), active)


def decode_window(params, pool_k, pool_v, tokens, lengths, active,
                  page_tables, temps, top_ps, top_ks, gtables, gstates,
                  generator, config: ModelConfig, eos_token: int,
                  n_steps: int, trunc: bool, guided: bool,
                  want_logp: bool = False, fused=None):
    """`n_steps` decode+sample steps with the sampled tokens, lengths and
    `active` flags staying on the device: nothing here waits for the
    device or copies to the host. EOS flips `active` on the device; the
    caller reads the [n_steps, B] token block back once and discards any
    overshoot. `want_logp` also returns log p(sampled token) per step,
    under the unmasked logits.

    `guided`: constrained decoding. gtables [B, S, V] int32 stacked
    per-slot token-transition tables (unguided slots: an all-zeros table,
    every token allowed), gstates [B] int32 the per-slot DFA states, which
    advance on the device from step to step (guided.py).
    Returns (tokens, lengths, active, out [n_steps, B], logps or None)."""
    outs, logps = [], []
    toks, lens, act, gst = tokens, lengths, active, gstates
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    for _ in range(n_steps):
        logits = decode_paged(params, pool_k, pool_v, toks, lens, act,
                              page_tables, config, fused)
        mask = None
        if guided:
            row = gtables[rows, gst.long()]                 # [B, V]
            mask = row >= 0
        if trunc:
            nxt = sample(logits, temps, generator, top_p=top_ps, top_k=top_ks,
                         mask=mask)
        else:
            nxt = sample(logits, temps, generator, mask=mask)
        nxt = torch.where(act, nxt.to(torch.int32), 0)
        outs.append(torch.where(act, nxt, -1))  # -1 = slot emitted nothing
        if want_logp:
            lp = torch.log_softmax(logits, dim=-1).gather(
                1, nxt[:, None].long())[:, 0]
            logps.append(torch.where(act, lp, 0.0))
        lens = torch.where(act, lens + 1, lens)
        if guided:
            nxt_state = row.gather(1, nxt[:, None].long())[:, 0]
            gst = torch.where(act, nxt_state.clamp_min(0), gst)
        if eos_token >= 0:
            act = act & (nxt != eos_token)
        toks = nxt
    return (toks, lens, act, torch.stack(outs),
            torch.stack(logps) if want_logp else None)


def verify_paged(params, pool_k, pool_v, tokens, lengths, active,
                 page_tables, config: ModelConfig, fused=None):
    """Speculative-verify forward: S tokens per slot (the pending token +
    S-1 drafts) at positions lengths ... lengths+S-1, in one model pass.
    Writes all S tokens' KV into the pools in place (rejected positions
    hold garbage the position masks hide until real tokens overwrite
    them) through the fused verify-insert kernel, and returns logits
    [B, S, vocab] fp32: logits[:, j] predicts the token after input j.
    Same structure as decode_paged (fused QKV and gate+up, fp32 head)."""
    c = config
    if fused is None:
        fused = decode_weights(params, c)
    B, S = tokens.shape
    dev = tokens.device
    x = embed_tokens(params["embed"], tokens.long(), c)     # [B, S, d]
    positions = lengths[:, None] + torch.arange(S, device=dev)[None]
    sin, cos = rope(positions, c.head_dim, c.rope_theta)
    attend = (lengths + 1).to(torch.int32)   # query 0's causal limit

    for li in range(c.n_layers):
        lp = layer_params(params, li)
        q, k, v = _fused_qkv(rmsnorm(x, lp["attn_norm"], c.norm_eps), fused,
                             li, c)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        attn, _, _ = paged_verify_insert_attention(
            q.contiguous(), pool_k, pool_v,
            k.to(pool_k.dtype).contiguous(), v.to(pool_v.dtype).contiguous(),
            attend, page_tables, li)
        attn = attn.reshape(B, S, c.n_heads * c.head_dim).to(x.dtype)
        h = x + reduce_from_tp(
            torch.einsum("bsq,qd->bsd", attn, lp["wo"]), tp_group(c))
        x = _fused_mlp_block(h, lp, fused, li, c)

    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    return _mask_inactive(gather_from_tp(
        torch.matmul(x.float(), fused["head"]), tp_group(c)), active)


def ngram_draft(hist, lengths, last_tokens, k: int):
    """Propose k draft tokens per slot by matching the trailing 2-gram
    (hist[len-1], pending) against earlier history and copying what
    followed the most recent match (the vLLM ngram-speculator policy), on
    the device with no host sync. hist [B, H] holds all known tokens:
    positions < len are fed, hist[len] is the pending token. No match ->
    repeat the pending token."""
    B, H = hist.shape
    dev = hist.device
    c0 = hist.gather(1, (lengths - 1).clamp_min(0)[:, None].long())[:, 0]
    c1 = last_tokens
    idx = torch.arange(H - 1, device=dev)
    m = ((hist[:, :-1] == c0[:, None]) & (hist[:, 1:] == c1[:, None])
         & (idx[None] < (lengths - 1)[:, None]))
    p = torch.where(m, idx[None], -1).amax(dim=1)           # [B]
    found = p >= 0
    start = torch.where(found, p + 2, 0)
    gat = (start[:, None] + torch.arange(k, device=dev)[None]).clamp(0, H - 1)
    drafts = hist.gather(1, gat)
    return torch.where(found[:, None], drafts, c1[:, None])


def spec_accept_sample(logits, tin, temps, generator):
    """Accept/resample step of delta-proposal speculative sampling
    (Leviathan et al.: a deterministic draft d is accepted with
    probability p(d); on reject the residual, p with d's mass removed and
    renormalized, is sampled, so every emitted token is an exact draw from
    the target distribution). Rows with temperature 0 reduce to accepting
    iff the draft is the argmax and emitting argmaxes.

    logits [B, K+1, V] (position j predicts the token after input j), tin
    [B, K+1] (pending token + K drafts), temps [B]. Uniforms come from
    `generator`; the categorical draw is Gumbel-max. No host sync.
    Returns (acc [B] accepted-draft count, final [B] the resampled/bonus
    token at position acc, g_argmax [B, K+1])."""
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    greedy = (temps <= 0.0)[:, None]                        # [B, 1]
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None, None]
    probs = torch.softmax(scaled, dim=-1)                   # [B, K+1, V]
    g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, K+1]
    drafts = tin[:, 1:]                                     # [B, K]
    p_d = probs[:, :K].gather(-1, drafts[..., None].long())[..., 0]
    u = torch.rand((B, K), generator=generator, device=dev)
    ok = torch.where(greedy, g[:, :K] == drafts, u < p_d)
    acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    # Token at position acc: greedy -> argmax; sampled -> the residual
    # (reject, acc < K) or the plain target (bonus, acc == K).
    probs_r = probs.gather(
        1, acc[:, None, None].long().expand(B, 1, V))[:, 0]  # [B, V]
    d_r = tin.gather(1, (acc + 1).clamp_max(K)[:, None].long())[:, 0]
    excl = torch.arange(V, device=dev)[None] == d_r[:, None]
    resid = torch.where((acc < K)[:, None] & excl, 0.0, probs_r)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-30)
    uc = torch.rand((B, V), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(uc.clamp_min(torch.finfo(uc.dtype).tiny)))
    sampled = torch.argmax(torch.log(resid + 1e-30) + gumbel, dim=-1)
    bonus_g = g.gather(1, acc[:, None].long())[:, 0]
    final = torch.where(greedy[:, 0], bonus_g, sampled.to(torch.int32))
    return acc.to(torch.int32), final, g


def decode_window_spec(params, pool_k, pool_v, tokens, lengths, active,
                       hist, page_tables, temps, generator,
                       config: ModelConfig, eos_token: int, n_steps: int,
                       spec_k: int, fused=None):
    """Speculative decode window: each of `n_steps` iterations drafts
    spec_k tokens per slot by n-gram lookup (`ngram_draft`), verifies them
    in one multi-token forward (`verify_paged`) and emits the accepted
    prefix + 1 final token (`spec_accept_sample`): 1 to spec_k+1 tokens
    per model pass. Greedy rows give exactly plain greedy decoding's
    tokens; sampled rows are exact draws from the target distribution.
    Tokens, lengths, `active`, `hist` and the generator stay on the
    device: nothing here waits for it. Returns (tokens, lengths, active,
    hist, out [n_steps, B, spec_k+1]) with -1 where nothing was emitted."""
    K = spec_k
    B, H = hist.shape
    dev = tokens.device
    jj = torch.arange(K + 1, device=dev)[None]              # [1, K+1]
    pad = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    outs = []
    toks, lens, act, hst = tokens, lengths, active, hist
    for _ in range(n_steps):
        drafts = ngram_draft(hst, lens, toks, K)            # [B, K]
        tin = torch.cat([toks[:, None], drafts], dim=1)
        logits = verify_paged(params, pool_k, pool_v, tin, lens, act,
                              page_tables, config, fused)
        acc, bonus, _g = spec_accept_sample(logits, tin, temps, generator)
        drafts_p = torch.cat([drafts, pad], dim=1)
        e = torch.where(jj == acc[:, None], bonus[:, None],
                        torch.where(jj < acc[:, None], drafts_p, -1))
        if eos_token >= 0:
            is_eos = (e == eos_token).to(torch.int32)
            # drop everything after the first emitted EOS
            after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
            e = torch.where(after, -1, e)
            stop = (e == eos_token).any(dim=1)
        else:
            stop = torch.zeros_like(act)
        e = torch.where(act[:, None], e, -1)
        stop = stop & act
        # history update: emitted tokens live at positions lens+1+j
        s0 = torch.clamp(lens + 1, 0, H - (K + 1))
        offset = lens + 1 - s0                              # >= 0
        src_j = (jj - offset[:, None]).clamp(0, K)
        val = e.gather(1, src_j.long())
        pos = (s0[:, None] + jj).clamp(0, H - 1).long()
        write = (jj >= offset[:, None]) & (val >= 0) & act[:, None]
        hst = hst.scatter(1, pos, torch.where(write, val, hst.gather(1, pos)))
        toks = torch.where(act, bonus, toks)
        lens = torch.where(act, lens + acc + 1, lens)
        act = act & ~stop
        outs.append(e)
    return toks, lens, act, hst, torch.stack(outs)


def sample(logits, temperature, generator, top_p=None, top_k=None,
           mask=None):
    """Per-row temperature (0 = greedy) with optional nucleus (top_p) and
    top_k truncation, branch-free (no host sync).

    top_p/top_k are per-row tensors; top_p=1.0 / top_k=0 disable the
    respective filter for that row. mask [B, V] bool (True = allowed)
    constrains both the greedy and the stochastic paths (guided
    decoding). Sampling is Gumbel-max over the truncated logits with
    uniforms drawn from `generator`."""
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = logits / temp
    neg = torch.finfo(scaled.dtype).min
    if top_k is not None:
        V = scaled.shape[-1]
        # rank of each logit within its row (0 = largest)
        order = torch.argsort(scaled, dim=-1, descending=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(V, device=scaled.device).expand_as(order))
        k = torch.where(top_k > 0, top_k, V)[:, None]
        scaled = torch.where(ranks < k, scaled, neg)
    if top_p is not None:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p; <= (not
        # <) so the argmax survives even top_p == 0
        keep_sorted = (cum - probs) <= top_p[:, None]
        cutoff = torch.where(keep_sorted, sorted_logits,
                             float("inf")).min(dim=-1, keepdim=True).values
        scaled = torch.where(scaled >= cutoff, scaled, neg)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def _sample_one(logits_row, temperature: float, top_p: float, top_k: int,
                generator) -> int:
    """One token from one logits row [vocab] (a dense admission's or a
    prefill engine's first token), read back to the host."""
    dev = logits_row.device
    temps = torch.tensor([temperature], dtype=torch.float32, device=dev)
    if top_k == 0 and top_p >= 1.0:
        tok = sample(logits_row[None], temps, generator)
    else:
        tok = sample(logits_row[None], temps, generator,
                     top_p=torch.tensor([top_p], dtype=torch.float32,
                                        device=dev),
                     top_k=torch.tensor([top_k], dtype=torch.int64,
                                        device=dev))
    return int(tok[0])


# ---------------- the engine ----------------


def _resolve_params(c: ModelConfig, params, seed: int, device, mesh=None,
                    rules=None):
    """(params, the config the steps run) for the decode and the prefill
    engine: seeded random weights, or the caller's (full ones, the same
    on every rank), on the engine's device; under a tp mesh placed by the
    rules, each rank keeping its blocks, with this rank's config view."""
    if params is None:
        params = init_params(c, torch.Generator().manual_seed(seed), device)
    if params["embed"].device != device:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"engine on {device}")
    if mesh is None:
        return params, c
    deg = check_mesh(mesh, "an engine")
    for a in ("dp", "fsdp"):
        if deg.get(a, 1) > 1:
            raise NotImplementedError(
                f"an engine over a mesh with {a}={deg[a]}: data-parallel "
                f"serving is separate engines; an engine shards over tp only")
    placed = shard_params(params, param_logical_axes(c),
                          rules or ShardingRules.default(), mesh)
    with torch.no_grad():
        local = tree_map(lambda t: t.to_local(), placed,
                         is_leaf=lambda t: not isinstance(t, dict))
    return local, local_config(c, mesh)


def _prompt_bucket(e: EngineConfig, n: int) -> int:
    """The prefill bucket for an n-token prompt. Buckets above max_len are
    unusable: their prefill KV could not fit a sequence."""
    usable = [b for b in e.prompt_buckets if b <= e.max_len]
    limit = min(max(usable, default=0), e.max_len - 1)
    if n > limit:
        raise ValueError(
            f"prompt of {n} tokens exceeds the engine limit {limit} "
            f"(buckets={e.prompt_buckets}, max_len={e.max_len})")
    for b in usable:
        if n <= b:
            return b
    raise ValueError(f"no prompt bucket fits {n} tokens")


class InferenceEngine:
    """Slot-based continuous batching over the steps above.

    Thread-compatible: callers serialize through `step()`/`step_window()`.
    """

    def __init__(self, model_config: ModelConfig,
                 engine_config: EngineConfig | None = None, *,
                 params=None, mesh=None, rules=None, seed: int = 0,
                 device="cuda"):
        e = engine_config or EngineConfig()
        self.device = resolve_device(device)
        self.e = e
        self.mesh = mesh
        # Under a tp mesh: this rank's param blocks and config view.
        self.params, self.c = _resolve_params(model_config, params, seed,
                                              self.device, mesh, rules)
        c = self.c
        self._fused = decode_weights(self.params, c)
        dev = self.device
        self.paged = e.kv_layout == "paged"
        self.decode_steps = 0              # decode_paged/decode_step calls
        self.verify_steps = 0              # verify_paged calls run
        self._gen = torch.Generator(device=dev).manual_seed(seed + 1)
        if not self.paged:
            # Dense fixed slots: [L, max_slots, max_len, hkv, hd].
            kv_shape = (c.n_layers, e.max_slots, e.max_len, c.n_kv_heads,
                        c.head_dim)
            self.cache_k = torch.zeros(kv_shape, dtype=c.torch_dtype,
                                       device=dev)
            self.cache_v = torch.zeros(kv_shape, dtype=c.torch_dtype,
                                       device=dev)
        else:
            self._init_paged()

        # host-side slot state
        B = e.max_slots
        self.lengths = np.zeros(B, np.int32)
        self.active = np.zeros(B, bool)
        self.last_tokens = np.zeros(B, np.int32)

        # Speculative decoding state (paged only). The host history mirror
        # is written whatever the setting; its device twin lives only
        # between speculative windows.
        self._spec = self.paged and e.speculation == "ngram"
        if self._spec and e.spec_k + 1 > e.page_size:
            # a verify step's writes span at most 2 pages per slot
            raise ValueError(
                f"spec_k+1 ({e.spec_k + 1}) must not exceed "
                f"page_size ({e.page_size})")
        self.hist = np.zeros((B, e.max_len), np.int32)
        self._dev_hist = None
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._spec_alpha = 0.0  # acceptance-rate EMA (window sizing)
        self.slot_req: list[Request | None] = [None] * B
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: dict[int, Request] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._cancel_rids: set[int] = set()

    def _init_paged(self):
        c, e, dev = self.c, self.e, self.device
        # Paged pool: HBM tracks the pool size, not slots x max_len;
        # sequences grow page by page and shared prompt prefixes share
        # pages. Page 0 is reserved scratch (unused table entries).
        page = e.page_size
        self.pages_per_slot = -(-e.max_len // page)
        self.num_pages = (e.num_pages
                          or e.max_slots * self.pages_per_slot + 1)
        # at the kernels' head_dim (a multiple of 8: zero columns past
        # c.head_dim), so no kernel call copies a pool
        kv_shape = (c.n_layers, c.n_kv_heads, self.num_pages, page,
                    padded_head_dim(c.head_dim))
        self.cache_k = torch.zeros(kv_shape, dtype=c.torch_dtype, device=dev)
        self.cache_v = torch.zeros(kv_shape, dtype=c.torch_dtype, device=dev)
        # page bookkeeping (host side)
        self.free_pages: list[int] = list(range(1, self.num_pages))
        self.page_refs: dict[int, int] = {}
        self.page_hash: dict = {}          # prefix-hash -> page id
        self.hash_of_page: dict[int, object] = {}
        self.cached_lru: "collections.OrderedDict[int, object]" = (
            collections.OrderedDict())     # ref-0 cached pages (LRU)
        self.slot_pages: list[list[int]] = [[] for _ in range(e.max_slots)]
        self.prefix_hits = 0
        self.preemptions = 0
        # page-table buckets: powers of two up to the per-slot page bound
        pb, b = [], 1
        while b < self.pages_per_slot:
            pb.append(b)
            b *= 2
        pb.append(self.pages_per_slot)
        self._page_buckets = pb
        self._win_buckets = (1, 2, 4, 8, 16, 32, 64)
        # Device-resident decode state, uploaded only when the host view
        # changed.
        self._dev = None           # (tokens, lengths, active) on device
        self._dev_dirty = True
        self._dev_sampling = None  # (temps, top_ps, top_ks) on device
        self._dev_sampling_fp = None
        self._dev_gtables = None   # stacked guide tables [B, S, V]
        self._guide_fp = None
        self.guide_uploads = 0     # stacked-table uploads

    def _upload(self, arr, dtype=None):
        # torch.tensor always copies: an aliasing upload (from_numpy /
        # as_tensor on the CPU) would let device-side updates scribble
        # over the host mirrors.
        return torch.tensor(arr, dtype=dtype, device=self.device)

    # ---- request API ----

    def add_request(self, prompt_tokens, max_new_tokens=None,
                    temperature=None, top_p: float = 1.0,
                    top_k: int = 0, guide=None, logprobs: bool = False,
                    resume_token: int | None = None,
                    kv_handoff: tuple | None = None) -> int:
        """`resume_token`/`kv_handoff` serve disaggregated decoding:
        resume_token is a token already sampled for this sequence (by a
        prefill engine, or by a decode engine that stopped mid-stream):
        decoding resumes from it without re-sampling its position;
        kv_handoff is the exported prompt KV (`PrefillEngine.
        prefill_export`), imported into the prefix cache at admission
        (`import_kv`) so only the part it does not cover re-prefills."""
        # Validate at submission, in the caller's thread: an invalid prompt
        # must fail its own request, not the shared engine pump.
        if not (self._chunk_size() and len(prompt_tokens) < self.e.max_len):
            self._bucket(len(prompt_tokens))
        if (guide is not None or logprobs) and not self.paged:
            raise ValueError("guided decoding / logprobs require the "
                             "paged KV layout")
        if ((resume_token is not None or kv_handoff is not None)
                and not self.paged):
            raise ValueError("decode-state resume / KV handoff require "
                             "the paged KV layout")
        if guide is not None and guide.table.shape[1] != self.c.vocab:
            raise ValueError(
                f"guide compiled for vocab {guide.table.shape[1]}, "
                f"model vocab is {self.c.vocab}")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = Request(
            rid, list(map(int, prompt_tokens)),
            max_new_tokens or self.e.default_max_new_tokens,
            self.e.default_temperature if temperature is None
            else temperature, top_p=float(top_p), top_k=int(top_k),
            guide=guide, logprobs=bool(logprobs), kv_handoff=kv_handoff)
        if resume_token is not None:
            # The preemption-resume contract: the token is already part of
            # the sequence (it counts against max_new_tokens) and seeds
            # decoding without re-sampling its position.
            req.generated.append(int(resume_token))
            req.resume_token = int(resume_token)
        self.queue.append(req)
        return rid

    def cancel(self, request_id: int):
        """Abort a request from any thread: applied at the next admission
        pass (a queued request drops; an active slot finishes immediately
        with generated-so-far, its pages released)."""
        self._cancel_rids.add(request_id)

    def _apply_cancels(self):
        if not self._cancel_rids:
            return
        rids: set[int] = set()
        while True:
            try:
                rids.add(self._cancel_rids.pop())
            except KeyError:
                break
        kept: collections.deque[Request] = collections.deque()
        for req in self.queue:
            if req.request_id in rids:
                req.done = True
                self.finished[req.request_id] = req
            else:
                kept.append(req)
        self.queue = kept
        for i in range(self.e.max_slots):
            req = self.slot_req[i]
            if req is None or req.request_id not in rids:
                continue
            req.done = True
            self.finished[req.request_id] = req
            self.active[i] = False
            self.slot_req[i] = None
            if self.paged:
                self._release_slot(i)
            self._dev_dirty = True

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def import_kv(self, prompt_tokens, ks, vs) -> int:
        """Splice a handed-off prompt KV (`PrefillEngine.prefill_export`'s:
        [L, S, hkv, hd] CPU tensors, or numpy arrays as
        `params_from_numpy` takes them; K post-RoPE at absolute positions)
        into the paged pool as prefix-cache pages. Full pages only, and a
        page-aligned prompt leaves its last page out (at least one token
        always re-prefills: its logits seed sampling). The pages land ref-0
        in the eviction LRU, like pages a finished request released, so
        the next admission of this prompt (or of any prompt sharing the
        prefix) pins them through the prefix-hit path and prefills only
        the tail. Returns the pages imported. Call it from the thread that
        steps the engine (`add_request(kv_handoff=...)` routes it there)."""
        if not (self.paged and self.e.prefix_cache):
            return 0
        page = self.e.page_size
        prompt = list(map(int, prompt_tokens))
        full = len(prompt) // page
        if full * page == len(prompt):
            full -= 1
        full = min(full, int(ks.shape[1]) // page)
        if full <= 0:
            return 0
        hit = len(self._find_prefix(prompt))
        if hit >= full:
            return 0  # everything the handoff covers is already cached
        new_pages: list[int] = []
        for _ in range(full - hit):
            pid = self._alloc_page()
            if pid is None:
                break  # pool full of pinned pages: a partial import is fine
            new_pages.append(pid)
        if not new_pages:
            return 0
        if not isinstance(ks, torch.Tensor):
            kv = params_from_numpy({"k": ks, "v": vs}, device=self.device)
            ks, vs = kv["k"], kv["v"]
        n_tab = len(new_pages)
        seg = slice(hit * page, (hit + n_tab) * page)
        dev = self.device
        insert_pages_batch(
            self.cache_k, self.cache_v, ks[:, seg].to(dev)[:, None],
            vs[:, seg].to(dev)[:, None],
            self._upload(np.asarray(new_pages, np.int64)[None]),
            self._upload([n_tab * page]))
        for i, pid in enumerate(new_pages):
            self.page_refs[pid] = 1
            h = self._prefix_hash(prompt[:(hit + i + 1) * page])
            if h not in self.page_hash:
                self.page_hash[h] = pid
                self.hash_of_page[pid] = h
            # ref 0 -> cached_lru (evictable) via the standard release path
            self._decref_page(pid)
        return len(new_pages)

    # ---- scheduling ----

    def _chunk_size(self) -> int:
        """Page-aligned chunk for chunked prefill (0 = unavailable):
        prompts longer than every bucket prefill one chunk per engine
        step, registering each chunk's pages in the prefix cache so the
        next admission resumes where this one stopped."""
        if not (self.paged and self.e.prefix_cache):
            return 0
        page = self.e.page_size
        usable = [b for b in self.e.prompt_buckets if b <= self.e.max_len]
        if not usable:
            return 0
        return (max(usable) // page) * page

    def _bucket(self, n: int) -> int:
        return _prompt_bucket(self.e, n)

    # ---- page pool ----

    def _alloc_page(self) -> int | None:
        """A free page, else evict the LRU ref-0 cached page, else None."""
        if self.free_pages:
            return self.free_pages.pop()
        if self.cached_lru:
            pid, h = self.cached_lru.popitem(last=False)
            self.page_hash.pop(h, None)
            self.hash_of_page.pop(pid, None)
            self.page_refs.pop(pid, None)
            return pid
        return None

    def _incref_page(self, pid: int):
        self.page_refs[pid] = self.page_refs.get(pid, 0) + 1
        self.cached_lru.pop(pid, None)  # in use: not evictable

    def _decref_page(self, pid: int):
        n = self.page_refs.get(pid, 0) - 1
        if n > 0:
            self.page_refs[pid] = n
            return
        self.page_refs.pop(pid, None)
        h = self.hash_of_page.get(pid)
        if h is not None:
            # Keep the content cached for future prefix hits; evictable.
            self.cached_lru[pid] = h
        else:
            self.free_pages.append(pid)

    def _release_slot(self, slot: int):
        for pid in self.slot_pages[slot]:
            self._decref_page(pid)
        self.slot_pages[slot] = []

    @staticmethod
    def _prefix_hash(tokens: list) -> bytes:
        """Exact key (the token bytes themselves): a hash collision would
        silently serve another prompt's KV."""
        return np.asarray(tokens, np.int32).tobytes()

    def _find_prefix(self, prompt: list) -> list[int]:
        """Longest run of already-cached full prompt pages (at least one
        token is always left to prefill — its logits seed sampling)."""
        if not (self.paged and self.e.prefix_cache):
            return []
        page = self.e.page_size
        full = len(prompt) // page
        if full * page == len(prompt):
            full -= 1
        pages = []
        for i in range(full):
            pid = self.page_hash.get(
                self._prefix_hash(prompt[:(i + 1) * page]))
            if pid is None:
                break
            pages.append(pid)
        return pages

    def _preempt_victim(self) -> bool:
        """Pool exhausted mid-decode: requeue the youngest re-prefillable
        active slot (recompute preemption); its generated tokens become
        prompt tail on re-admission. Returns True if a page was freed."""
        candidates = []
        for i in range(self.e.max_slots):
            req = self.slot_req[i]
            if not self.active[i] or req is None:
                continue
            total = len(req.prompt) + len(req.generated)
            usable = [b for b in self.e.prompt_buckets
                      if b <= self.e.max_len]
            if total <= min(max(usable, default=0), self.e.max_len - 1):
                candidates.append((len(req.generated), i))
        if not candidates:
            return False
        _, victim = min(candidates)
        req = self.slot_req[victim]
        self._release_slot(victim)
        self.active[victim] = False
        self.slot_req[victim] = None
        # Re-prefill everything the model has seen (prompt + all fed-back
        # tokens); the final sampled-but-never-fed token resumes decoding
        # exactly where it stopped, without re-sampling its position.
        req.prompt = req.prompt + req.generated[:-1]
        req.resume_token = req.generated[-1]
        self.queue.appendleft(req)
        self.preemptions += 1
        return True

    def _admit(self) -> dict[int, int]:
        self._apply_cancels()
        return self._admit_paged() if self.paged else self._admit_dense()

    def _admit_paged(self) -> dict[int, int]:
        admitted: dict[int, int] = {}
        pending: list[tuple] = []  # (slot, req, last-logits row) to sample
        e = self.e
        page = e.page_size
        free = [i for i in range(e.max_slots) if not self.active[i]]
        # Phase 1 — host-side planning: pop requests, match prefixes,
        # allocate pages. No device work yet, so a whole admission burst
        # shares one batched prefill below.
        planned: list[dict] = []
        while free and self.queue:
            req = self.queue.popleft()
            slot = free[0]
            n = len(req.prompt)
            if req.kv_handoff is not None:
                # Disaggregated handoff: splice the prefill engine's KV
                # into the prefix cache now (page bookkeeping is
                # single-threaded here), so _find_prefix below hits it
                # and only the tail re-prefills.
                ks_h, vs_h = req.kv_handoff
                req.kv_handoff = None
                self.import_kv(req.prompt, ks_h, vs_h)
            pre_pages = self._find_prefix(req.prompt)
            hit = len(pre_pages)
            suffix = req.prompt[hit * page:]
            ns = len(suffix)
            chunk = self._chunk_size()
            is_partial = bool(chunk) and ns > max(
                b for b in self.e.prompt_buckets if b <= self.e.max_len)
            if is_partial:
                # Chunked prefill: admit only the next page-aligned chunk;
                # phase 3 registers its pages and requeues the request.
                suffix = suffix[:chunk]
                ns = chunk
                n = hit * page + chunk
            bucket = self._bucket(ns)
            # Pin the matched prefix pages FIRST: they may sit ref-0 in
            # the eviction LRU, and the suffix allocation below must not
            # be able to evict and reuse them.
            for pid in pre_pages:
                self._incref_page(pid)
            need = -(-n // page) - hit
            new_pages = []
            for _ in range(need):
                pid = self._alloc_page()
                if pid is None:
                    break
                new_pages.append(pid)
            if len(new_pages) < need:
                # Pool exhausted: put everything back and stop admitting.
                self.free_pages.extend(new_pages)
                for pid in pre_pages:
                    self._decref_page(pid)
                self.queue.appendleft(req)
                break
            for pid in new_pages:
                self.page_refs[pid] = 1
            if hit:
                self.prefix_hits += 1
            if is_partial:
                # A partial chunk never occupies the slot (and must not
                # reuse its id: a later full admission takes free[0]).
                slot = None
            else:
                free.pop(0)
            planned.append(dict(slot=slot, req=req, n=n, ns=ns,
                                bucket=bucket, hit=hit, partial=is_partial,
                                suffix=suffix, pre_pages=pre_pages,
                                new_pages=new_pages))

        # Phase 2 — device work, grouped: prefix-hit prompts batch by
        # (suffix bucket, prefix-page bucket), the rest by suffix bucket;
        # each group runs one prefill and one page insert.
        logits_of: dict[int, object] = {}  # slot -> last-logits row
        nohit_by_bucket: dict[int, list[dict]] = {}
        hit_by_key: dict[tuple, list[dict]] = {}
        for p in planned:
            if p["hit"]:
                pre_bucket = 1
                while pre_bucket < p["hit"]:
                    pre_bucket *= 2
                hit_by_key.setdefault(
                    (p["bucket"], pre_bucket), []).append(p)
            else:
                nohit_by_bucket.setdefault(p["bucket"], []).append(p)
        groups = [(b, pb, g) for (b, pb), g in hit_by_key.items()]
        groups += [(b, 0, g) for b, g in nohit_by_bucket.items()]
        for bucket, pre_bucket, group in groups:
            # Pad the batch to a power of two (bounded batch shapes).
            n_pad = 1
            while n_pad < len(group):
                n_pad *= 2
            n_tab = -(-bucket // page)
            toks = np.zeros((n_pad, bucket), np.int64)
            lens = np.zeros((n_pad,), np.int64)
            tabs = np.zeros((n_pad, n_tab), np.int64)
            pres = np.zeros((n_pad, pre_bucket), np.int64)
            plens = np.zeros((n_pad,), np.int64)
            for j, p in enumerate(group):
                toks[j, :p["ns"]] = p["suffix"]
                lens[j] = p["ns"]
                tabs[j, :len(p["new_pages"])] = p["new_pages"]
                pres[j, :p["hit"]] = p["pre_pages"]
                plens[j] = p["hit"] * page
            if pre_bucket:
                logits, ks, vs = prefill_with_prefix_batch(
                    self.params, self._upload(toks), self.cache_k,
                    self.cache_v, self._upload(pres), self._upload(plens),
                    self.c)
            else:
                logits, ks, vs = prefill_batch(self.params,
                                               self._upload(toks), self.c)
            insert_pages_batch(self.cache_k, self.cache_v, ks, vs,
                               self._upload(tabs), self._upload(lens))
            for j, p in enumerate(group):
                if p["slot"] is not None:
                    logits_of[p["slot"]] = logits[j, p["ns"] - 1]

        # Phase 3 — host-side registration.
        for p in planned:
            slot, req = p["slot"], p["req"]
            n, hit, new_pages = p["n"], p["hit"], p["new_pages"]
            # Register the full suffix pages for future prefix hits.
            if e.prefix_cache:
                for i in range(hit, n // page):
                    pid = new_pages[i - hit]
                    h = self._prefix_hash(req.prompt[:(i + 1) * page])
                    if h not in self.page_hash:
                        self.page_hash[h] = pid
                        self.hash_of_page[pid] = h
            if p["partial"]:
                # Chunk prefilled and registered; hand its pages to the
                # prefix cache (ref 0 -> protected in the LRU until the
                # continuation re-pins them) and requeue the request.
                for pid in p["pre_pages"] + new_pages:
                    self._decref_page(pid)
                self.queue.appendleft(req)
                continue
            self.slot_pages[slot] = p["pre_pages"] + new_pages
            self.slot_req[slot] = req
            self.lengths[slot] = n
            self.active[slot] = True
            self.hist[slot, :n] = req.prompt
            if req.resume_token is not None:
                first = req.resume_token  # already in req.generated
                req.resume_token = None
                self.last_tokens[slot] = first
                self.hist[slot, n] = first
                self._maybe_finish(slot, first)
            else:
                # Defer the first-token sampling: one batched readback
                # for the whole admission burst.
                pending.append((slot, req, logits_of[slot]))
            self._dev_dirty = True  # slot state changed by this admission
        if pending:
            stacked = torch.stack([row for _s, _r, row in pending])
            reqs = [r for _s, r, _l in pending]
            temps = self._upload([r.temperature for r in reqs],
                                 torch.float32)
            mask = self._host_guide_mask(reqs)
            if all(r.top_k == 0 and r.top_p >= 1.0 for r in reqs):
                toks_d = sample(stacked, temps, self._gen, mask=mask)
            else:
                toks_d = sample(
                    stacked, temps, self._gen,
                    top_p=self._upload([r.top_p for r in reqs],
                                       torch.float32),
                    top_k=self._upload([r.top_k for r in reqs],
                                       torch.int64), mask=mask)
            toks = toks_d.cpu().numpy()  # one readback for the burst
            p_logps = None
            if any(r.logprobs for r in reqs):
                p_logps = torch.log_softmax(stacked, dim=-1).gather(
                    1, toks_d[:, None])[:, 0].cpu().numpy()
            for j, ((slot, req, _l), tok) in enumerate(zip(pending, toks)):
                first = int(tok)
                if req.logprobs:
                    req.token_logprobs.append(float(p_logps[j]))
                req.generated.append(first)
                admitted[req.request_id] = first
                self.last_tokens[slot] = first
                self.hist[slot, self.lengths[slot]] = first
                self._advance_guide(req, first)
                self._maybe_finish(slot, first)
        return admitted

    def _admit_dense(self) -> dict[int, int]:
        admitted: dict[int, int] = {}
        free = [i for i in range(self.e.max_slots) if not self.active[i]]
        while free and self.queue:
            req = self.queue.popleft()
            slot = free.pop(0)
            n = len(req.prompt)
            toks = np.zeros((1, self._bucket(n)), np.int64)
            toks[0, :n] = req.prompt
            logits, ks, vs = prefill(self.params, self._upload(toks), self.c)
            first = _sample_one(logits[n - 1], req.temperature, req.top_p,
                                req.top_k, self._gen)
            insert_kv(self.cache_k, self.cache_v, ks, vs, slot, n)
            req.generated.append(first)
            admitted[req.request_id] = first
            self.slot_req[slot] = req
            self.lengths[slot] = n
            self.active[slot] = True
            self.last_tokens[slot] = first
            self.hist[slot, :n] = req.prompt
            self.hist[slot, n] = first
            self._maybe_finish(slot, first)
        return admitted

    def kv_stats(self) -> dict:
        """Pool accounting for tests and the smoke run."""
        if not self.paged:
            return {"layout": "dense", "decode_steps": self.decode_steps}
        return {
            "layout": "paged", "num_pages": self.num_pages,
            "free_pages": len(self.free_pages),
            "cached_pages": len(self.cached_lru),
            "pages_in_use": self.num_pages - 1 - len(self.free_pages)
            - len(self.cached_lru),
            "prefix_hits": self.prefix_hits,
            "preemptions": self.preemptions,
            "decode_steps": self.decode_steps,
            "verify_steps": self.verify_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "guide_uploads": self.guide_uploads,
        }

    def _maybe_finish(self, slot: int, token: int):
        req = self.slot_req[slot]
        total = self.lengths[slot] + 1  # +1: the just-sampled token
        if (token == self.e.eos_token
                or len(req.generated) >= req.max_new_tokens
                or total >= self.e.max_len):
            req.done = True
            self.finished[req.request_id] = req
            self.active[slot] = False
            self.slot_req[slot] = None
            if self.paged:
                self._release_slot(slot)

    def _sampling_arrays(self):
        e = self.e
        temps = np.array(
            [self.slot_req[i].temperature if self.slot_req[i] else 0.0
             for i in range(e.max_slots)], np.float32)
        top_ps = np.array(
            [self.slot_req[i].top_p if self.slot_req[i] else 1.0
             for i in range(e.max_slots)], np.float32)
        top_ks = np.array(
            [self.slot_req[i].top_k if self.slot_req[i] else 0
             for i in range(e.max_slots)], np.int64)
        return temps, top_ps, top_ks

    def step(self) -> dict[int, int]:
        """Admit queued prompts, run one decode step; returns
        {request_id: token} for tokens emitted this step (prefill's first
        token included)."""
        emitted = self._admit()
        if not self.active.any():
            return emitted
        temps, top_ps, top_ks = self._sampling_arrays()
        if self.paged:
            logits = self._decode_paged_step()
            if logits is None:  # every active slot was preempted
                return emitted
        else:
            self.decode_steps += 1
            logits, _, _ = decode_step(
                self.params, self.cache_k, self.cache_v,
                self._upload(self.last_tokens), self._upload(self.lengths),
                self._upload(self.active), self.c, self._fused)
        temps_d = self._upload(temps)
        mask = self._host_guide_mask(self.slot_req)
        if (top_ks == 0).all() and (top_ps >= 1.0).all():
            tokens_d = sample(logits, temps_d, self._gen, mask=mask)
        else:
            tokens_d = sample(logits, temps_d, self._gen,
                              top_p=self._upload(top_ps),
                              top_k=self._upload(top_ks), mask=mask)
        tokens = tokens_d.cpu().numpy()
        logps = None
        if any(r is not None and r.logprobs for r in self.slot_req):
            logps = torch.log_softmax(logits, dim=-1).gather(
                1, tokens_d[:, None])[:, 0].cpu().numpy()
        for i in range(self.e.max_slots):
            if not self.active[i]:
                continue
            tok = int(tokens[i])
            req = self.slot_req[i]
            if req.logprobs:
                req.token_logprobs.append(float(logps[i]))
            req.generated.append(tok)
            emitted[req.request_id] = tok
            self.lengths[i] += 1
            self.last_tokens[i] = tok
            if self.lengths[i] < self.e.max_len:
                self.hist[i, self.lengths[i]] = tok
            self._advance_guide(req, tok)
            self._maybe_finish(i, tok)
        self._dev_dirty = True  # single-step path mutates host-side state
        return emitted

    def _grow_pages(self, horizon: int = 1) -> bool:
        """Ensure every active slot has pages for its next `horizon`
        tokens, preempting when the pool is dry. Returns False if nothing
        is left active."""
        e = self.e
        page = e.page_size
        changed = False
        for i in range(e.max_slots):
            if not self.active[i]:
                continue
            req = self.slot_req[i]
            rem = min(horizon, req.max_new_tokens - len(req.generated) + 1)
            last_pos = int(self.lengths[i]) + max(rem, 1) - 1
            pi = min(last_pos, e.max_len - 1) // page
            while pi >= len(self.slot_pages[i]):
                changed = True
                pid = self._alloc_page()
                if pid is None:
                    if not self._preempt_victim():
                        # Nothing preemptable: finish this request early
                        # rather than deadlock the pump (pool too small
                        # for even one sequence — a config error).
                        req = self.slot_req[i]
                        req.done = True
                        self.finished[req.request_id] = req
                        self.active[i] = False
                        self.slot_req[i] = None
                        self._release_slot(i)
                        break
                    if not self.active[i]:  # self-preempted
                        break
                    continue
                self.page_refs[pid] = 1
                self.slot_pages[i].append(pid)
        if changed:
            # A preemption inside the growth loop changed slot state.
            self._dev_dirty = True
        return bool(self.active.any())

    def _decode_paged_step(self):
        """Grow pages for slots whose next token starts a fresh page
        (preempting if the pool is dry), build the bucketed page tables,
        and run one decode step. Returns logits or None if preemption
        drained every active slot."""
        if not self._grow_pages(1):
            return None
        tables = self._build_tables()
        self.decode_steps += 1
        return decode_paged(
            self.params, self.cache_k, self.cache_v,
            self._upload(self.last_tokens), self._upload(self.lengths),
            self._upload(self.active), self._upload(tables), self.c,
            self._fused)

    def _build_tables(self) -> np.ndarray:
        e = self.e
        p_need = max(
            (len(self.slot_pages[i]) for i in range(e.max_slots)
             if self.active[i]), default=1)
        p_bucket = next(b for b in self._page_buckets if b >= p_need)
        tables = np.zeros((e.max_slots, p_bucket), np.int32)
        for i in range(e.max_slots):
            if self.active[i]:
                row = self.slot_pages[i][:p_bucket]
                tables[i, :len(row)] = row
        return tables

    def _sync_device_state(self):
        if self._dev_dirty or self._dev is None:
            self._dev = (self._upload(self.last_tokens),
                         self._upload(self.lengths),
                         self._upload(self.active))
            if self._spec:
                self._dev_hist = self._upload(self.hist)
            self._dev_dirty = False

    def _sync_guides(self):
        """(guided?, stacked tables [B, S, V] int32, states [B] int32) for
        a window. The stacked table uploads only when the slot -> guide
        map changes; the [B] states upload every window. Unguided slots
        get an all-zeros table: every token allowed, state pinned to 0."""
        reqs = self.slot_req
        # Keyed on the guide's monotonic serial, not id(): a guide compiled
        # after another was freed can reuse its id() on the same slot, and
        # the stale device table would keep enforcing the old constraint.
        fp = tuple((i, r.guide.serial) for i, r in enumerate(reqs)
                   if r is not None and r.guide is not None)
        if not fp:
            return False, None, None
        if fp != self._guide_fp or self._dev_gtables is None:
            S = max(r.guide.n_states for r in reqs
                    if r is not None and r.guide is not None)
            tab = np.zeros((self.e.max_slots, S, self.c.vocab), np.int32)
            for i, r in enumerate(reqs):
                if r is not None and r.guide is not None:
                    tab[i, :r.guide.table.shape[0]] = r.guide.table
            self._dev_gtables = self._upload(tab)
            self._guide_fp = fp
            self.guide_uploads += 1
        states = self._upload(
            [r.guide_state if (r is not None and r.guide is not None)
             else 0 for r in reqs], torch.int32)
        return True, self._dev_gtables, states

    def _host_guide_mask(self, reqs):
        """Bool mask [len(reqs), vocab] on the device for a host-side
        sample call over these requests (None: an empty slot), from each
        guide's current state; None when no request is guided."""
        if not any(r is not None and r.guide is not None for r in reqs):
            return None
        m = np.ones((len(reqs), self.c.vocab), bool)
        for j, r in enumerate(reqs):
            if r is not None and r.guide is not None:
                m[j] = r.guide.table[r.guide_state] >= 0
        return self._upload(m)

    @staticmethod
    def _advance_guide(req: Request, tok: int):
        if req.guide is not None:
            req.guide_state = max(int(req.guide.table[req.guide_state,
                                                      tok]), 0)

    def _sync_sampling(self) -> bool:
        temps, top_ps, top_ks = self._sampling_arrays()
        fp = (temps.tobytes(), top_ps.tobytes(), top_ks.tobytes())
        if fp != self._dev_sampling_fp:
            self._dev_sampling = (self._upload(temps), self._upload(top_ps),
                                  self._upload(top_ks))
            self._dev_sampling_fp = fp
        return bool((top_ks != 0).any() or (top_ps < 1.0).any())

    def _run_window(self) -> dict[int, int]:
        """Decode up to a bucketed number of tokens per slot with one host
        readback (see decode_window)."""
        e = self.e
        page = e.page_size
        # Window size: the max remaining work across slots — slots that
        # finish earlier keep "decoding" into scratch and the host
        # discards their overshoot, which is cheaper than another fence.
        # Only a pool-starved slot binds the window down to its room.
        rems = [self.slot_req[i].max_new_tokens
                - len(self.slot_req[i].generated)
                for i in range(e.max_slots)
                if self.active[i] and self.slot_req[i] is not None]
        horizon = max(1, min(self._win_buckets[-1], max(rems, default=1)))
        if self.queue:
            # Requests are waiting to admit: keep windows short so
            # admission interleaves with decode.
            horizon = min(horizon, 8)
        if not self._grow_pages(horizon):
            return {}
        limit = horizon
        for i in range(e.max_slots):
            if not self.active[i]:
                continue
            room = len(self.slot_pages[i]) * page - int(self.lengths[i])
            rem = (self.slot_req[i].max_new_tokens
                   - len(self.slot_req[i].generated))
            if room < min(horizon, rem):
                limit = min(limit, max(room, 1))
        if limit == horizon:
            # Round UP to one window: overshoot is discarded.
            k_bucket = min(b for b in self._win_buckets if b >= limit)
        else:
            # Pool-starved slot: its room is a hard bound — round DOWN.
            k_bucket = max(b for b in self._win_buckets if b <= limit)
        trunc = self._sync_sampling()
        guided, gtables_d, gstates_d = self._sync_guides()
        want_logp = any(
            self.slot_req[i] is not None and self.slot_req[i].logprobs
            for i in range(e.max_slots) if self.active[i])
        self._sync_device_state()
        tables = self._upload(self._build_tables())
        toks_d, lens_d, act_d = self._dev
        temps_d, tps_d, tks_d = self._dev_sampling
        toks_d, lens_d, act_d, out_d, logp_d = decode_window(
            self.params, self.cache_k, self.cache_v, toks_d, lens_d, act_d,
            tables, temps_d, tps_d, tks_d, gtables_d, gstates_d, self._gen,
            self.c, eos_token=int(e.eos_token), n_steps=k_bucket,
            trunc=trunc, guided=guided, want_logp=want_logp,
            fused=self._fused)
        self.decode_steps += k_bucket
        self._dev = (toks_d, lens_d, act_d)
        out = out_d.cpu().numpy()  # one readback per window
        logps = logp_d.cpu().numpy() if want_logp else None
        emitted: dict[int, int] = {}
        for k in range(out.shape[0]):
            for i in range(e.max_slots):
                tok = int(out[k, i])
                if tok < 0 or not self.active[i]:
                    continue
                req = self.slot_req[i]
                if req.logprobs:
                    req.token_logprobs.append(float(logps[k, i]))
                req.generated.append(tok)
                emitted[req.request_id] = tok
                self.lengths[i] += 1
                self.last_tokens[i] = tok
                if self.lengths[i] < e.max_len:
                    self.hist[i, self.lengths[i]] = tok
                self._advance_guide(req, tok)
                self._maybe_finish(i, tok)
                if not self.active[i] and tok != e.eos_token:
                    # Finished by max_new/max_len: the device still thinks
                    # this slot is live — resync before the next window.
                    self._dev_dirty = True
        # The plain window did not advance the device history: upload it
        # afresh before the next speculative window.
        self._dev_hist = None
        return emitted

    def _spec_applicable(self) -> bool:
        """Speculation serves greedy and plain-temperature slots (delta-
        proposal rejection sampling keeps sampled outputs exact); top-k /
        top-p truncation, guided decoding and logprobs route the window to
        the plain path."""
        if not self._spec:
            return False
        for i in range(self.e.max_slots):
            r = self.slot_req[i]
            if not self.active[i] or r is None:
                continue
            if (r.top_k != 0 or r.top_p < 1.0 or r.guide is not None
                    or r.logprobs):
                return False
        return True

    def _run_window_spec(self) -> dict[int, int] | None:
        """Speculative window: `iters` draft+verify iterations, each
        emitting 1..spec_k+1 tokens per slot, with one host readback.
        Returns None to fall back to the plain window (a pool-starved slot
        needs its token-granular room binding)."""
        e = self.e
        page = e.page_size
        K = e.spec_k
        rems = [self.slot_req[i].max_new_tokens
                - len(self.slot_req[i].generated)
                for i in range(e.max_slots)
                if self.active[i] and self.slot_req[i] is not None]
        # Size the window by the expected tokens per iteration (acceptance
        # EMA), not the optimistic K+1: at low acceptance a short window
        # would finish a fraction of the work and pay the readback again.
        expected = 1.0 + self._spec_alpha * K
        iters = max(1, -(-int(max(rems, default=1)) // max(int(expected),
                                                           1)))
        if self.queue:
            iters = min(iters, 2)  # keep admission interleaving
        iters = min(next((b for b in self._win_buckets if b >= iters),
                         self._win_buckets[-1]), self._win_buckets[-1])
        if not self._grow_pages(iters * (K + 1)):
            return {}
        for i in range(e.max_slots):
            if not self.active[i]:
                continue
            room = len(self.slot_pages[i]) * page - int(self.lengths[i])
            rem = (self.slot_req[i].max_new_tokens
                   - len(self.slot_req[i].generated))
            if room < min(K + 1, rem):
                return None  # pool-starved: plain window binds per-token
        self._sync_device_state()
        if self._dev_hist is None:
            self._dev_hist = self._upload(self.hist)
        tables = self._upload(self._build_tables())
        self._sync_sampling()
        temps_d = self._dev_sampling[0]
        toks_d, lens_d, act_d = self._dev
        toks_d, lens_d, act_d, self._dev_hist, out_d = decode_window_spec(
            self.params, self.cache_k, self.cache_v, toks_d, lens_d, act_d,
            self._dev_hist, tables, temps_d, self._gen, self.c,
            eos_token=int(e.eos_token), n_steps=iters, spec_k=K,
            fused=self._fused)
        self.verify_steps += iters
        self._dev = (toks_d, lens_d, act_d)
        out = out_d.cpu().numpy()  # [iters, B, K+1]; one readback
        w_draft = w_acc = 0
        emitted: dict[int, int] = {}
        for it in range(out.shape[0]):
            for i in range(e.max_slots):
                if not self.active[i]:
                    continue
                row = out[it, i]
                n_emit = int((row >= 0).sum())
                if n_emit == 0:
                    continue
                self.spec_drafted += K
                self.spec_accepted += n_emit - 1
                w_draft += K
                w_acc += n_emit - 1
                for j in range(K + 1):
                    tok = int(row[j])
                    if tok < 0:
                        continue
                    if not self.active[i]:
                        self._dev_dirty = True  # overshoot past host finish
                        break
                    req = self.slot_req[i]
                    req.generated.append(tok)
                    emitted[req.request_id] = tok
                    self.lengths[i] += 1
                    self.last_tokens[i] = tok
                    if self.lengths[i] < e.max_len:
                        self.hist[i, self.lengths[i]] = tok
                    self._maybe_finish(i, tok)
                    if not self.active[i] and tok != e.eos_token:
                        self._dev_dirty = True
        if w_draft:
            self._spec_alpha = (0.5 * self._spec_alpha
                                + 0.5 * (w_acc / w_draft))
        return emitted

    def step_window(self) -> dict[int, int]:
        """Admit queued prompts, then decode a whole window: speculative
        when the engine speculates and every active request allows it,
        else plain (the dense layout: one `step`)."""
        if not self.paged:
            return self.step()
        emitted = self._admit()
        if self.active.any():
            upd = (self._run_window_spec() if self._spec_applicable()
                   else None)
            if upd is None:
                upd = self._run_window()
            emitted.update(upd)
        return emitted

    # ---- conveniences ----

    def generate(self, prompts: list, max_new_tokens=None,
                 temperature=None) -> list[list[int]]:
        """Blocking batch generate; returns generated token ids per prompt
        (continuous batching underneath — more prompts than max_slots
        stream through)."""
        ids = [self.add_request(p, max_new_tokens, temperature)
               for p in prompts]
        while self.has_work():
            self.step_window()
        out = []
        for rid in ids:
            gen = self.finished.pop(rid).generated
            if gen and gen[-1] == self.e.eos_token:
                gen = gen[:-1]
            out.append(gen)
        return out


class PrefillEngine:
    """Prefill-only engine of disaggregated serving: runs the bucketed
    prefill, samples the first continuation token and exports the prompt
    KV for a decode engine's `import_kv`; it owns no decode cache, slots
    or pages. The exported K is post-RoPE at absolute positions, so the
    decode engine splices it in verbatim."""

    def __init__(self, model_config: ModelConfig,
                 engine_config: EngineConfig | None = None, *,
                 params=None, mesh=None, rules=None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.e = engine_config or EngineConfig()
        self.mesh = mesh
        self.params, self.c = _resolve_params(model_config, params, seed,
                                              self.device, mesh, rules)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def prefill_export(self, prompt_tokens, temperature=None,
                       top_p: float = 1.0, top_k: int = 0,
                       want_logp: bool = False):
        """-> (first_token, ks, vs[, first_logp]): the sampled
        continuation token and the prompt's full-page KV as CPU tensors of
        the model's dtype, [L, S, hkv, hd] with S the page-aligned prefix
        length (0 when the prompt spans less than one full page, and a
        page-aligned prompt's last page left out: the decode side always
        re-prefills at least one token). Greedy picks equal the decode
        engine's. `want_logp` also returns log p(first_token) under the
        unmasked distribution."""
        ids = list(map(int, prompt_tokens))
        n = len(ids)
        toks = np.zeros((1, _prompt_bucket(self.e, n)), np.int64)
        toks[0, :n] = ids
        logits, ks, vs = prefill(
            self.params, torch.tensor(toks, device=self.device), self.c)
        row = logits[n - 1]
        first = _sample_one(row, self.e.default_temperature
                            if temperature is None else temperature,
                            top_p, top_k, self._gen)
        page = self.e.page_size
        full = n // page
        if full * page == n:
            full -= 1
        cut = max(full, 0) * page
        ks_out, vs_out = ks[:, :cut].cpu(), vs[:, :cut].cpu()
        if not want_logp:
            return first, ks_out, vs_out
        return (first, ks_out, vs_out,
                float(torch.log_softmax(row, dim=-1)[first]))
