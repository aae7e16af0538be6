"""Ring attention (counterpart of `ray_tpu/parallel/ring_attention.py`).

Blockwise ring attention (Liu et al.): the sequence is cut over the "sp"
mesh axis; at each step every rank attends its local Q block to the KV
block it holds, then passes the KV block to the next rank of the ring
(`collectives.ppermute`). The JAX package runs this inside `shard_map`;
the port runs one process per rank, so every entry point here takes and
returns this rank's local blocks, [batch, seq / sp, heads, head_dim]:
what `shard_map` hands each device under the spec P(None, "sp", None,
None).

Two forms of the ring:
- the plain ring (`impl="jnp"`, `_ring_plain`): dense fp32 block
  attention with an explicit mask per step and running (out, max, sum)
  accumulators, differentiated by autograd through the loop and through
  `ppermute`'s backward;
- the kernel ring (`impl="pallas"`, and "auto" on CUDA tensors), one
  autograd Function, `_RingKernel`. Each forward step runs the flash
  forward kernel (K2, `ops.attention.flash_attention_fwd`) with lse, in
  the mode the source block asks for: skipped (a block wholly after this
  rank's under causal masking: nothing launches), full, or diagonal
  (causal). The partials merge in fp32 by normalized output and
  logsumexp, in the kernels' flat [batch * heads, seq] lse layout. The
  backward is the ring's, not autograd's: the forward saves (q, k, v, out,
  lse), and each backward step runs the dQ and dK/dV kernels (K3, K4,
  `flash_attention_bwd`) on the merged (out, lse) against the KV block in
  hand; dQ accumulates locally while the fp32 dK/dV accumulators travel
  with their KV blocks and arrive home after the full pass.
  `impl="interpret"` wires the plain per-step versions (`_plain_fwd`,
  `flash_attention_bwd_reference`) the same way: the JAX package's
  Pallas interpreter has no CUDA counterpart.

Communication: sp - 1 rotations of the KV block forward (the forward's
last rotation would carry nothing the loop reads, so it is left out); sp
rotations of the (KV, dKV) blocks backward, the KV's last one left out,
the dKV's last one bringing them home. A ring of one (no mesh, or sp = 1)
is one diagonal step.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops import attention as A
from ray_tpu_torch.parallel.collectives import _permute, ppermute, ring_perm
from ray_tpu_torch.parallel.mesh import axis_group, mesh_degrees

# Finite, as the JAX package's: with -inf, exp(-inf - -inf) is NaN.
NEG_INF = -1e30

# Per-step modes of the kernel ring.
SKIP, FULL, DIAG = 0, 1, 2


def _group_rank(group) -> tuple[int, int]:
    """(ring size, this rank's place on it) of a group (None: 1, 0)."""
    import torch.distributed as dist
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _mode(src: int, idx: int, causal: bool) -> int:
    """The step's mode from the global block id `src` of the KV block in
    hand and this rank's `idx`."""
    if not causal or src < idx:
        return FULL
    return DIAG if src == idx else SKIP


# ---------------------------------------------------------------------------
# the plain ring (oracle)
# ---------------------------------------------------------------------------


def _block_attn(q, k, v, scale, mask):
    """One Q-block x KV-block step in fp32: (partial out [B, Lq, H, D],
    row max [B, H, Lq], row sum [B, H, Lq]). mask [Lq, Lk] (True = keep)
    or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    # rows with no visible key: a finite max so that exp underflows to 0
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m_safe, p.sum(-1)


def _merge(acc, o, m, l):
    """A new block merged into the running (out, max, sum)."""
    acc_o, acc_m, acc_l = acc
    new_m = torch.maximum(acc_m, m)
    alpha = torch.exp(acc_m - new_m)            # rescale the old
    beta = torch.exp(m - new_m)                 # rescale the new
    new_o = (acc_o * alpha.transpose(1, 2)[..., None]
             + o * beta.transpose(1, 2)[..., None])
    return new_o, new_m, acc_l * alpha + l * beta


def _ring_plain(q, k, v, group, causal: bool, scale: float):
    """The plain ring: every step computes, under a mask that is all, the
    causal diagonal or nothing, so that every rank runs the same graph
    (and so the same backward exchanges)."""
    n, idx = _group_rank(group)
    lq = q.shape[1]
    qf = q.float()
    diag = torch.ones(lq, lq, dtype=torch.bool, device=q.device).tril()
    acc = (torch.zeros(q.shape[:3] + (v.shape[-1],), device=q.device),
           torch.full((q.shape[0], q.shape[2], lq), NEG_INF,
                      device=q.device),
           torch.zeros((q.shape[0], q.shape[2], lq), device=q.device))
    cur_k, cur_v = k.float(), v.float()
    for t in range(n):
        mask = None
        if causal:
            mode = _mode((idx - t) % n, idx, causal)
            mask = (torch.ones_like(diag) if mode == FULL else diag
                    if mode == DIAG else torch.zeros_like(diag))
        acc = _merge(acc, *_block_attn(qf, cur_k, cur_v, scale, mask))
        if t < n - 1:
            cur_k = ppermute(cur_k, group, ring_perm(n))
            cur_v = ppermute(cur_v, group, ring_perm(n))
    acc_o, _, acc_l = acc
    out = acc_o / torch.clamp(acc_l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel ring
# ---------------------------------------------------------------------------


def _ring_block(l_local: int) -> int:
    """Tile that divides the local chunk (<= 512), as the JAX package's
    Pallas ring picks it; the port's kernels mask a ragged chunk
    themselves, so only an explicit kernel impl checks it."""
    return math.gcd(l_local, 512)


def _heads_major(lse_flat, b: int, h: int, lq: int):
    """A flat [B*H, L] row statistic as [B, L, H, 1], to scale outputs."""
    return lse_flat.reshape(b, h, lq).transpose(1, 2)[..., None]


def _merge_normalized(o_acc, lse_acc, o_t, lse_t):
    """Two (normalized out [B, L, H, D] fp32, lse [B*H, L] fp32) partials
    merged: flash attention's online softmax on whole blocks."""
    b, lq, h, _ = o_acc.shape
    m = torch.maximum(lse_acc, lse_t)
    a = torch.exp(lse_acc - m)
    c = torch.exp(lse_t - m)
    denom = torch.clamp(a + c, min=1e-30)
    o = ((o_acc * _heads_major(a, b, h, lq) + o_t * _heads_major(c, b, h, lq))
         / _heads_major(denom, b, h, lq))
    return o, m + torch.log(denom)


def _rotate(group, *blocks) -> list:
    """The blocks passed one rank on around the ring, in one exchange (one
    staging through the host on gloo): their bytes packed into one buffer
    and unpacked as they were (wider dtypes first, so each block's offset
    is a multiple of its element size)."""
    n, _ = _group_rank(group)
    if n == 1:
        return list(blocks)
    flat = [b.contiguous().reshape(-1).view(torch.uint8) for b in blocks]
    got = _permute(torch.cat(flat), group, ring_perm(n))
    out, at = [], 0
    for b, f in zip(blocks, flat):
        out.append(got[at:at + f.numel()].view(b.dtype).reshape(b.shape))
        at += f.numel()
    return out


def _step_fwd(q, k, v, causal, scale, kernel):
    """One forward step: (out in q's dtype, lse [B*H, L] fp32)."""
    if kernel:
        return A.flash_attention_fwd(q, k, v, causal, scale, with_lse=True)
    return A._plain_fwd(q, k, v, causal, scale, with_lse=True)


def _step_bwd(q, k, v, out, lse, g, causal, scale, kernel):
    """One backward step on the merged (out, lse): (dq, dk, dv)."""
    if kernel:
        return A.flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    return A.flash_attention_bwd_reference(q, k, v, out, lse, g, causal,
                                           scale)


def _ring_fwd_loop(q, k, v, group, causal, scale, kernel):
    """(out [B, L, H, D] fp32, lse [B*H, L] fp32) of this rank's rows."""
    n, idx = _group_rank(group)
    b, lq, h, _ = q.shape
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b * h, lq), NEG_INF, dtype=torch.float32,
                         device=q.device)
    cur_k, cur_v = k, v
    for t in range(n):
        mode = _mode((idx - t) % n, idx, causal)
        if mode != SKIP:
            # a skipped step's zeros and NEG_INF merge to the same bits
            o_t, lse_t = _step_fwd(q, cur_k, cur_v, mode == DIAG, scale,
                                   kernel)
            o_acc, lse_acc = _merge_normalized(o_acc, lse_acc, o_t.float(),
                                               lse_t)
        if t < n - 1:
            cur_k, cur_v = _rotate(group, cur_k, cur_v)
    return o_acc, lse_acc


class _RingKernel(torch.autograd.Function):
    """The kernel ring with its ring-level backward; saves only the local
    (q, k, v, out, lse): the backward re-rotates the KV blocks."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, kernel):
        out, lse = _ring_fwd_loop(q, k, v, group, causal, scale, kernel)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.kernel = (group, causal, scale,
                                                        kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, idx = _group_rank(group)
        g = g.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        cur_k, cur_v = k, v
        for t in range(n):
            mode = _mode((idx - t) % n, idx, causal)
            if mode != SKIP:
                dq_t, dk_t, dv_t = _step_bwd(q, cur_k, cur_v, out, lse, g,
                                             mode == DIAG, ctx.scale,
                                             ctx.kernel)
                dq += dq_t.float()
                dk += dk_t.float()
                dv += dv_t.float()
            # dK/dV travel WITH their KV blocks: after the full pass each
            # block arrives home carrying every rank's contribution
            if t < n - 1:
                dk, dv, cur_k, cur_v = _rotate(group, dk, dv, cur_k, cur_v)
            else:
                dk, dv = _rotate(group, dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention_inner(q, k, v, group, causal: bool = True,
                         scale: float | None = None, impl: str = "jnp"):
    """This rank's ring pass over `group` (the sp axis's process group,
    None for a ring of one). q, k, v: [batch, seq_local, heads,
    head_dim], kv heads equal to q heads (the GQA repeat happens before
    the call). impl: "pallas" (the kernels), "interpret" (their plain
    versions, wired as the kernels are) or "jnp" (the plain ring)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if impl in ("pallas", "interpret"):
        kernel = impl == "pallas"
        if kernel:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return _RingKernel.apply(q, k, v, group, causal, scale, kernel)
    if impl != "jnp":
        raise ValueError(f"unknown ring_attention impl {impl!r}")
    return _ring_plain(q, k, v, group, causal, scale)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   q_spec: tuple | None = None, impl: str = "auto"):
    """Ring attention over the mesh axis `axis_name`: q, k, v are this
    rank's local blocks [batch, seq / sp, heads, head_dim] (every rank of
    the mesh calls alike), the result this rank's block of the output.
    `mesh` None is a ring of one.

    `q_spec` is the spec the blocks were cut by (the JAX package's
    `shard_map` in_spec; default (None, axis_name, None, None)): its
    sequence entry must name `axis_name`; its other entries say how the
    caller cut the rest and change nothing here.

    impl: "auto" (the kernels on CUDA tensors, the plain ring on the CPU),
    "pallas" (the kernels; CUDA tensors only), "interpret" (the plain
    per-step versions wired as the kernels are) or "jnp" (the plain
    ring). As in the JAX package, an explicit kernel impl refuses a local
    chunk with no tile divisor of at least 8; "auto" takes the kernels on
    CUDA at any length, since the port's kernels mask a ragged chunk."""
    spec = q_spec if q_spec is not None else (None, axis_name, None, None)
    if len(spec) != 4 or spec[1] != axis_name:
        raise ValueError(f"ring_attention: q_spec {spec} must cut the "
                         f"sequence (dim 1) over {axis_name!r}")
    n = 1 if mesh is None else mesh_degrees(mesh).get(axis_name, 1)
    group = axis_group(mesh, axis_name)
    if impl in ("pallas", "interpret") and _ring_block(q.shape[1]) < 8:
        raise ValueError(
            f"ring_attention(impl={impl!r}): local chunk {q.shape[1]} has "
            f"no tile divisor (gcd with 512 < 8); pad the sequence so "
            f"seq/{n} is a multiple of 128")
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "jnp"
    return ring_attention_inner(q, k, v, group, causal=causal, impl=impl)


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None):
    """Unsharded dense attention in fp32 (the tests' reference, and
    Ulysses's inner attention): [B, S, H, D] in, q's dtype out."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
