"""Flash attention, forward and backward (counterpart of
`ray_tpu/ops/attention.py`).

`flash_attention` keeps the JAX package's [B, S, H, D] layout, its GQA head
mapping (head i reads kv head i // (H / Hkv), as `jnp.repeat` along the
head axis gives) and its `impl` switch. On a CUDA device it runs the
hand-written kernels: the forward (`csrc/flash_fwd.cu`, K2) and, when a
gradient is needed, the dQ and dK/dV backward (`csrc/flash_bwd.cu`, K3
and K4) behind one `torch.autograd.Function`, the port's `custom_vjp`.
The kernels mask a ragged S themselves rather than padding to a tile
multiple. They run head_dims that are multiples of 8 (the JAX package's
Pallas condition), widths past 256 in 128-column chunks; the wrappers
zero-pad any other head_dim up to the next multiple of 8 and cut the
results back (`_build.padded_head_dim`), with the scale of the true
head_dim. The ring/ulysses sequence-parallel paths belong to a later
slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Launch counts per kernel: "cuda" counts kernel launches, "plain" counts
# calls that ran the plain PyTorch version. `launches` is the forward (K2);
# the backward's dQ (K3) and dK/dV (K4) count apart.
launches = {"cuda": 0, "plain": 0}
bwd_dq_launches = {"cuda": 0, "plain": 0}
bwd_dkv_launches = {"cuda": 0, "plain": 0}


def _causal_keep(s_len: int, device) -> torch.Tensor:
    return torch.ones(s_len, s_len, dtype=torch.bool, device=device).tril()


def _reference(q, k, v, scale, causal, with_lse: bool = False):
    """Plain version on [BH, S, D]: dense fp32 scores and softmax. With
    `with_lse`, also the per-row logsumexp [BH, S] fp32."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_keep(q.shape[1], q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def _plain_fwd(q, k, v, causal, scale, with_lse: bool = False):
    """The plain forward on the model's layout: [B, S, H, D] in, out in
    the same layout (and lse flat [B*H, S] when asked)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    launches["plain"] += 1
    qt, kt, vt = (x.transpose(1, 2).reshape(b * h, s, d) for x in (q, k, v))
    res = _reference(qt, kt, vt, scale, causal, with_lse)
    out = res[0] if with_lse else res
    out = out.reshape(b, h, s, d).transpose(1, 2)
    return (out, res[1]) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    """K2 with lse forward; delta, K3 and K4 backward (the plain versions
    of the same wiring when `kernel` is False). For the kernels q, k and v
    are zero-padded once to `padded_head_dim` here, saved so, and the
    output and dq, dk, dv cut back once. Saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kernel):
        d = q.shape[-1]
        if kernel:
            q, k, v = _build.pad_cols(_build.padded_head_dim(d), q, k, v)
        fwd = flash_attention_fwd if kernel else _plain_fwd
        out, lse = fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kernel, ctx.d = causal, scale, kernel, d
        return out if out.shape[-1] == d else out[..., :d].contiguous()

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not ctx.kernel:
            return (*flash_attention_bwd_reference(
                q, k, v, o, lse, do, ctx.causal, ctx.scale), None, None, None)
        d = ctx.d
        do, = _build.pad_cols(q.shape[-1], do)
        grads = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale)
        if q.shape[-1] != d:
            grads = [g[..., :d].contiguous() for g in grads]
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    impl: str = "auto"):
    """q: [B, S, H, D], k/v: [B, S, Hkv, D] -> [B, S, H, D].

    impl: "auto" (the CUDA kernels on a CUDA device, their plain versions
    on the CPU), "pallas" (the CUDA kernels), "interpret" (the plain
    versions, wired as the kernels are: the JAX package's Pallas
    interpreter has no CUDA counterpart) or "reference" (the plain dense
    forward, differentiated by autograd: the numerics oracle). The lse is
    computed only when a gradient is needed."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is sequence-parallel attention, which the "
            f"PyTorch port takes up in a later slice")
    if impl not in ("auto", "pallas", "reference", "interpret"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if impl == "reference":
        return _plain_fwd(q, k, v, causal, scale)
    kernel = impl == "pallas" or (impl == "auto" and q.device.type == "cuda")
    if kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, kernel)
    if kernel:
        return flash_attention_fwd(q, k, v, causal, scale)
    return _plain_fwd(q, k, v, causal, scale)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool,
                                  scale: float):
    """Plain backward by the explicit recompute formulas (not autograd):
    P = exp(S*scale - lse), dP = dO V^T, delta = rowsum(dO*O),
    dS = P (dP - delta) scale; dQ = dS K, dK = dS^T Q, dV = P^T dO, with P
    and dS rounded to the input dtype before their products as the kernels
    do, and dK/dV summed over each kv head's query group."""
    bwd_dq_launches["plain"] += 1
    bwd_dkv_launches["plain"] += 1
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dt = q.dtype
    heads = lambda x: x.float().transpose(1, 2)  # noqa: E731  [B, H, S, D]
    qf = heads(q)
    kf = heads(k.repeat_interleave(h // hkv, dim=2))
    vf = heads(v.repeat_interleave(h // hkv, dim=2))
    dof = heads(do.to(dt))
    sc = qf @ kf.transpose(-1, -2) * scale
    if causal:
        sc = torch.where(_causal_keep(s, q.device), sc, NEG_INF)
    p = torch.exp(sc - lse.float().reshape(b, h, s, 1))
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * heads(o)).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    group = lambda x: (x.reshape(b, hkv, h // hkv, s, d).sum(2)  # noqa: E731
                       .transpose(1, 2).to(dt))
    return dq.transpose(1, 2).to(dt), group(dk), group(dv)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) of attention on the model's layout, from the forward's
    output `o` [B, S, H, D] and logsumexp `lse` flat [B*H, S] fp32 (any
    such pair, not only one the forward kernel produced: the ring backward
    passes merged ones). On CUDA tensors: delta = rowsum(dO*O) in plain
    torch, then the dQ kernel (K3) and the dK/dV kernel (K4), the inputs
    padded once to `padded_head_dim` and the grads cut back once. On CPU
    tensors: the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale)
    b, s, h, d = q.shape
    do = do.to(q.dtype).contiguous()
    delta = ((do.float() * o.float()).sum(-1)     # [B, S, H] -> [B*H, S]
             .transpose(1, 2).reshape(b * h, s).contiguous())
    d8 = _build.padded_head_dim(d)
    q, k, v, do = _build.pad_cols(d8, q, k, v, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    if d8 == d:
        return dq, dk, dv
    return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))


@functools.cache
def _lib():
    lib = _build.load("flash_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                 ctypes.c_float, i, p]
    lib.rt_flash_fwd.restype = i
    return lib


@functools.cache
def _bwd_lib():
    lib = _build.load("flash_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, i, p]
    lib.rt_flash_bwd_dq.restype = i
    lib.rt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i,
                                                         p]
    lib.rt_flash_bwd_dkv.restype = i
    return lib


def _check_inputs(what, q, k, v, *more):
    """Device, dtype, shape and contiguity checks shared by the kernel
    wrappers; `more` are further [B, S, H, D] tensors of q's dtype.
    Returns (B, S, H, Hkv, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if (q.dtype not in _build.DTYPE_CODES
            or any(t.dtype != q.dtype for t in (k, v, *more))):
        raise TypeError(f"{what}: dtypes {[str(t.dtype) for t in (q, k, v)]}"
                        f"; the kernel takes float32 or bfloat16")
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{what}: bad shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    _build.check_head_dim(what, D)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the kernel path needs CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError(f"{what}: inputs must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v, *more)):
        raise ValueError(f"{what}: inputs must be contiguous")
    return B, S, H, Hkv, D


def _check_rows(what, q, *rows):
    """lse/delta: flat [B*H, S] fp32, contiguous, on q's device."""
    B, S, H, _ = q.shape
    for t in rows:
        if (t.shape != (B * H, S) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: lse/delta must be contiguous fp32 "
                             f"[{B * H}, {S}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        with_lse: bool = False):
    """The CUDA forward kernel (K2) on [B, S, H, D] / [B, S, Hkv, D]
    tensors. Returns out, or (out, lse) with lse flat [B*H, S] fp32 when
    `with_lse` (the form the backward and the ring slice consume)."""
    B, S, H, Hkv, D = _check_inputs("flash_attention", q, k, v)
    D8 = _build.padded_head_dim(D)
    if D8 != D:
        res = flash_attention_fwd(*_build.pad_cols(D8, q, k, v), causal,
                                  scale, with_lse)
        out = (res[0] if with_lse else res)[..., :D].contiguous()
        return (out, res[1]) if with_lse else out
    out = torch.empty_like(q)
    lse = (torch.empty(B * H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, S, H, Hkv, D, int(bool(causal)), float(scale),
            _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "flash_fwd")
    launches["cuda"] += 1
    return (out, lse) if with_lse else out


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dQ kernel (K3): dq [B, S, H, D] from q/do [B, S, H, D], k/v
    [B, S, Hkv, D] and lse/delta flat [B*H, S] fp32."""
    B, S, H, Hkv, D = _check_inputs("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse, delta)
    D8 = _build.padded_head_dim(D)
    if D8 != D:
        return flash_bwd_dq(*_build.pad_cols(D8, q, k, v, do), lse, delta,
                            causal, scale)[..., :D].contiguous()
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, S, H, Hkv, D, int(bool(causal)), float(scale),
            _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "flash_bwd_dq")
    bwd_dq_launches["cuda"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dK/dV kernel (K4): (dk, dv) [B, S, Hkv, D], each summed over
    its kv head's query group inside the kernel."""
    B, S, H, Hkv, D = _check_inputs("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    D8 = _build.padded_head_dim(D)
    if D8 != D:
        dk, dv = flash_bwd_dkv(*_build.pad_cols(D8, q, k, v, do), lse,
                               delta, causal, scale)
        return dk[..., :D].contiguous(), dv[..., :D].contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, Hkv, D, int(bool(causal)), float(scale),
            _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "flash_bwd_dkv")
    bwd_dkv_launches["cuda"] += 1
    return dk, dv
