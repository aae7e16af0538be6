"""Flash attention forward (counterpart of `ray_tpu/ops/attention.py`).

`flash_attention` keeps the JAX package's [B, S, H, D] layout, its GQA head
mapping (head i reads kv head i // (H / Hkv), as `jnp.repeat` along the
head axis gives) and its `impl` switch. On a CUDA device it runs the
hand-written forward kernel (`csrc/flash_fwd.cu`), which masks a ragged S
in-kernel rather than padding to a tile multiple. The backward kernels,
and the ring/ulysses sequence-parallel paths, belong to later slices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Launch counts: "cuda" counts kernel launches, "plain" counts calls that
# ran the plain PyTorch version.
launches = {"cuda": 0, "plain": 0}

def _reference(q, k, v, scale, causal):
    """Plain version on [BH, S, D]: dense fp32 scores and softmax."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    impl: str = "auto"):
    """q: [B, S, H, D], k/v: [B, S, Hkv, D] -> [B, S, H, D].

    impl: "auto" (the CUDA kernel on a CUDA device, the plain version on
    the CPU), "pallas" (the CUDA kernel), "reference" or "interpret" (the
    plain version; the JAX package's Pallas interpreter has no CUDA
    counterpart)."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is sequence-parallel attention, which the "
            f"PyTorch port takes up in a later slice")
    if impl not in ("auto", "pallas", "reference", "interpret"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "reference"
    if impl == "pallas":
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, scale)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    launches["plain"] += 1
    qt = q.transpose(1, 2).reshape(b * h, s, d)
    kt = k.transpose(1, 2).reshape(b * h, s, d)
    vt = v.transpose(1, 2).reshape(b * h, s, d)
    out = _reference(qt, kt, vt, scale, causal)
    return out.reshape(b, h, s, d).transpose(1, 2)


@functools.cache
def _lib():
    lib = _build.load("flash_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                 ctypes.c_float, i, p]
    lib.rt_flash_fwd.restype = i
    return lib


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        with_lse: bool = False):
    """The CUDA forward kernel on [B, S, H, D] / [B, S, Hkv, D] tensors.
    Returns out, or (out, lse) with lse flat [B*H, S] fp32 when
    `with_lse` (the form the training and ring slices consume)."""
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError(
            "flash_attention: the CUDA kernel is forward-only in this slice "
            "(its backward kernels come with the training slice); run under "
            "torch.no_grad() or use impl='reference'")
    if q.device.type != "cuda":
        raise ValueError("flash_attention: the kernel path needs CUDA "
                         f"tensors, got {q.device}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv):
        raise ValueError(f"flash_attention: bad shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: the kernel supports head_dim "
                         f"64 or 128, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
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
