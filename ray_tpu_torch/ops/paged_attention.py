"""Paged-KV decode attention (counterpart of `ray_tpu/ops/paged_attention.py`,
decode mode only).

Layouts (the port's pool layout, see `csrc/paged_decode.cu`):
  q                [B, n_heads, head_dim]
  k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim]
  lengths          [B] int32, attend positions < lengths
  page_tables      [B, P] int32 page ids in position order (0 = scratch)
Returns [B, n_heads, head_dim].

A slot attends at most P pages, and a slot with length 0 returns zeros
(the TPU kernel's semantics; its dense JAX reference gives NaN there).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build

# Launch counts: "cuda" counts kernel launches, "plain" counts calls that
# took the plain PyTorch version because the tensors lay on the CPU.
launches = {"cuda": 0, "plain": 0}

def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables):
    """Flash decode over paged KV: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _paged_decode_cuda(q, k_pages, v_pages, lengths, page_tables)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    launches["plain"] += 1
    return paged_decode_attention_reference(q, k_pages, v_pages, lengths,
                                            page_tables)


def paged_decode_attention_reference(q, k_pages, v_pages, lengths,
                                     page_tables):
    """Plain version: gather the pages densely, mask, softmax in fp32."""
    B, h, hd = q.shape
    hkv, _n, page, _ = k_pages.shape
    g = h // hkv
    P = page_tables.shape[1]
    T = P * page
    idx = page_tables.long()
    # [hkv, B, P, page, hd] -> [B, hkv, T, hd]
    ck = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, hkv, T, hd)
    cv = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, hkv, T, hd)
    q4 = q.reshape(B, hkv, g, hd).float()
    s = torch.einsum("bkgd,bktd->bkgt", q4, ck.float())
    s = s * (1.0 / math.sqrt(hd))
    pos = torch.arange(T, device=q.device)
    mask = pos[None, None, None] < lengths[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    pr = torch.softmax(s, dim=-1)
    pr = torch.where(lengths[:, None, None, None] > 0, pr, 0.0)
    out = torch.einsum("bkgt,bktd->bkgd", pr, cv.float())
    return out.reshape(B, h, hd).to(q.dtype)


@functools.cache
def _lib():
    lib = _build.load("paged_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                    ctypes.c_float, i, p]
    lib.rt_paged_decode.restype = i
    return lib


def _paged_decode_cuda(q, k_pages, v_pages, lengths, page_tables):
    B, h, hd = q.shape
    hkv, num_pages, page, hd_k = k_pages.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_decode: unsupported dtype {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode: q and the pools must share a dtype")
    if lengths.dtype != torch.int32 or page_tables.dtype != torch.int32:
        raise TypeError("paged_decode: lengths and page_tables must be int32")
    if (v_pages.shape != k_pages.shape or hd_k != hd or h % hkv
            or lengths.shape != (B,) or page_tables.dim() != 2
            or page_tables.shape[0] != B):
        raise ValueError(
            f"paged_decode: bad shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} lengths "
            f"{tuple(lengths.shape)} tables {tuple(page_tables.shape)}")
    if hd not in (64, 128) or not 1 <= h // hkv <= 8:
        raise ValueError(f"paged_decode: kernel supports head_dim 64/128 and "
                         f"1-8 query heads per kv head, got hd={hd}, "
                         f"h={h}, hkv={hkv}")
    ts = (q, k_pages, v_pages, lengths, page_tables)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_decode: all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode: inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            B, hkv, h // hkv, hd, num_pages, page, page_tables.shape[1],
            1.0 / math.sqrt(hd), _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "paged_decode")
    launches["cuda"] += 1
    return out
