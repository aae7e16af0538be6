"""Paged-KV attention (counterpart of `ray_tpu/ops/paged_attention.py`):
decode (K1, `csrc/paged_decode.cu`), speculative verify (K1') and verify
with the KV insert fused in (K5), both in `csrc/paged_verify.cu`.

Layouts (the port's pool layout, see `csrc/paged_decode.cu`):
  q                [B, n_heads, head_dim]; verify: [B, S, n_heads, head_dim]
  k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim]
      (the engine's stacked pools: [n_layers, n_kv_heads, ...])
  lengths          [B] int32, attend positions < lengths (verify: query j
                   attends positions < lengths + j)
  page_tables      [B, P] int32 page ids in position order (0 = scratch)
Returns q's shape.

A slot attends at most P pages, and a query row with nothing to attend
returns zeros (the TPU kernel's semantics; its dense JAX reference gives
NaN there).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build

# Launch counts: "cuda" counts kernel launches, "plain" counts calls that
# took the plain PyTorch version because the tensors lay on the CPU.
launches = {"cuda": 0, "plain": 0}               # K1, paged decode
verify_launches = {"cuda": 0, "plain": 0}        # K1', paged verify
verify_insert_launches = {"cuda": 0, "plain": 0}  # K5, fused verify-insert

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


# ---- speculative verify: K1' and K5 ----


def paged_verify_attention(q, k_pages, v_pages, lengths, page_tables):
    """Multi-query paged attention (K1'): q [B, S, h, hd] holds S query
    tokens per slot at consecutive positions whose KV is already in the
    pool; query j attends positions < lengths + j. Returns [B, S, h, hd].
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _verify_cuda(q, k_pages, v_pages, None, None, lengths,
                            page_tables, "paged_verify")
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    verify_launches["plain"] += 1
    return paged_verify_attention_reference(q, k_pages, v_pages, lengths,
                                            page_tables)


def paged_verify_attention_reference(q, k_pages, v_pages, lengths,
                                     page_tables):
    """Plain version of K1': gather the pages densely, per-query causal
    mask (query j: pos < lengths + j), softmax in fp32."""
    B, S, h, hd = q.shape
    hkv, _n, page, _ = k_pages.shape
    g = h // hkv
    P = page_tables.shape[1]
    T = P * page
    idx = page_tables.long()
    ck = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, hkv, T, hd)
    cv = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, hkv, T, hd)
    q5 = q.reshape(B, S, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
    s = torch.einsum("bkgsd,bktd->bkgst", q5, ck.float())
    s = s * (1.0 / math.sqrt(hd))
    limit = lengths[:, None] + torch.arange(S, device=q.device)[None]
    mask = (torch.arange(T, device=q.device)[None, None, None, None]
            < limit[:, None, None, :, None])
    s = s.masked_fill(~mask, float("-inf"))
    pr = torch.softmax(s, dim=-1)
    pr = torch.where(limit[:, None, None, :, None] > 0, pr, 0.0)
    out = torch.einsum("bkgst,bktd->bkgsd", pr, cv.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, h, hd).to(q.dtype)


def paged_verify_insert_attention(q, pool_k, pool_v, knew, vnew, lengths,
                                  page_tables, layer: int):
    """Fused insert + verify attention (K5) against one layer of the
    stacked pools [L, hkv, N, page, hd]. knew/vnew [B, S, hkv, hd] are the
    S new tokens' K/V, written (as exact copies) into pool[layer] at
    positions lengths-1 ... lengths+S-2, in place; query j attends
    positions < lengths + j. Returns (attn [B, S, h, hd], pool_k, pool_v):
    the pools that came in, as the JAX function's aliasing returns them.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        if not 0 <= layer < pool_k.shape[0]:
            raise ValueError(f"paged_verify_insert: layer {layer} out of "
                             f"range for pools of {pool_k.shape[0]} layers")
        attn = _verify_cuda(q, pool_k[layer], pool_v[layer], knew, vnew,
                            lengths, page_tables, "paged_verify_insert")
        return attn, pool_k, pool_v
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    verify_insert_launches["plain"] += 1
    return paged_verify_insert_reference(q, pool_k, pool_v, knew, vnew,
                                         lengths, page_tables, layer)


def paged_verify_insert_reference(q, pool_k, pool_v, knew, vnew, lengths,
                                  page_tables, layer: int):
    """Plain version of K5, the JAX package's `_verify_insert_xla`: insert
    the new tokens (`insert_tokens_reference`), then the plain verify
    attention over pool[layer]."""
    insert_tokens_reference(pool_k, pool_v, knew, vnew, lengths,
                            page_tables, layer)
    out = paged_verify_attention_reference(q, pool_k[layer], pool_v[layer],
                                           lengths, page_tables)
    return out, pool_k, pool_v


def insert_tokens_reference(pool_k, pool_v, knew, vnew, lengths,
                            page_tables, layer: int):
    """Token scatter of the S new tokens' K/V into pool[layer], in place
    (the JAX package's `_insert_tokens_xla`): token j of slot b goes to
    page tables[b, (lengths-1+j) // page] at offset (lengths-1+j) % page;
    a position past the table's P pages goes to scratch page 0."""
    S = knew.shape[1]
    page = pool_k.shape[3]
    P = page_tables.shape[1]
    positions = (lengths - 1)[:, None].long() + torch.arange(
        S, device=knew.device)[None]
    pidx = positions // page                     # floor division, as jnp
    w_page = page_tables.gather(1, pidx.clamp(0, P - 1)).long()
    w_page = torch.where(pidx >= P, 0, w_page)
    w_off = positions % page                     # floor modulo, as jnp
    pk, pv = pool_k[layer], pool_v[layer]        # views into the pools
    pk[:, w_page, w_off] = knew.permute(2, 0, 1, 3).to(pk.dtype)
    pv[:, w_page, w_off] = vnew.permute(2, 0, 1, 3).to(pv.dtype)


@functools.cache
def _verify_lib():
    lib = _build.load("paged_verify")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_paged_verify.argtypes = [p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, i, i, i,
                                    ctypes.c_float, i, i, p]
    lib.rt_paged_verify.restype = i
    return lib


# The most query rows (g * S) of one kv head the verify kernels take: one
# block holds all of them.
MAX_VERIFY_ROWS = 40
# The most pages a slot's table row may hold: the verify kernels keep the
# row in shared memory (16 KB at most).
MAX_VERIFY_PAGES = 4096


def _verify_cuda(q, k_pages, v_pages, knew, vnew, lengths, page_tables,
                 what):
    """Launch K1' (knew is None) or K5 on one layer's pools
    [hkv, N, page, hd]."""
    insert = knew is not None
    B, S, h, hd = q.shape
    hkv, num_pages, page, hd_k = k_pages.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    news = (knew, vnew) if insert else ()
    if any(t.dtype != q.dtype for t in (k_pages, v_pages, *news)):
        raise TypeError(f"{what}: q, the pools and the new K/V must share "
                        f"a dtype")
    if lengths.dtype != torch.int32 or page_tables.dtype != torch.int32:
        raise TypeError(f"{what}: lengths and page_tables must be int32")
    if (v_pages.shape != k_pages.shape or hd_k != hd or h % hkv
            or lengths.shape != (B,) or page_tables.dim() != 2
            or page_tables.shape[0] != B
            or any(t.shape != (B, S, hkv, hd) for t in news)):
        raise ValueError(
            f"{what}: bad shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} new K/V "
            f"{[tuple(t.shape) for t in news]} lengths "
            f"{tuple(lengths.shape)} tables {tuple(page_tables.shape)}")
    if hd not in (64, 128) or not 1 <= (h // hkv) * S <= MAX_VERIFY_ROWS:
        raise ValueError(f"{what}: kernel supports head_dim 64/128 and 1-"
                         f"{MAX_VERIFY_ROWS} query rows (h/hkv * S) per kv "
                         f"head, got hd={hd}, h={h}, hkv={hkv}, S={S}")
    if page_tables.shape[1] > MAX_VERIFY_PAGES:
        raise ValueError(f"{what}: kernel supports page tables of at most "
                         f"{MAX_VERIFY_PAGES} pages per slot, got "
                         f"{page_tables.shape[1]}")
    ts = (q, k_pages, v_pages, *news, lengths, page_tables)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, *news)):
        raise ValueError(f"{what}: q, pools and new K/V must be 16-byte "
                         f"aligned (the kernels move pages by bulk copies)")
    out = torch.empty_like(q)
    lib = _verify_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_paged_verify(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            knew.data_ptr() if insert else None,
            vnew.data_ptr() if insert else None,
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            B, S, hkv, h // hkv, hd, num_pages, page, page_tables.shape[1],
            1.0 / math.sqrt(hd), _build.DTYPE_CODES[q.dtype], int(insert),
            stream)
    _build.check(lib, rc, what)
    (verify_insert_launches if insert else verify_launches)["cuda"] += 1
    return out
