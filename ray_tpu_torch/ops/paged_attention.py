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
Returns q's shape. head_dim: a multiple of 8 from 8 to 256 (the JAX
package's Pallas condition, `hd % 8 == 0`; `_build.check_head_dim`).

A slot attends at most P pages, and a query row with nothing to attend
returns zeros (the TPU kernel's semantics; its dense JAX reference gives
NaN there).
"""

from __future__ import annotations

import ctypes
import dataclasses
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


# K1's launch plan. A slot's positions [0, P*page) go to `splits` blocks
# of one thread-block cluster, `split_len` positions each (a power of
# two); a block moves its split in chunks of `chunk` tokens (a power of
# two that divides the page, so a chunk never crosses one; at most
# CHUNK_BYTES of K and one thread per key) through `stages` stages.
# Query heads go MAX_DECODE_ROWS at most to a block, in `row_groups`
# balanced groups of `rows`. The splits: doubled from one while the
# call's blocks (slots x kv heads x row groups x splits) are fewer than
# FILL_BLOCKS (about one an SM of an H100's 132), up to MAX_SPLITS (the
# portable cluster size) and no shorter than MIN_SPLIT tokens: the
# fastest split count, or within 2 % of it, at every shape that
# `chip_smoke.py` times them all (`time_k1_plans`; PERF.md §6). Nothing
# here reads the lengths: the plan comes from the shapes alone, so the
# wrapper never waits for the device.
MAX_SPLITS = 8
MIN_SPLIT = 64
FILL_BLOCKS = 128
CHUNK_BYTES = 16384
MAX_CHUNK = 128
MAX_DECODE_ROWS = 8


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    split_len: int
    splits: int
    chunk: int
    stages: int
    rows: int
    row_groups: int


@functools.cache
def decode_plan(P: int, page: int, hd: int, itemsize: int, g: int,
                pairs: int, splits: int = 0) -> DecodePlan:
    """K1's launch plan for `pairs` (slot, kv head) pairs of P-page tables
    of `page`-token pages, head_dim `hd` in `itemsize`-byte elements and
    g query heads per kv head. `splits` > 0 asks for that many splits
    instead of the rule's (fewer where a power-of-two split length covers
    the table with fewer)."""
    cap = P * page
    row_groups = -(-g // MAX_DECODE_ROWS)
    if splits <= 0:
        splits = 1
        while (splits < MAX_SPLITS and pairs * row_groups * splits
               < FILL_BLOCKS and cap >= 2 * splits * MIN_SPLIT):
            splits *= 2
    split_len = 1 << (-(-cap // min(splits, MAX_SPLITS)) - 1).bit_length()
    fit = CHUNK_BYTES // (hd * itemsize)   # tokens of CHUNK_BYTES of K
    chunk = min(split_len, 1 << (fit.bit_length() - 1), MAX_CHUNK,
                page & -page)          # the largest power of two in page
    return DecodePlan(split_len=split_len, splits=-(-cap // split_len),
                      chunk=chunk, stages=1 if chunk == split_len else 2,
                      rows=-(-g // row_groups), row_groups=row_groups)


@functools.cache
def _lib():
    lib = _build.load("paged_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                    i, i, i, i, i, ctypes.c_float, i, p]
    lib.rt_paged_decode.restype = i
    return lib


def _paged_decode_cuda(q, k_pages, v_pages, lengths, page_tables,
                       plan: DecodePlan | None = None):
    """Launch K1; `plan` replaces `decode_plan`'s (timing sweeps)."""
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
    _build.check_head_dim("paged_decode", hd)
    if B < 1 or h < 1 or page_tables.shape[1] < 1:
        raise ValueError(f"paged_decode: kernel supports non-empty inputs, "
                         f"got B={B}, h={h}, P={page_tables.shape[1]}")
    ts = (q, k_pages, v_pages, lengths, page_tables)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_decode: all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode: inputs must be contiguous")
    pl = plan or decode_plan(page_tables.shape[1], page, hd,
                             q.element_size(), h // hkv, B * hkv)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            B, hkv, h // hkv, hd, num_pages, page, page_tables.shape[1],
            pl.rows, pl.split_len, pl.splits, pl.chunk, pl.stages,
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
                                    i, i, i, i, i, i, i, i, i,
                                    ctypes.c_float, i, i, p]
    lib.rt_paged_verify.restype = i
    return lib


# The most query rows of one kv head a verify block holds; a (slot, kv
# head) with more (g * S of them) takes several row groups.
MAX_VERIFY_ROWS = 40


@functools.cache
def verify_plan(g: int, S: int) -> tuple[int, int]:
    """(row groups, rows per group) of the verify kernels for g query heads
    per kv head and S queries per slot: the g*S rows in the fewest groups
    of at most MAX_VERIFY_ROWS, balanced (the last may hold fewer)."""
    groups = -(-g * S // MAX_VERIFY_ROWS)
    return groups, -(-g * S // groups)

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
    _build.check_head_dim(what, hd)
    if B < 1 or S < 1 or h < 1:
        raise ValueError(f"{what}: kernel supports non-empty inputs, got "
                         f"B={B}, S={S}, h={h}")
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
    _groups, rows = verify_plan(h // hkv, S)
    out = torch.empty_like(q)
    lib = _verify_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rt_paged_verify(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            knew.data_ptr() if insert else None,
            vnew.data_ptr() if insert else None,
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            B, S, hkv, h // hkv, rows, hd, num_pages, page,
            page_tables.shape[1], 1.0 / math.sqrt(hd),
            _build.DTYPE_CODES[q.dtype], int(insert), stream)
    _build.check(lib, rc, what)
    (verify_insert_launches if insert else verify_launches)["cuda"] += 1
    return out
