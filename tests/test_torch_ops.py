"""PyTorch port, ops layer: the layer ops (values and VJPs) and the plain
versions of the ported kernels held against the JAX package on the same
numpy inputs.

The JAX side runs on the CPU as the JAX package's own tests run it: the
paged-decode Pallas kernel and the flash forward and backward kernels in
interpret mode. The CUDA kernels themselves run only on a card
(`python3 chip_smoke.py` compares each with its plain version there)."""

import inspect
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import apply_rope as j_apply_rope
from ray_tpu.ops import flash_attention as j_flash_attention
from ray_tpu.ops import rmsnorm as j_rmsnorm
from ray_tpu.ops import rope as j_rope
from ray_tpu.ops import swiglu as j_swiglu
from ray_tpu.ops import attention as j_attention
from ray_tpu.ops.paged_attention import (
    paged_decode_attention as j_paged_decode,
    paged_decode_attention_reference as j_paged_reference)
from ray_tpu_torch.ops import (apply_rope, flash_attention,
                               paged_decode_attention, rmsnorm, rope, swiglu)
from ray_tpu_torch.ops import attention as t_attention
from ray_tpu_torch.ops import paged_attention as t_paged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the port's CPU tests run beside other test
    files in parallel workers and must not take every core from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: both sides do the same fp32 arithmetic in another order. bf16:
# both round their fp32 result to bf16 (eps 2^-8); allow a couple of ulps
# of the output's scale.
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of `dtype`."""
    jdt, tdt = _DT[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _close(got, want, dtype, scale=1.0):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=_TOL[dtype],
                               atol=_TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = rmsnorm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, j_rmsnorm(jx, jw, 1e-6), dtype, scale=4.0)


def test_rope_tables_match_jax():
    pos = np.arange(37, dtype=np.int32)
    s_t, c_t = rope(torch.tensor(pos), 16, 10000.0)
    s_j, c_j = j_rope(jnp.asarray(pos), 16, 10000.0)
    assert s_t.dtype == torch.float32
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = (np.arange(6)[None] + np.array([[0], [9]])).astype(np.int32)
    jx, tx = _pair(x, dtype)
    sj, cj = j_rope(jnp.asarray(pos), 16)
    st, ct = rope(torch.tensor(pos), 16)
    got = apply_rope(tx, st, ct)
    assert got.dtype == tx.dtype
    _close(got, j_apply_rope(jx, sj, cj), dtype, scale=4.0)
    # unbatched [seq, half] tables broadcast over the batch
    got1 = apply_rope(tx, st[0], ct[0])
    _close(got1, j_apply_rope(jx, sj[0], cj[0]), dtype, scale=4.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 24)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.normal(size=(24, 16)).astype(np.float32) / 5
    args = [_pair(a, dtype) for a in (x, wg, wu, wd)]
    got = swiglu(*[t for _j, t in args])
    want = j_swiglu(*[j for j, _t in args])
    assert got.dtype == args[0][1].dtype
    _close(got, want, dtype, scale=float(np.abs(np.asarray(
        jnp.asarray(want, jnp.float32))).max()))


# ---- K1: paged decode ----


def _paged_case(rng, B=5, h=4, hkv=2, hd=16, page=8, N=12, P=4):
    """q, JAX-layout pools [hkv, N, hd, page], lengths at page edges, and
    random page tables whose unused entries point at scratch page 0."""
    q = rng.normal(size=(B, h, hd)).astype(np.float32)
    kp = rng.normal(size=(hkv, N, hd, page)).astype(np.float32)
    vp = rng.normal(size=(hkv, N, hd, page)).astype(np.float32)
    lengths = np.array([0, 1, page, page + 1, P * page], np.int32)[:B]
    tables = np.zeros((B, P), np.int32)
    for b in range(B):
        used = max(1, -(-int(lengths[b]) // page))
        tables[b, :used] = rng.choice(np.arange(1, N), used, replace=False)
    return q, kp, vp, lengths, tables


def _to_port_layout(pages_jax_layout):
    """[hkv, N, hd, page] -> the port's [hkv, N, page, hd]."""
    return np.ascontiguousarray(np.swapaxes(pages_jax_layout, 2, 3))


# (h, hkv, hd) of the K1 cases: GQA 4/2 at a narrow head; 8 query heads a
# kv head at head_dim 128; 16 a kv head (two of the CUDA kernel's row
# groups of at most 8); GQA 4/2 at the widest head_dim, 256.
_DECODE_CASES = {"base": (4, 2, 16), "g8_hd128": (16, 2, 128),
                 "g16": (16, 1, 16), "hd256": (4, 2, 256)}


@pytest.mark.parametrize("dtype,case", [
    pytest.param(dt, case, id=dt if case == "base" else f"{dt}-{case}")
    for case in _DECODE_CASES for dt in ("float32", "bfloat16")])
def test_paged_decode_plain_matches_jax_kernel_and_reference(dtype, case):
    rng = np.random.default_rng(3)
    h, hkv, hd = _DECODE_CASES[case]
    q, kp, vp, lengths, tables = _paged_case(rng, h=h, hkv=hkv, hd=hd)
    jq, tq = _pair(q, dtype)
    jk, _ = _pair(kp, dtype)
    jv, _ = _pair(vp, dtype)
    _, tk = _pair(_to_port_layout(kp), dtype)
    _, tv = _pair(_to_port_layout(vp), dtype)
    before = dict(t_paged.launches)
    got = paged_decode_attention(tq, tk, tv, torch.tensor(lengths),
                                 torch.tensor(tables))
    assert t_paged.launches["plain"] == before["plain"] + 1
    assert t_paged.launches["cuda"] == before["cuda"]
    assert got.shape == tq.shape and got.dtype == tq.dtype
    # The Pallas kernel (interpret mode): every slot, length 0 included
    # (the kernel returns zeros there).
    want = j_paged_decode(jq, jk, jv, jnp.asarray(lengths),
                          jnp.asarray(tables), interpret=True)
    _close(got, want, dtype)
    assert not got[0].float().abs().any()
    # The dense JAX reference: lengths >= 1 only (NaN at length 0).
    ref = j_paged_reference(jq, jk, jv, jnp.asarray(lengths),
                            jnp.asarray(tables))
    _close(got[1:], ref[1:], dtype)


def _split_kv_model(q, kp, vp, lengths, tables, plan):
    """The CUDA kernel's split-KV arithmetic in plain torch (fp32), a test
    model only: per split, chunk by chunk, a running (m, l, acc); the
    splits' partials merged in rank order. Pools in the port's layout."""
    B, h, _hd = q.shape
    hkv, _n, page, _ = kp.shape
    g, cap = h // hkv, tables.shape[1] * page
    out = torch.zeros(q.shape)
    for b in range(B):
        eff = min(max(int(lengths[b]), 0), cap)
        for kvh in range(hkv):
            qs = q[b, kvh * g:(kvh + 1) * g].float()
            parts = []
            for s in range(plan.splits):
                m = torch.full((g,), -0.7 * torch.finfo(torch.float32).max)
                l, acc = torch.zeros(g), torch.zeros(g, q.shape[2])
                s0 = s * plan.split_len
                for t0 in range(s0, min(s0 + plan.split_len, eff),
                                plan.chunk):
                    t1 = min(t0 + plan.chunk, s0 + plan.split_len, eff)
                    assert t0 // page == (t1 - 1) // page   # one page
                    pid = int(tables[b, t0 // page])
                    k = kp[kvh, pid, t0 % page:t0 % page + t1 - t0].float()
                    v = vp[kvh, pid, t0 % page:t0 % page + t1 - t0].float()
                    sc = qs @ k.T / math.sqrt(q.shape[2])
                    m_new = torch.maximum(m, sc.max(1).values)
                    p = torch.exp(sc - m_new[:, None])
                    a = torch.exp(m - m_new)
                    l, acc, m = l * a + p.sum(1), acc * a[:, None] + p @ v, \
                        m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _l, _a in parts]).max(0).values
            lsum, asum = torch.zeros(g), torch.zeros(g, q.shape[2])
            for m, l, acc in parts:                 # rank order
                f = torch.exp(m - mx)
                lsum, asum = lsum + l * f, asum + acc * f[:, None]
            out[b, kvh * g:(kvh + 1) * g] = torch.where(
                lsum[:, None] > 0, asum / lsum.clamp_min(1e-30)[:, None], 0.0)
    return out


@pytest.mark.parametrize("dtype,splits", [
    pytest.param(dt, n, id=dt if n == 2 else f"{dt}-{'rule' if n == 0 else n}")
    for n in (2, 8, 0) for dt in ("float32", "bfloat16")])
def test_split_kv_merge_model_matches_jax_kernel(dtype, splits):
    """The split-KV plans and merge the CUDA K1 runs (`decode_plan` at P =
    16, page 16: two 128-token splits, eight of 32 tokens, and the rule's
    four of 64 for these 12 slots x 2 kv heads; 16-token chunks) reproduce
    the JAX kernel at lengths 0, 1, chunk and page edges, split edges and
    beyond P * page."""
    rng = np.random.default_rng(7)
    P, page, hd, h, hkv = 16, 16, 16, 4, 2
    lengths = np.array([0, 1, 15, 16, 17, 127, 128, 129, 191, 255, 256,
                        300], np.int32)
    B, N = len(lengths), 40
    q = rng.normal(size=(B, h, hd)).astype(np.float32)
    kp, vp = (rng.normal(size=(hkv, N, hd, page)).astype(np.float32)
              for _ in range(2))
    tables = rng.integers(0, N, (B, P)).astype(np.int32)  # 0 = scratch
    jdt, tdt = _DT[dtype]
    tq, tk, tv = (torch.tensor(a).to(tdt)
                  for a in (q, _to_port_layout(kp), _to_port_layout(vp)))
    plan = t_paged.decode_plan(P, page, hd, tq.element_size(), h // hkv,
                               B * hkv, splits)
    assert (plan.splits, plan.split_len, plan.chunk) == {
        2: (2, 128, 16), 8: (8, 32, 16), 0: (4, 64, 16)}[splits]
    got = _split_kv_model(tq, tk, tv, lengths, tables, plan).to(tdt)
    want = j_paged_decode(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                          jnp.asarray(vp, jdt), jnp.asarray(lengths),
                          jnp.asarray(tables), interpret=True)
    _close(got, want, dtype)
    plain = paged_decode_attention(tq, tk, tv, torch.tensor(lengths),
                                   torch.tensor(tables))
    _close(got, plain.float().numpy(), dtype)
    assert not got[0].float().abs().any()        # length 0: zeros


@pytest.mark.parametrize("P,page,hd,itemsize,g", [
    (2, 128, 64, 2, 1), (8, 128, 64, 2, 1), (2, 128, 128, 2, 8),
    (8, 128, 128, 4, 7), (1, 128, 64, 2, 16), (3, 24, 64, 2, 12),
    (16, 128, 64, 2, 1), (4096, 16, 128, 4, 3), (4, 8, 16, 4, 2),
    (2, 128, 80, 2, 2), (8, 128, 120, 4, 4), (3, 128, 24, 2, 1),
    (2, 128, 136, 2, 2), (8, 128, 136, 4, 8), (4, 16, 200, 4, 1),
    (2, 128, 200, 2, 3), (2, 128, 256, 2, 1), (16, 128, 256, 4, 8),
    (3, 24, 256, 4, 2), (2, 128, 16, 4, 2), (2, 128, 104, 2, 2),
    (2, 128, 264, 2, 2), (16, 128, 384, 4, 8), (4, 16, 520, 4, 8),
    (8, 128, 520, 2, 16), (8, 128, 1024, 4, 8)])
def test_decode_plan_covers_every_position_once(P, page, hd, itemsize, g):
    """K1's launch plan, from the shapes alone (it takes no lengths), for
    1 to 4096 (slot, kv head) pairs, by the rule and by request: the
    splits (at most 8, the portable cluster size) cover positions [0,
    P*page) exactly once, every split is non-empty, a chunk never crosses
    a page or outgrows the kernel's limits, one stage only where a split
    is one chunk, and the row groups cover the g query heads exactly
    once, at most 8 to a block. The rule doubles the splits only while
    the blocks are short of FILL_BLOCKS and a split stays >= MIN_SPLIT."""
    assert "lengths" not in inspect.signature(t_paged.decode_plan).parameters
    cap = P * page
    for pairs in (1, 12, 48, 384, 4096):
        for asked in (0, 1, 2, 4, 8, 16):
            pl = t_paged.decode_plan(P, page, hd, itemsize, g, pairs, asked)
            assert 1 <= pl.splits <= min(t_paged.MAX_SPLITS, asked or 8)
            assert pl.split_len & (pl.split_len - 1) == 0
            covered = np.zeros(cap, np.int64)
            for s in range(pl.splits):
                lo, hi = s * pl.split_len, min((s + 1) * pl.split_len, cap)
                assert lo < hi
                for t0 in range(lo, hi, pl.chunk):  # the kernel's chunks
                    t1 = min(t0 + pl.chunk, hi)
                    assert t0 // page == (t1 - 1) // page
                    covered[t0:t1] += 1
            assert (covered == 1).all()
            assert page % pl.chunk == 0 and pl.split_len % pl.chunk == 0
            assert pl.chunk <= t_paged.MAX_CHUNK
            assert pl.chunk * hd * itemsize <= t_paged.CHUNK_BYTES
            assert pl.stages == (1 if pl.chunk == pl.split_len else 2)
            assert 1 <= pl.rows <= t_paged.MAX_DECODE_ROWS
            assert (pl.row_groups - 1) * pl.rows < g <= pl.row_groups * pl.rows
            if asked == 0:
                blocks = pairs * pl.row_groups
                assert pl.splits == 1 or pl.split_len >= t_paged.MIN_SPLIT
                assert (pl.splits == 1
                        or blocks * (pl.splits // 2) < t_paged.FILL_BLOCKS)


@pytest.mark.parametrize("hd", [16, 104, 256, 264, 384, 520])
@pytest.mark.parametrize("g,S", [(1, 1), (8, 5), (7, 6), (8, 6), (4, 11),
                                 (1, 128), (64, 8)])
def test_verify_plan_covers_every_row_once(g, S, hd):
    """The verify kernels' row groups: the g*S query rows of a kv head in
    the fewest groups of at most MAX_VERIFY_ROWS (past VERIFY_WIDE_HD, of
    at most MAX_VERIFY_ROWS * 256 / hd in fives), each row once."""
    groups, rows = t_paged.verify_plan(g, S, hd)
    most = t_paged.MAX_VERIFY_ROWS
    if hd > t_paged.VERIFY_WIDE_HD:
        most = max(5, most * t_paged.VERIFY_WIDE_HD // hd // 5 * 5)
    assert 1 <= rows <= most
    assert groups == -(-g * S // most)
    assert (groups - 1) * rows < g * S <= groups * rows


def test_paged_decode_caps_at_table_width():
    """Lengths beyond P pages attend exactly the P pages (the kernel's
    page cap), like the JAX kernel."""
    rng = np.random.default_rng(4)
    q, kp, vp, _lengths, tables = _paged_case(rng, B=2)
    lengths = np.array([40, 100], np.int32)     # P * page = 32
    got = paged_decode_attention(
        torch.tensor(q), torch.tensor(_to_port_layout(kp)),
        torch.tensor(_to_port_layout(vp)), torch.tensor(lengths),
        torch.tensor(tables))
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(lengths), jnp.asarray(tables),
                          interpret=True)
    _close(got, want, "float32")


# ---- K2: flash forward ----


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,hkv", [(128, 2, 2), (100, 4, 2), (63, 4, 2),
                                     (65, 4, 2), (129, 4, 2)])
def test_flash_attention_plain_matches_jax_interpret(causal, s, h, hkv):
    """Causal and full, a ragged S (the JAX kernel pads to 128 and masks)
    and GQA (head i reads kv head i // (h / hkv)); S = 63, 65 and 129
    straddle the CUDA kernels' 64-row and 64-key tiles."""
    rng = np.random.default_rng(5)
    d = 32
    q = rng.normal(size=(2, s, h, d)).astype(np.float32)
    k = rng.normal(size=(2, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, s, hkv, d)).astype(np.float32)
    want = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, impl="interpret")
    before = t_attention.launches["plain"]
    for impl in ("auto", "reference", "interpret"):
        got = flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, impl=impl)
        assert got.shape == (2, s, h, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert t_attention.launches["plain"] == before + 3
    assert t_attention.launches["cuda"] == 0


def test_flash_attention_impl_contract():
    x = torch.zeros(1, 8, 2, 64)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="later slice"):
            flash_attention(x, x, x, impl=impl)
    with pytest.raises(ValueError, match="unknown"):
        flash_attention(x, x, x, impl="mosaic")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x, impl="pallas")   # kernel path, CPU tensors
    # with a gradient too: the kernel path takes CUDA tensors only
    g = torch.zeros(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(g, g, g, impl="pallas")


def test_kernel_wrappers_validate_before_launch():
    """The CUDA wrappers refuse what the kernels do not take, before any
    build or launch (checked here on meta tensors: no card needed): a
    head_dim of 0."""
    q = torch.empty(2, 4, 0, device="meta")
    pages = torch.empty(2, 3, 8, 0, device="meta")
    with pytest.raises((TypeError, ValueError)):
        t_paged._paged_decode_cuda(
            q, pages, pages, torch.empty(2, dtype=torch.int32, device="meta"),
            torch.empty(2, 1, dtype=torch.int32, device="meta"))
    x = torch.empty(1, 8, 2, 0, device="meta")
    with pytest.raises(ValueError):
        t_attention.flash_attention_fwd(x, x, x, True, 1.0)
    rows = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        t_attention.flash_attention_bwd(x, x, x, x, rows, x, True, 1.0)
    for fn in (t_attention.flash_bwd_dq, t_attention.flash_bwd_dkv):
        with pytest.raises(ValueError):
            fn(x, x, x, x, rows, rows, True, 1.0)


def test_port_imports_neither_jax_nor_ray_tpu():
    """Every ray_tpu_torch module imports cleanly in a fresh interpreter
    without pulling in jax or the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__,"
        " 'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'ray_tpu'))\n"
        "bad += sorted(m for m in sys.modules if m == 'ray_tpu'"
        " or m.startswith('ray_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in new if m.startswith('ray_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 70


def test_port_names_no_path_into_the_jax_package_or_cpp():
    """The port keeps its own copy of every file it reads: no string in
    its Python names a path into `ray_tpu/` or the repo's `cpp/` (the
    native head core and its header were copied into `_native/`), no C or
    CUDA source includes one, and its native builds land in its own
    gitignored `_build/`."""
    import ast
    import re
    from ray_tpu_torch._native import build as native_build
    pkg = os.path.join(REPO, "ray_tpu_torch")
    into = re.compile(r"^(\.\./)*(ray_tpu|cpp)/")
    segments = {"ray_tpu", "cpp"}
    bad = []
    for root, _dirs, files in os.walk(pkg):
        if "_build" in root.split(os.sep):
            continue
        for f in files:
            path = os.path.join(root, f)
            rel = os.path.relpath(path, REPO)
            if f.endswith(".py"):
                for node in ast.walk(ast.parse(open(path).read())):
                    if (isinstance(node, ast.Constant)
                            and isinstance(node.value, str)
                            and into.match(node.value)):
                        bad.append(f"{rel}: {node.value!r}")
                    # os.path.join(..., "cpp", ...) and the like
                    if (isinstance(node, ast.Call)
                            and getattr(node.func, "attr", "") == "join"
                            and any(isinstance(a, ast.Constant)
                                    and a.value in segments
                                    for a in node.args)):
                        bad.append(f"{rel}:{node.lineno}: a path join")
            elif f.endswith((".cu", ".cuh", ".cpp", ".cc", ".h")):
                for line in open(path):
                    m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
                    if m and "/" in m.group(1):
                        bad.append(f"{rel}: {line.strip()}")
    assert not bad, bad
    assert os.path.commonpath([native_build._BUILD_DIR, pkg]) == pkg
    assert os.path.exists(os.path.join(native_build._DIR, "head_core.cc"))


def test_kernel_build_is_keyed_and_fails_loudly(monkeypatch, tmp_path):
    """Builds are keyed by a hash of the sources and flags; without nvcc a
    build raises (no silent fallback to the plain version)."""
    from ray_tpu_torch.ops import _build
    so, log = _build._paths("paged_decode")
    assert so.parent == _build._BUILD_DIR and so.suffix == ".so"
    assert so.stem.startswith("paged_decode-") and log.suffix == ".log"
    assert _build._paths("flash_fwd")[0] != so
    assert set(_build.SOURCES) == {"paged_decode", "paged_verify",
                                   "flash_fwd", "flash_bwd"}
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert not (tmp_path / "b").exists()


@pytest.mark.parametrize("header", ["common.cuh", "hopper.cuh"])
def test_kernel_build_key_covers_every_header(monkeypatch, tmp_path,
                                              header):
    """Editing any shared header under csrc/ changes every source's build
    key, so no stale library is loaded after a header changes."""
    from ray_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {n: _build._paths(n) for n in _build.SOURCES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edit\n")
    after = {n: _build._paths(n) for n in _build.SOURCES}
    for n in _build.SOURCES:
        assert after[n][0] != before[n][0], n
        assert after[n][1] != before[n][1], n


# ---- layer VJPs ----


def _vjp_pair(j_fn, t_fn, arrays, cot):
    """Cotangent-weighted gradients of one op in both packages, fp32."""
    _, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in arrays])
    want = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad(t_fn(*ts), ts, torch.tensor(cot))
    return got, want


@pytest.mark.parametrize("op", ["rmsnorm", "apply_rope", "swiglu"])
def test_layer_vjps_match_jax(op):
    """fp32 gradients of each layer op against `jax.vjp` (same math in
    another order: 2e-5 of the gradient's scale)."""
    rng = np.random.default_rng(9)
    if op == "rmsnorm":
        arrays = [rng.normal(size=(2, 5, 32)), rng.normal(size=(32,))]
        j_fn = lambda x, w: j_rmsnorm(x, w, 1e-6)  # noqa: E731
        t_fn = lambda x, w: rmsnorm(x, w, 1e-6)  # noqa: E731
        out_shape = (2, 5, 32)
    elif op == "apply_rope":
        pos = np.arange(6, dtype=np.int32)
        sj, cj = j_rope(jnp.asarray(pos), 16)
        st, ct = rope(torch.tensor(pos), 16)
        arrays = [rng.normal(size=(2, 6, 3, 16))]
        j_fn = lambda x: j_apply_rope(x, sj, cj)  # noqa: E731
        t_fn = lambda x: apply_rope(x, st, ct)  # noqa: E731
        out_shape = (2, 6, 3, 16)
    else:
        arrays = [rng.normal(size=(2, 4, 16)),
                  rng.normal(size=(16, 24)) / 4, rng.normal(size=(16, 24)) / 4,
                  rng.normal(size=(24, 16)) / 5]
        j_fn, t_fn = j_swiglu, swiglu
        out_shape = (2, 4, 16)
    arrays = [a.astype(np.float32) for a in arrays]
    cot = rng.normal(size=out_shape).astype(np.float32)
    got, want = _vjp_pair(j_fn, t_fn, arrays, cot)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(w).max()))


# ---- K3/K4: flash backward ----


def _bwd_case(rng, s, h, hkv, d=32, b=2):
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _heads_first(x, h, s_pad=None):
    """[B, S, Hx, D] numpy -> JAX [B*H, S_pad, D], kv heads repeated to h
    as the JAX package's flash_attention does, zero rows past S."""
    b, s, hx, d = x.shape
    x = np.repeat(x, h // hx, axis=2)
    if s_pad and s_pad > s:
        x = np.pad(x, [(0, 0), (0, s_pad - s), (0, 0), (0, 0)])
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d))


def _from_heads_first(x, b, s, h, hkv):
    """JAX [B*H, S_pad, D] -> [B, S, Hkv, D], summed over each group."""
    x = np.asarray(x)[:, :s].reshape(b, hkv, h // hkv, s, -1).sum(2)
    return x.transpose(0, 2, 1, 3)


def _bwd_close(got, want):
    """fp32: the same recompute in another summation order; 2e-5 of the
    reference's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,hkv", [(64, 2, 2), (100, 4, 2), (63, 4, 2),
                                     (65, 4, 2), (129, 4, 2)])
def test_flash_bwd_plain_matches_jax_kernels(causal, s, h, hkv):
    """The plain backward against the JAX dq/dkv Pallas kernels (interpret
    mode, 16-row tiles), both fed the same (o, lse) from the JAX forward
    kernel: the port's backward takes an (o, lse) it did not produce. A
    ragged S goes to the JAX kernels padded to the tile with kv_len set,
    as its flash_attention does; the port takes it unpadded. S = 63, 65
    and 129 straddle the CUDA kernels' 64-key tile (and K4's 64- or
    32-query tiles)."""
    rng = np.random.default_rng(10)
    q, k, v, do = _bwd_case(rng, s, h, hkv)
    b, d = q.shape[0], q.shape[-1]
    scale = d ** -0.5
    s_pad = -(-s // 16) * 16
    kv_len = s if s_pad != s else None
    jq, jk, jv, jdo = (_heads_first(x, h, s_pad) for x in (q, k, v, do))
    jo, jlse = j_attention._flash_fwd(jq, jk, jv, scale, causal, 16, 16,
                                      True, kv_len=kv_len)
    jlse = jlse[:, :, 0]
    jdq, jdk, jdv = j_attention._flash_bwd(jq, jk, jv, jo, jlse, jdo, scale,
                                           causal, 16, 16, True,
                                           kv_len=kv_len)
    o = np.asarray(jo)[:, :s].reshape(b, h, s, d).transpose(0, 2, 1, 3)
    lse = np.asarray(jlse)[:, :s]
    before = dict(t_attention.bwd_dq_launches), dict(
        t_attention.bwd_dkv_launches)
    dq, dk, dv = t_attention.flash_attention_bwd(
        *(torch.tensor(x) for x in (q, k, v, o, lse, do)), causal, scale)
    assert t_attention.bwd_dq_launches["plain"] == before[0]["plain"] + 1
    assert t_attention.bwd_dkv_launches["plain"] == before[1]["plain"] + 1
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    _bwd_close(dq, _from_heads_first(jdq, b, s, h, h))
    _bwd_close(dk, _from_heads_first(jdk, b, s, h, hkv))
    _bwd_close(dv, _from_heads_first(jdv, b, s, h, hkv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [37, 1])
def test_flash_bwd_plain_matches_jax_vjp_of_reference(causal, s):
    """The plain backward, on the plain forward's own (o, lse), against
    `jax.vjp` of the JAX dense reference (GQA 4/2, a ragged S, and S = 1
    where each row sees one key)."""
    rng = np.random.default_rng(11)
    h, hkv = 4, 2
    q, k, v, do = _bwd_case(rng, s, h, hkv)
    b, d = q.shape[0], q.shape[-1]
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = t_attention._plain_fwd(tq, tk, tv, causal, scale, with_lse=True)
    assert lse.shape == (b * h, s) and lse.dtype == torch.float32
    dq, dk, dv = t_attention.flash_attention_bwd_reference(
        tq, tk, tv, o, lse, tdo, causal, scale)
    jq, jk, jv, jdo = (_heads_first(x, h) for x in (q, k, v, do))
    _, vjp = jax.vjp(
        lambda a, b_, c: j_attention._reference(a, b_, c, scale, causal),
        jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    _bwd_close(dq, _from_heads_first(jdq, b, s, h, h))
    _bwd_close(dk, _from_heads_first(jdk, b, s, h, hkv))
    _bwd_close(dv, _from_heads_first(jdv, b, s, h, hkv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,hkv", [(32, 2, 2), (40, 4, 2)])
def test_flash_attention_grad_matches_jax_interpret(causal, s, h, hkv):
    """torch.autograd.grad through `flash_attention` (the autograd
    Function: plain forward with lse, then the plain backward) against
    jax.grad of the JAX `flash_attention` on its interpret-mode kernels."""
    rng = np.random.default_rng(12)
    q, k, v, do = _bwd_case(rng, s, h, hkv)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = [dict(c) for c in (t_attention.launches,
                                t_attention.bwd_dq_launches,
                                t_attention.bwd_dkv_launches)]
    out = flash_attention(*ts, causal=causal)
    got = torch.autograd.grad(out, ts, torch.tensor(do))
    after = (t_attention.launches, t_attention.bwd_dq_launches,
             t_attention.bwd_dkv_launches)
    for b4, now in zip(before, after):
        assert now == {"cuda": 0, "plain": b4["plain"] + 1}
    _, vjp = jax.vjp(lambda a, b_, c: j_flash_attention(
        a, b_, c, causal=causal, impl="interpret"),
        *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _bwd_close(g, w)


@pytest.mark.parametrize("kernel", ["paged_verify", "flash_fwd",
                                    "flash_bwd"])
def test_plain_versions_at_head_dim_256_match_jax(kernel):
    """At head_dim 256 (Gemma-2-class heads; the widest the CUDA kernels
    take) the plain versions agree with the JAX package's Pallas kernels
    in interpret mode, fp32 (K1 at hd 256 is a case of
    test_paged_decode_plain_matches_jax_kernel_and_reference): K1' with
    S = 3 over 8-token pages, K2 causal at a ragged S = 37, and K3/K4 from
    the JAX forward's (o, lse) at S = 32."""
    from ray_tpu.ops.paged_attention import (
        paged_verify_attention as j_paged_verify)
    rng = np.random.default_rng(256)
    d, h, hkv = 256, 4, 2
    if kernel == "paged_verify":
        B, S, page, N, P = 3, 3, 8, 12, 4
        lengths = np.array([1, 8, 30], np.int32)
        q = rng.normal(size=(B, S, h, d)).astype(np.float32)
        kp, vp = (rng.normal(size=(hkv, N, page, d)).astype(np.float32)
                  for _ in range(2))
        tables = np.stack([rng.permutation(np.arange(1, N))[:P]
                           for _ in range(B)]).astype(np.int32)
        got = t_paged.paged_verify_attention(
            *(torch.tensor(a) for a in (q, kp, vp, lengths, tables)))
        want = j_paged_verify(
            jnp.asarray(q), *(jnp.asarray(np.swapaxes(a, -1, -2))
                              for a in (kp, vp)),
            jnp.asarray(lengths), jnp.asarray(tables), interpret=True)
        _close(got, want, "float32")
        return
    if kernel == "flash_fwd":
        s = 37
        q, k, v, _ = _bwd_case(rng, s, h, hkv, d=d)
        want = j_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 impl="interpret")
        got = flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        return
    s = 32
    q, k, v, do = _bwd_case(rng, s, h, hkv, d=d)
    b, scale = q.shape[0], d ** -0.5
    jq, jk, jv, jdo = (_heads_first(x, h) for x in (q, k, v, do))
    jo, jlse = j_attention._flash_fwd(jq, jk, jv, scale, True, 16, 16, True)
    jlse = jlse[:, :, 0]
    jdq, jdk, jdv = j_attention._flash_bwd(jq, jk, jv, jo, jlse, jdo, scale,
                                           True, 16, 16, True)
    o = np.asarray(jo).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    dq, dk, dv = t_attention.flash_attention_bwd(
        *(torch.tensor(x) for x in (q, k, v, o, np.asarray(jlse), do)),
        True, scale)
    _bwd_close(dq, _from_heads_first(jdq, b, s, h, h))
    _bwd_close(dk, _from_heads_first(jdk, b, s, h, hkv))
    _bwd_close(dv, _from_heads_first(jdv, b, s, h, hkv))


def test_flash_attention_lse_only_when_grad_is_needed(monkeypatch):
    """Like the JAX primal-only path, the forward computes the lse only
    when some input needs a gradient and grad mode is on."""
    asked = []
    real = t_attention._reference

    def spy(*a, **kw):
        asked.append(kw.get("with_lse", a[5] if len(a) > 5 else False))
        return real(*a, **kw)

    monkeypatch.setattr(t_attention, "_reference", spy)
    x = torch.randn(1, 8, 2, 32)
    xg = x.clone().requires_grad_(True)
    flash_attention(x, x, x)
    with torch.no_grad():
        flash_attention(xg, xg, xg)
    flash_attention(xg, x, x).sum().backward()
    assert asked == [False, False, True]
    assert xg.grad is not None and xg.grad.shape == x.shape


# ---- head_dims: every positive one (padded to a multiple of 8) ----


def _wrapper_calls(hd):
    """The six CUDA kernel wrappers (K1, K1', K5, K2, K3, K4) called on
    meta tensors of head_dim `hd` whose other checks all pass (the pools
    `padded_head_dim(hd)` wide, as the engines allocate them)."""
    from ray_tpu_torch.ops import _build
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    x = torch.empty(1, 8, 4, hd, **meta)
    rows = torch.empty(4, 8, **meta)
    pages = torch.empty(2, 3, 16, max(_build.padded_head_dim(hd), 0),
                        **meta)
    q_v = torch.empty(2, 3, 4, hd, **meta)
    new = torch.empty(2, 3, 2, hd, **meta)
    lens, tabs = torch.empty(2, **i32), torch.empty(2, 2, **i32)
    return {
        "paged_decode": lambda: t_paged._paged_decode_cuda(
            torch.empty(2, 4, hd, **meta), pages, pages, lens, tabs),
        "paged_verify": lambda: t_paged._verify_cuda(
            q_v, pages, pages, None, None, lens, tabs, "paged_verify"),
        "paged_verify_insert": lambda: t_paged._verify_cuda(
            q_v, pages, pages, new, new, lens, tabs, "paged_verify_insert"),
        "flash_fwd": lambda: t_attention.flash_attention_fwd(
            x, x[:, :, :2], x[:, :, :2].contiguous(), True, 1.0),
        "flash_bwd_dq": lambda: t_attention.flash_bwd_dq(
            x, x, x, x, rows, rows, True, 1.0),
        "flash_bwd_dkv": lambda: t_attention.flash_bwd_dkv(
            x, x, x, x, rows, rows, True, 1.0),
    }


_KERNELS = ["paged_decode", "paged_verify", "paged_verify_insert",
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]


@pytest.mark.parametrize("hd", [0, -8])
@pytest.mark.parametrize("kernel", _KERNELS)
def test_wrappers_refuse_head_dims_the_kernels_do_not_take(kernel, hd):
    """A head_dim that is not positive raises a ValueError that names the
    accepted set, before any build or launch (meta tensors; every
    positive head_dim is taken since the kernels pad to a multiple of 8
    and run widths past 256 in 128-column chunks)."""
    if hd < 0:   # a tensor cannot have a negative dim: the check itself
        from ray_tpu_torch.ops import _build
        with pytest.raises(ValueError, match="any positive head_dim"):
            _build.check_head_dim(kernel, hd)
        return
    with pytest.raises(ValueError, match="any positive head_dim"):
        _wrapper_calls(hd)[kernel]()


class _Launched(Exception):
    """Raised in place of building a kernel library: the wrapper's checks
    all passed."""


@pytest.mark.parametrize("hd", [136, 192, 200, 248, 256])
@pytest.mark.parametrize("kernel", _KERNELS)
def test_wrappers_take_head_dims_up_to_256(kernel, hd, monkeypatch):
    """hd 136-256 pass every check of the six wrappers (meta tensors): the
    paged ones go on to their library, which is stubbed to raise here, and
    the flash ones stop only at the device check (a CUDA tensor is next)."""
    def stub():
        raise _Launched
    for name in ("_lib", "_verify_lib"):
        monkeypatch.setattr(t_paged, name, stub)
    if kernel.startswith("paged"):
        with pytest.raises(_Launched):
            _wrapper_calls(hd)[kernel]()
    else:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            _wrapper_calls(hd)[kernel]()


def test_every_accepted_head_dim_has_a_kernel_plan():
    """`check_head_dim` takes every positive head_dim and raises for 0; the
    kernels run it padded to the next multiple of 8 (the JAX package's
    Pallas condition), and at each such width K1's plan keeps the C
    launcher's terms: a power-of-two chunk that divides the page, within
    CHUNK_BYTES (one token where a row outgrows it), a block's shared
    memory within DECODE_SMEM_BYTES; the verify plan keeps q and the PV
    sums of a group at most their hd 256 size past VERIFY_WIDE_HD."""
    from ray_tpu_torch.ops import _build
    with pytest.raises(ValueError, match="any positive head_dim"):
        _build.check_head_dim("k", 0)
    for hd in [*range(1, 300), 384, 520, 1000, 2048, 4100]:
        _build.check_head_dim("k", hd)
        d8 = _build.padded_head_dim(hd)
        assert d8 % 8 == 0 and hd <= d8 < hd + 8
        for page, itemsize in ((16, 4), (128, 2), (128, 4)):
            pl = t_paged.decode_plan(2, page, d8, itemsize, 8, 64)
            assert pl.chunk & (pl.chunk - 1) == 0 and page % pl.chunk == 0
            assert pl.chunk * d8 * itemsize <= max(t_paged.CHUNK_BYTES,
                                                   d8 * itemsize)
            assert t_paged.decode_smem_bytes(
                d8, itemsize, pl.chunk, pl.stages, pl.splits,
                pl.rows) <= t_paged.DECODE_SMEM_BYTES
        groups, rows = t_paged.verify_plan(8, 5, d8)
        rp = -(-rows // 5) * 5          # the kernel pads rows to fives
        assert (groups - 1) * rows < 40 <= groups * rows
        assert d8 <= t_paged.VERIFY_WIDE_HD or rp * d8 <= max(
            t_paged.MAX_VERIFY_ROWS * t_paged.VERIFY_WIDE_HD, 5 * d8)


@pytest.mark.parametrize("hd", [12, 100, 264, 384, 520])
@pytest.mark.parametrize("kernel", _KERNELS)
def test_wrappers_take_every_positive_head_dim(kernel, hd, monkeypatch):
    """hd 12 and 100 (not multiples of 8: zero-padded to 16 and 104) and
    264-520 (past 256: run in 128-column chunks) pass every check of the
    six wrappers (meta tensors), with pools at the padded head_dim (as the
    engines allocate them): the paged wrappers go on to their library,
    stubbed here, and the flash ones stop only at the device check. Pools
    at q's unpadded head_dim are refused (a kernel never copies a
    pool)."""
    from ray_tpu_torch.ops import _build
    def stub():
        raise _Launched
    for name in ("_lib", "_verify_lib"):
        monkeypatch.setattr(t_paged, name, stub)
    if kernel.startswith("paged"):
        with pytest.raises(_Launched):
            _wrapper_calls(hd)[kernel]()
        if _build.padded_head_dim(hd) == hd:
            return
        meta = dict(device="meta")
        pages = torch.empty(2, 3, 16, hd, **meta)
        lens = torch.empty(2, dtype=torch.int32, **meta)
        tabs = torch.empty(2, 2, dtype=torch.int32, **meta)
        q_v = torch.empty(2, 3, 4, hd, **meta)
        new = torch.empty(2, 3, 2, hd, **meta)
        with pytest.raises(ValueError, match="padded_head_dim"):
            if kernel == "paged_decode":
                t_paged._paged_decode_cuda(torch.empty(2, 4, hd, **meta),
                                           pages, pages, lens, tabs)
            else:
                insert = kernel == "paged_verify_insert"
                t_paged._verify_cuda(q_v, pages, pages,
                                     new if insert else None,
                                     new if insert else None, lens, tabs,
                                     kernel)
    else:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            _wrapper_calls(hd)[kernel]()


def _zero_pad(x, d8):
    """Numpy [..., hd] -> [..., d8] with zero columns past hd."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, d8 - x.shape[-1])])


@pytest.mark.parametrize("hd", [12, 100, 264, 384])
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_verify",
                                    "paged_verify_insert", "flash_fwd",
                                    "flash_bwd"])
def test_plain_versions_at_f4_head_dims_match_jax(kernel, hd):
    """At head_dims the kernels take only since F4 closed, the plain
    versions agree with the JAX package, fp32: its XLA path at hd 12 and
    100 (no multiple of 8: the JAX package's paged functions and its
    flash "reference" impl take it there), its Pallas kernels in interpret
    mode at 264 and 384. The paged ones also with pools padded to the
    next multiple of 8 (as the engines allocate them): the same answer,
    and K5's insert writes zero columns there."""
    from ray_tpu.ops.paged_attention import (
        paged_verify_attention as j_paged_verify,
        paged_verify_insert_attention as j_verify_insert)
    from ray_tpu_torch.ops import _build
    rng = np.random.default_rng(hd)
    h, hkv = 4, 2
    pallas = hd % 8 == 0
    d8 = _build.padded_head_dim(hd)
    if kernel.startswith("paged"):
        B, S, page, N, P = 3, 3, 8, 16, 4
        lengths = np.array([1, 8, 30], np.int32)
        kp, vp = (rng.normal(size=(hkv, N, page, hd)).astype(np.float32)
                  for _ in range(2))
        # disjoint tables: no two slots write one page (K5's insert)
        tables = rng.permutation(np.arange(1, N))[:B * P].reshape(
            B, P).astype(np.int32)
        jpool = lambda a: jnp.asarray(np.swapaxes(a, -1, -2))  # noqa: E731
        tl, tt = torch.tensor(lengths), torch.tensor(tables)
        if kernel == "paged_decode":
            q = rng.normal(size=(B, h, hd)).astype(np.float32)
            want = j_paged_decode(jnp.asarray(q), jpool(kp), jpool(vp),
                                  jnp.asarray(lengths), jnp.asarray(tables),
                                  interpret=pallas)
            fn = lambda k_, v_: t_paged.paged_decode_attention(  # noqa
                torch.tensor(q), k_, v_, tl, tt)
        elif kernel == "paged_verify":
            q = rng.normal(size=(B, S, h, hd)).astype(np.float32)
            want = j_paged_verify(jnp.asarray(q), jpool(kp), jpool(vp),
                                  jnp.asarray(lengths), jnp.asarray(tables),
                                  interpret=pallas)
            fn = lambda k_, v_: t_paged.paged_verify_attention(  # noqa
                torch.tensor(q), k_, v_, tl, tt)
        else:
            q = rng.normal(size=(B, S, h, hd)).astype(np.float32)
            knew, vnew = (rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
                          for _ in range(2))
            L = 2
            pk, pv = (np.stack([a, a[::-1]]) for a in (kp, vp))
            want, wk, wv = j_verify_insert(
                jnp.asarray(q), *(jnp.asarray(np.swapaxes(a, -1, -2))
                                  for a in (pk, pv)),
                jnp.asarray(knew), jnp.asarray(vnew), jnp.asarray(lengths),
                jnp.asarray(tables), layer=1)
            wk, wv = (np.swapaxes(np.asarray(a), -1, -2) for a in (wk, wv))

            def fn(k_, v_):
                pools = (torch.tensor(pk), torch.tensor(pv))
                if k_.shape[-1] != hd:
                    pools = tuple(torch.tensor(_zero_pad(a, d8))
                                  for a in (pk, pv))
                out, ok, ov = t_paged.paged_verify_insert_attention(
                    torch.tensor(q), *pools, torch.tensor(knew),
                    torch.tensor(vnew), tl, tt, 1)
                np.testing.assert_array_equal(ok[..., :hd].numpy(), wk)
                np.testing.assert_array_equal(ov[..., :hd].numpy(), wv)
                assert not ok[..., hd:].any() and not ov[..., hd:].any()
                return out
        _close(fn(torch.tensor(kp), torch.tensor(vp)), want, "float32")
        padded = fn(*(torch.tensor(_zero_pad(a, d8)) for a in (kp, vp)))
        _close(padded, want, "float32")
        assert padded.shape[-1] == hd
        return
    if kernel == "flash_fwd":
        s = 37
        q, k, v, _ = _bwd_case(rng, s, h, hkv, d=hd)
        want = j_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 impl="interpret" if pallas else "reference")
        got = flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        return
    s = 32
    q, k, v, do = _bwd_case(rng, s, h, hkv, d=hd)
    b, scale = q.shape[0], hd ** -0.5
    if pallas:
        jq, jk, jv, jdo = (_heads_first(x, h) for x in (q, k, v, do))
        jo, jlse = j_attention._flash_fwd(jq, jk, jv, scale, True, 16, 16,
                                          True)
        jlse = jlse[:, :, 0]
        jdq, jdk, jdv = j_attention._flash_bwd(jq, jk, jv, jo, jlse, jdo,
                                               scale, True, 16, 16, True)
        o = np.asarray(jo).reshape(b, h, s, hd).transpose(0, 2, 1, 3)
        dq, dk, dv = t_attention.flash_attention_bwd(
            *(torch.tensor(x) for x in (q, k, v, o, np.asarray(jlse), do)),
            True, scale)
        _bwd_close(dq, _from_heads_first(jdq, b, s, h, h))
        _bwd_close(dk, _from_heads_first(jdk, b, s, h, hkv))
        _bwd_close(dv, _from_heads_first(jdv, b, s, h, hkv))
        return
    _out, vjp = jax.vjp(
        lambda a, b_, c: j_flash_attention(a, b_, c, causal=True,
                                           impl="reference"),
        *(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.tensor(x).requires_grad_(True) for x in (q, k, v)]
    flash_attention(*xs, causal=True).backward(torch.tensor(do))
    for g, w in zip(xs, vjp(jnp.asarray(do))):
        _bwd_close(g.grad, w)


@pytest.mark.parametrize("hd", [12, 100, 258])
def test_padded_head_dim_gives_the_true_head_dims_answer(hd):
    """What the CUDA wrappers do for a head_dim that is not a multiple of
    8, held with the plain versions (the wrappers pad only CUDA tensors):
    zero columns up to `padded_head_dim` with the true head_dim's scale,
    then cut back, give the unpadded answer: the flash forward, its lse,
    and dq, dk, dv, fp32, to rounding."""
    from ray_tpu_torch.ops import _build
    rng = np.random.default_rng(1)
    d8 = _build.padded_head_dim(hd)
    q, k, v, do = (torch.tensor(a) for a in _bwd_case(rng, 33, 4, 2, d=hd))
    scale = hd ** -0.5
    out, lse = t_attention._plain_fwd(q, k, v, True, scale, with_lse=True)
    pq, pk, pv, pdo = _build.pad_cols(d8, q, k, v, do)
    pout, plse = t_attention._plain_fwd(pq, pk, pv, True, scale,
                                        with_lse=True)
    torch.testing.assert_close(pout[..., :hd], out, rtol=1e-5, atol=1e-5)
    assert not pout[..., hd:].any()
    torch.testing.assert_close(plse, lse, rtol=1e-5, atol=1e-5)
    grads = t_attention.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                      True, scale)
    pgrads = t_attention.flash_attention_bwd_reference(pq, pk, pv, pout,
                                                       plse, pdo, True,
                                                       scale)
    for g, pg in zip(grads, pgrads):
        torch.testing.assert_close(pg[..., :hd], g, rtol=1e-5, atol=1e-5)
        assert not pg[..., hd:].any()


@pytest.mark.parametrize("hd", [12, 100, 64])
def test_flash_autograd_pads_once_for_the_kernels(hd, monkeypatch):
    """On the kernel path `flash_attention`'s autograd Function zero-pads
    q, k and v once to `padded_head_dim` in its forward and dO once in its
    backward; K2, K3 and K4 each get those padded tensors (no wrapper pads
    again) and the output and dq, dk, dv come back at the true head_dim.
    Meta tensors, with the three kernel wrappers replaced by recorders."""
    from ray_tpu_torch.ops import _build
    d8 = _build.padded_head_dim(hd)
    seen, padded = [], []
    real_pad = _build.pad_cols

    def pad_cols(width, *ts):
        padded.extend(t.shape[-1] for t in ts if t.shape[-1] != width)
        return real_pad(width, *ts)

    def fwd(q, k, v, causal, scale, with_lse=False):
        seen.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1]))
        b, s, h, _ = q.shape
        return torch.empty_like(q), torch.empty(b * h, s, device=q.device)

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(("dq", q.shape[-1], k.shape[-1], do.shape[-1]))
        return torch.empty_like(q)

    def dkv(q, k, v, do, lse, delta, causal, scale):
        seen.append(("dkv", q.shape[-1], k.shape[-1], do.shape[-1]))
        return torch.empty_like(k), torch.empty_like(v)

    monkeypatch.setattr(_build, "pad_cols", pad_cols)
    for name, fn in (("flash_attention_fwd", fwd), ("flash_bwd_dq", dq),
                     ("flash_bwd_dkv", dkv)):
        monkeypatch.setattr(t_attention, name, fn)
    meta = dict(device="meta", requires_grad=True)
    q = torch.empty(2, 8, 4, hd, **meta)
    k, v = (torch.empty(2, 8, 2, hd, **meta) for _ in range(2))
    out = flash_attention(q, k, v, impl="pallas")
    assert out.shape == q.shape
    out.backward(torch.empty_like(out))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert v.grad.shape == v.shape
    assert seen == [("fwd", d8, d8, d8), ("dq", d8, d8, d8),
                    ("dkv", d8, d8, d8)]
    assert padded == ([hd] * 4 if d8 != hd else [])   # q, k, v; then dO
