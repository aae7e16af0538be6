"""PyTorch port, speculative decoding: the verify kernels' plain versions
(K1' multi-query paged attention, K5 fused verify-insert), the verify
forward, n-gram drafting, the accept/resample step and the speculative
engine, held to the JAX package on the same numpy inputs and weights.

The JAX side runs on the CPU as its own tests run it: K1' through the
Pallas body in interpret mode, K5 through its XLA insert-then-attend path
(`_verify_insert_xla`). The CUDA kernels run only on a card
(`python3 chip_smoke.py` holds each against its plain version there,
written pool bytes included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.llm.engine import ngram_draft as j_ngram_draft
from ray_tpu.llm.engine import spec_accept_sample as j_spec_accept_sample
from ray_tpu.llm.engine import verify_paged as j_verify_paged
from ray_tpu.models import ModelConfig as JModelConfig
from ray_tpu.ops.paged_attention import (
    paged_verify_attention as j_paged_verify,
    paged_verify_attention_reference as j_verify_reference,
    paged_verify_insert_attention as j_verify_insert)
from ray_tpu_torch.llm import EngineConfig, InferenceEngine
from ray_tpu_torch.llm.engine import (decode_weights, ngram_draft,
                                      spec_accept_sample, verify_paged)
from ray_tpu_torch.models import ModelConfig, params_from_numpy
from ray_tpu_torch.ops import paged_attention as t_paged

TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")
J_TINY = JModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=128, dtype="float32")
# The spec engine cases of tests/test_spec_decode.py.
SPEC_CFG = dict(max_slots=4, max_len=128, prompt_buckets=(32,),
                eos_token=-1, page_size=16)
SPEC_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6, 7], [9, 10, 11, 12, 13],
                [3, 1, 4, 1, 5, 9, 2, 6], [20, 21, 20, 21, 20, 21]]

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# As in test_torch_ops.py: fp32 is the same arithmetic in another order;
# bf16 rounds both results to bf16 (eps 2^-8), a couple of ulps.
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the port's CPU tests run beside other test
    files in parallel workers and must not take every core from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params(tiny_llm_params):
    """The session's JAX TINY params (conftest.py), as (jax, torch)."""
    cfg, pj = tiny_llm_params
    assert cfg == J_TINY
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def jax_spec_tokens(params):
    """The JAX speculative engine's greedy tokens on SPEC_PROMPTS (built
    once: its verify graphs are the slow part of this file)."""
    pj, _ = params
    eng = JInferenceEngine(J_TINY, JEngineConfig(
        **SPEC_CFG, speculation="ngram", spec_k=4), params=pj)
    return eng.generate(SPEC_PROMPTS, max_new_tokens=24, temperature=0.0)


def _engine(pt, **kw):
    return InferenceEngine(TINY, EngineConfig(**kw), params=pt, device="cpu")


def _spec(pt, **kw):
    return _engine(pt, speculation="ngram", spec_k=4, **kw)


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        rtol=_TOL[dtype], atol=_TOL[dtype])


def _tables(rng, lengths, S, page, N, P, zero_rows=()):
    """Random distinct real pages for every position a slot reads or
    writes (< lengths + S - 1), capped at P; the rest scratch page 0."""
    B = len(lengths)
    tables = np.zeros((B, P), np.int32)
    free = list(rng.permutation(np.arange(1, N)))
    for b in range(B):
        if b in zero_rows:
            continue
        used = min(P, -(-(int(lengths[b]) + S - 1) // page))
        tables[b, :used] = [free.pop() for _ in range(used)]
    return tables


def _jax_layout(port_pages):
    """The port's [..., page, hd] pool layout -> the JAX [..., hd, page]."""
    return np.ascontiguousarray(np.swapaxes(port_pages, -1, -2))


# ---- K1': paged verify ----


# (S, h, hkv, lengths); page 8, P 4, hd 16.
_VERIFY_CASES = {
    # GQA 4/2 with S = 3, lengths at page edges and one slot whose last
    # queries run past the P-page cap
    "base": (3, 4, 2, [1, 7, 8, 11, 31]),
    # g * S = 8 * 5 = 40 query rows per kv head: one CUDA row group
    "rows40": (5, 8, 1, [6, 13, 20]),
    # 42 (g 7, S 6) and 48 (g 8, S 6) rows: two row groups on CUDA
    "rows42": (6, 14, 2, [5, 12, 26]),
    "rows48": (6, 8, 1, [1, 9, 27]),
    # S = 5 queries at positions 5..9, 13..17, 22..26: each straddles a
    # page edge
    "straddle": (5, 4, 2, [6, 14, 23]),
}


@pytest.mark.parametrize("dtype,case", [
    pytest.param(dt, case, id=dt if case == "base" else f"{dt}-{case}")
    for case in _VERIFY_CASES for dt in ("float32", "bfloat16")])
def test_paged_verify_plain_matches_jax_kernel_and_reference(dtype, case):
    """The plain K1' against the JAX Pallas body (interpret mode) and its
    dense reference on `_VERIFY_CASES`."""
    rng = np.random.default_rng(0)
    S, h, hkv, lengths = _VERIFY_CASES[case]
    B, hd, page, N, P = len(lengths), 16, 8, 16, 4
    lengths = np.array(lengths, np.int32)
    q = rng.normal(size=(B, S, h, hd)).astype(np.float32)
    kp, vp = (rng.normal(size=(hkv, N, page, hd)).astype(np.float32)
              for _ in range(2))
    tables = _tables(rng, lengths, S, page, N, P)
    jdt, tdt = _DT[dtype]
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, kp, vp))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, _jax_layout(kp),
                                                 _jax_layout(vp)))
    before = dict(t_paged.verify_launches)
    got = t_paged.paged_verify_attention(tq, tk, tv, torch.tensor(lengths),
                                         torch.tensor(tables))
    assert t_paged.verify_launches == {"cuda": before["cuda"],
                                       "plain": before["plain"] + 1}
    assert got.shape == tq.shape and got.dtype == tdt
    jl, jt = jnp.asarray(lengths), jnp.asarray(tables)
    _close(got, j_paged_verify(jq, jk, jv, jl, jt, interpret=True), dtype)
    _close(got, j_verify_reference(jq, jk, jv, jl, jt), dtype)


# ---- K5: fused verify-insert ----

# (B, S, h, hkv, lengths, all-zero table rows); page 8, P 4, hd 16.
_INSERT_CASES = {
    # writes at 6..9 and 13..16 cross a page edge; the last slot starts
    # at position 0
    "straddle": (3, 4, 2, 2, [7, 14, 1], ()),
    # writes at 30..33 and 29..32 run past the 4-page table (P*page = 32)
    "past_p": (3, 4, 2, 2, [31, 30, 9], ()),
    # an inactive slot's all-zero table row: its writes go to scratch
    "zero_row": (2, 4, 2, 2, [12, 20], (1,)),
    "gqa": (3, 3, 8, 2, [9, 16, 25], ()),
    # g * S = 8 * 5 = 40 query rows per kv head (one CUDA row group);
    # the writes at 5..9 and 14..18 straddle page edges
    "rows40": (2, 5, 8, 1, [6, 15], ()),
    # 42 and 48 rows (two CUDA row groups); writes straddle page edges
    "rows42": (2, 6, 14, 2, [4, 21], ()),
    "rows48": (2, 6, 16, 2, [7, 13], ()),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_INSERT_CASES))
def test_paged_verify_insert_plain_matches_jax(case, dtype):
    """Attention within tolerance and the written pools bit-equal to the
    JAX XLA insert on every page but scratch page 0 (where duplicate
    writes may land in either order), in both layers."""
    B, S, h, hkv, lengths, zero_rows = _INSERT_CASES[case]
    rng = np.random.default_rng(len(case))
    L, layer, hd, page, N, P = 2, 1, 16, 8, 16, 4
    lengths = np.array(lengths, np.int32)
    q = rng.normal(size=(B, S, h, hd)).astype(np.float32)
    pk, pv = (rng.normal(size=(L, hkv, N, page, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
              for _ in range(2))
    tables = _tables(rng, lengths, S, page, N, P, zero_rows)
    jdt, tdt = _DT[dtype]
    tq, tpk, tpv, tkn, tvn = (torch.tensor(a).to(tdt)
                              for a in (q, pk, pv, kn, vn))
    before = dict(t_paged.verify_insert_launches)
    out, rk, rv = t_paged.paged_verify_insert_attention(
        tq, tpk, tpv, tkn, tvn, torch.tensor(lengths), torch.tensor(tables),
        layer)
    assert rk is tpk and rv is tpv    # the pools that came in, updated
    assert t_paged.verify_insert_launches == {
        "cuda": before["cuda"], "plain": before["plain"] + 1}
    jout, jk, jv = j_verify_insert(
        jnp.asarray(q, jdt), jnp.asarray(_jax_layout(pk), jdt),
        jnp.asarray(_jax_layout(pv), jdt), jnp.asarray(kn, jdt),
        jnp.asarray(vn, jdt), jnp.asarray(lengths), jnp.asarray(tables),
        layer)
    _close(out, jout, dtype)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    for got, want in ((tpk, jk), (tpv, jv)):
        want = _jax_layout(np.asarray(want).view(bits))
        got = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        np.testing.assert_array_equal(got.numpy().view(bits)[:, :, 1:],
                                      want[:, :, 1:])
    # the new rows did land (the comparison above would pass on no write)
    b, j = 0, S - 1
    pos = lengths[b] - 1 + j
    if pos < P * page and b not in zero_rows:
        row = tpk[layer, :, tables[b, pos // page], pos % page]
        assert torch.equal(row, tkn[b, j])


def test_verify_wrappers_validate_before_launch():
    """The K1'/K5 CUDA wrappers take any number of query rows per kv head
    (44 go as two row groups) and refuse what the kernel does not take
    (checked on meta tensors, before any build or launch): pools whose
    head_dim is not q's padded to a multiple of 8 (hd 12 takes pools of
    16 columns, not 12 or 24), a dtype mismatch of the new K/V."""
    meta = dict(device="meta")
    pages = torch.empty(2, 3, 8, 64, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    tabs = torch.empty(2, 1, dtype=torch.int32, **meta)
    assert t_paged.verify_plan(4, 11) == (2, 22)    # g = 4, S = 11: 44 rows
    q12 = torch.empty(2, 2, 4, 12, **meta)
    for width in (12, 24):
        with pytest.raises(ValueError, match=f"pools of head_dim {width}.*"
                                             f"padded_head_dim"):
            t_paged._verify_cuda(q12, torch.empty(2, 3, 8, width, **meta),
                                 torch.empty(2, 3, 8, width, **meta), None,
                                 None, lens, tabs, "paged_verify")
    q = torch.empty(2, 2, 4, 64, **meta)
    new = torch.empty(2, 2, 2, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(TypeError):
        t_paged._verify_cuda(q, pages, pages, new, new, lens, tabs,
                             "paged_verify_insert")


def test_verify_wrappers_refuse_long_page_tables():
    """The verify kernels keep a slot's page-table row in shared memory:
    the CUDA wrapper refuses rows of more than MAX_VERIFY_PAGES pages
    (checked on meta tensors, before any build or launch)."""
    meta = dict(device="meta")
    pages = torch.empty(2, 3, 8, 64, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    q = torch.empty(2, 2, 4, 64, **meta)
    for what, new in (("paged_verify", None),
                      ("paged_verify_insert", torch.empty(2, 2, 2, 64,
                                                          **meta))):
        tabs = torch.empty(2, t_paged.MAX_VERIFY_PAGES + 1,
                           dtype=torch.int32, **meta)
        with pytest.raises(ValueError, match="page tables"):
            t_paged._verify_cuda(q, pages, pages, new, new, lens, tabs, what)


# ---- the verify forward ----


def test_verify_paged_matches_jax(params):
    """logits [B, S, vocab] within 1e-4 and the pools' new K/V rows within
    1e-5 of the JAX verify forward (both computed in fp32 by the two
    frameworks: they differ by ~1e-6); pages no slot writes stay
    bit-equal; inactive rows carry the mask logits exactly."""
    pj, pt = params
    rng = np.random.default_rng(7)
    L, hkv, hd, page, N = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim, 8, 10
    pk, pv = (rng.normal(size=(L, hkv, N, page, hd)).astype(np.float32)
              for _ in range(2))
    tokens = rng.integers(1, TINY.vocab, (3, 5)).astype(np.int32)
    lengths = np.array([5, 10, 2], np.int32)
    active = np.array([True, True, False])
    tables = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32)
    jl, jk, jv = j_verify_paged(
        pj, jnp.asarray(_jax_layout(pk)), jnp.asarray(_jax_layout(pv)),
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(active),
        jnp.asarray(tables), J_TINY)
    tpk, tpv = torch.tensor(pk), torch.tensor(pv)
    before = dict(t_paged.verify_insert_launches)
    got = verify_paged(pt, tpk, tpv, torch.tensor(tokens),
                       torch.tensor(lengths), torch.tensor(active),
                       torch.tensor(tables), TINY, decode_weights(pt, TINY))
    assert t_paged.verify_insert_launches["plain"] == before["plain"] + L
    assert got.shape == (3, 5, TINY.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(jl)[:2],
                               rtol=0, atol=1e-4)
    assert (got[2, :, 0] == 0).all() and (got[2, :, 1:] == -1e30).all()
    for t, j, before in ((tpk, jk, pk), (tpv, jv, pv)):
        np.testing.assert_allclose(t[:, :, 1:].numpy(),
                                   _jax_layout(np.asarray(j))[:, :, 1:],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(t[:, :, 5:].numpy(), before[:, :, 5:])
    # positions 5..9 of slot 0 (pages 1, 2) and 10..14 of slot 1 (pages
    # 3, 4) were written
    assert not np.allclose(tpk[:, :, 1, 5:].numpy(), pk[:, :, 1, 5:])
    assert not np.allclose(tpk[:, :, 4, :7].numpy(), pk[:, :, 4, :7])


# ---- drafting and acceptance ----


def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(11)
    B, H, k = 16, 40, 4
    hist = rng.integers(0, 4, (B, H)).astype(np.int32)   # many matches
    lengths = rng.integers(1, H - 1, B).astype(np.int32)
    last = rng.integers(0, 4, B).astype(np.int32)
    last[:3] = 99                                         # no match
    got = ngram_draft(torch.tensor(hist), torch.tensor(lengths),
                      torch.tensor(last), k)
    want = j_ngram_draft(jnp.asarray(hist), jnp.asarray(lengths),
                         jnp.asarray(last), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:3] == 99).all()


def test_ngram_draft_reference_cases():
    """The two cases of tests/test_spec_decode.py: copy the continuation
    of the most recent 2-gram match, else repeat the pending token."""
    hist = np.zeros((2, 16), np.int32)
    hist[0, :7] = [5, 6, 7, 8, 9, 5, 6]
    hist[1, :5] = [1, 2, 3, 4, 1]
    hist[1, 5] = 2
    drafts = ngram_draft(torch.tensor(hist), torch.tensor([6, 5]),
                         torch.tensor([6, 2], dtype=torch.int32), 3)
    assert drafts.tolist() == [[7, 8, 9], [3, 4, 1]]
    hist = np.zeros((1, 8), np.int32)
    hist[0, :4] = [1, 2, 3, 9]
    drafts = ngram_draft(torch.tensor(hist), torch.tensor([3]),
                         torch.tensor([9], dtype=torch.int32), 2)
    assert drafts.tolist() == [[9, 9]]


def test_spec_accept_sample_greedy_matches_jax():
    """Temperature-0 rows: (acc, final, g) exactly the JAX step's, with
    drafts that the argmax accepts for 0..K positions."""
    rng = np.random.default_rng(12)
    B, K, V = 6, 4, 16
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    g = logits.argmax(-1)
    tin = rng.integers(0, V, (B, K + 1)).astype(np.int32)
    for b in range(B):               # row b accepts its first b drafts
        n = min(b, K)
        tin[b, 1:n + 1] = g[b, :n]
        if n < K:
            tin[b, n + 1] = (g[b, n] + 1) % V
    temps = np.zeros(B, np.float32)
    acc, final, gt = spec_accept_sample(
        torch.tensor(logits), torch.tensor(tin), torch.tensor(temps),
        torch.Generator().manual_seed(0))
    ja, jf, jg = j_spec_accept_sample(jnp.asarray(logits), jnp.asarray(tin),
                                      jnp.asarray(temps),
                                      jax.random.PRNGKey(0))
    assert acc.tolist() == [0, 1, 2, 3, 4, 4]
    for t, j in ((acc, ja), (final, jf), (gt, jg)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_spec_accept_sample_matches_target_distribution():
    """Delta-proposal rejection sampling is exact: over 20000 rows of one
    batched call, the first emitted token's distribution is the
    temperature-scaled target within 0.03 L1 (the JAX test's bound)."""
    V, K, n = 8, 3, 20000
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.normal(size=(1, K + 1, V)) * 2.0,
                          dtype=torch.float32)
    tin = torch.tensor([[2, 5, 1, 6]], dtype=torch.int32)
    acc, final, _ = spec_accept_sample(
        logits.expand(n, K + 1, V), tin.expand(n, K + 1),
        torch.ones(n), torch.Generator().manual_seed(1))
    first = torch.where(acc > 0, tin[0, 1], final)
    emp = torch.bincount(first.long(), minlength=V).double() / n
    target = torch.softmax(logits[0, 0].double(), -1)
    assert (emp - target).abs().sum() < 0.03, (emp, target)


# ---- the speculative engine ----


def test_spec_engine_matches_plain_and_jax(params, jax_spec_tokens):
    """The contract: at temperature 0 the speculative engine gives the
    plain engine's tokens, and the JAX speculative engine's; K5's plain
    version ran once per layer and verify step, the kernel never."""
    _, pt = params
    plain = _engine(pt, **SPEC_CFG).generate(SPEC_PROMPTS, 24, 0.0)
    before = dict(t_paged.verify_insert_launches)
    eng = _spec(pt, **SPEC_CFG)
    got = eng.generate(SPEC_PROMPTS, 24, 0.0)
    assert got == plain == jax_spec_tokens
    st = eng.kv_stats()
    assert st["spec_drafted"] > 0 and st["verify_steps"] > 0
    assert t_paged.verify_insert_launches == {
        "cuda": before["cuda"],
        "plain": before["plain"] + TINY.n_layers * st["verify_steps"]}


def test_spec_eos_inside_accepted_run_stops_exactly(params):
    _, pt = params
    prompt = [5, 6, 7, 5, 6, 7]
    greedy = _engine(pt, max_slots=2, max_len=64, prompt_buckets=(16,),
                     eos_token=-1).generate([prompt], 8, 0.0)[0]
    cfg = dict(max_slots=2, max_len=64, prompt_buckets=(16,),
               eos_token=greedy[5], page_size=16)
    want = _engine(pt, **cfg).generate([prompt], 20)
    assert _spec(pt, **cfg).generate([prompt], 20) == want
    assert len(want[0]) < 20


def test_spec_preemption_stays_exact(params):
    """Pool exhaustion preempts mid-speculation; re-prefill and resume
    keep greedy exactness."""
    _, pt = params
    prompts = [[5, 6, 7, 5, 6, 7], [9, 10, 11], [3, 1, 4, 1, 5],
               [2, 7, 1, 8]]
    cfg = dict(max_slots=4, max_len=96, prompt_buckets=(32,), eos_token=-1,
               page_size=8)
    want = _engine(pt, **cfg).generate(prompts, 20, 0.0)
    eng = _spec(pt, num_pages=14, **cfg)
    assert eng.generate(prompts, 20, 0.0) == want
    assert eng.kv_stats()["preemptions"] > 0


def test_spec_accepts_drafts_on_forced_repetition(params):
    _, pt = params
    eng = _spec(pt, max_slots=2, max_len=256, prompt_buckets=(32,),
                eos_token=-1, page_size=16)
    out = eng.generate([[5, 6, 7, 5, 6, 7, 5, 6]], 120, 0.0)[0]
    assert len(out) == 120
    st = eng.kv_stats()
    assert st["spec_accepted"] > 0, st


def test_spec_sampled_requests_complete_and_are_seeded(params):
    _, pt = params
    cfg = dict(max_slots=2, max_len=96, prompt_buckets=(16,), eos_token=-1,
               page_size=16)
    prompts = [[5, 6, 7, 5, 6, 7], [8, 9, 10]]
    eng = _spec(pt, **cfg)
    outs = eng.generate(prompts, 24, 0.8)
    assert all(len(o) == 24 for o in outs)
    assert eng.kv_stats()["spec_drafted"] > 0
    assert eng.kv_stats()["decode_steps"] == 0    # no plain window ran
    assert _spec(pt, **cfg).generate(prompts, 24, 0.8) == outs


@pytest.mark.parametrize("kw", [{"top_k": 5}, {"top_p": 0.9},
                                {"logprobs": True}])
def test_spec_routes_truncation_and_logprobs_to_plain(params, kw):
    _, pt = params
    eng = _spec(pt, max_slots=2, max_len=64, prompt_buckets=(16,),
                eos_token=-1, page_size=16)
    rid = eng.add_request([5, 6, 7], max_new_tokens=6, temperature=0.5,
                          **kw)
    while eng.has_work():
        eng.step_window()
    assert len(eng.finished[rid].generated) == 6
    st = eng.kv_stats()
    assert st["verify_steps"] == 0 and st["decode_steps"] > 0


def test_spec_k_beyond_page_raises(params):
    _, pt = params
    with pytest.raises(ValueError, match="page_size"):
        _engine(pt, max_slots=1, max_len=32, prompt_buckets=(16,),
                page_size=4, speculation="ngram", spec_k=4)
    # any other value of `speculation` leaves the engine plain, as in JAX
    eng = _engine(pt, max_slots=1, max_len=32, prompt_buckets=(16,),
                  eos_token=-1, speculation="medusa")
    eng.generate([[1, 2, 3]], 4, 0.0)
    assert eng.kv_stats()["verify_steps"] == 0
