"""PyTorch port, LLM engine: greedy tokens held to the JAX engine and to a
naive full-forward argmax loop on the same carried-across weights (TINY
fp32 config, token-exact), through prefix-cache hits, chunked prefill and
pool-exhaustion preemption; logprobs within tolerance; sampling masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.models import forward as j_forward
from ray_tpu_torch.llm import EngineConfig, InferenceEngine, PrefillEngine
from ray_tpu_torch.llm.engine import (decode_paged, decode_step,
                                      decode_weights, insert_kv,
                                      insert_pages_batch, prefill,
                                      prefill_batch, sample)
from ray_tpu_torch.models import ModelConfig, forward, params_from_numpy
from ray_tpu_torch.ops import paged_attention as t_paged

TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")


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
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
        f: getattr(TINY, f) for f in TINY.__dataclass_fields__}
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


_FWD = {}


def _naive_greedy(pj, prompt, n):
    """Greedy decode through JAX `forward`: fixed-length right padding
    (causal attention makes the pad inert) so one jitted executable serves
    every step."""
    fwd = _FWD.get("f")
    if fwd is None:
        cfg = _jax_cfg()
        fwd = _FWD["f"] = jax.jit(lambda p, t: j_forward(p, t, cfg))
    seq, out = list(prompt), []
    pad_to = 96 if len(prompt) + n <= 96 else 160
    for _ in range(n):
        logits = fwd(pj, jnp.asarray([seq + [0] * (pad_to - len(seq))]))
        nxt = int(jnp.argmax(logits[0, len(seq) - 1]))
        out.append(nxt)
        seq.append(nxt)
    return out


def _jax_cfg():
    from ray_tpu.models import ModelConfig as JModelConfig
    return JModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=128, dtype="float32")


def _engine(pt, **kw):
    return InferenceEngine(TINY, EngineConfig(**kw), params=pt, device="cpu")


def test_greedy_matches_jax_engine_and_naive_forward(params):
    pj, pt = params
    ecfg = dict(max_slots=4, max_len=64, prompt_buckets=(16,), eos_token=-1)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3, 1, 4, 1, 5, 9, 2, 6]]
    before = dict(t_paged.launches)
    eng = _engine(pt, **ecfg)
    got = eng.generate(prompts, max_new_tokens=6, temperature=0.0)
    jeng = JInferenceEngine(_jax_cfg(), JEngineConfig(**ecfg), params=pj)
    want = jeng.generate(prompts, max_new_tokens=6, temperature=0.0)
    assert got == want
    for p, g in zip(prompts, got):
        assert g == _naive_greedy(pj, p, 6)
    # the CPU engine went through the paged plain path once per layer and
    # decode step, never the kernel
    steps = eng.kv_stats()["decode_steps"]
    assert steps > 0
    assert t_paged.launches["plain"] - before["plain"] == 2 * steps
    assert t_paged.launches["cuda"] == before["cuda"]


def test_single_step_path_matches_windows(params):
    _, pt = params
    ecfg = dict(max_slots=2, max_len=48, prompt_buckets=(16,), eos_token=-1)
    prompts = [[7, 8, 9], [20, 21]]
    want = _engine(pt, **ecfg).generate(prompts, max_new_tokens=5,
                                        temperature=0.0)
    eng = _engine(pt, **ecfg)
    rids = [eng.add_request(p, 5, 0.0) for p in prompts]
    while eng.has_work():
        eng.step()
    assert [eng.finished[r].generated for r in rids] == want


def test_more_prompts_than_slots_and_eos(params):
    pj, pt = params
    eng = _engine(pt, max_slots=2, max_len=48, prompt_buckets=(16,),
                  eos_token=-1)
    outs = eng.generate([[i + 1, i + 2] for i in range(7)], max_new_tokens=3)
    assert len(outs) == 7 and all(len(o) == 3 for o in outs)
    first = _naive_greedy(pj, [5, 6, 7], 1)[0]
    eng = _engine(pt, max_slots=2, max_len=64, prompt_buckets=(16,),
                  eos_token=first)
    assert eng.generate([[5, 6, 7]], max_new_tokens=10) == [[]]


def test_prefix_cache_reuses_pages_exactly(params):
    pj, pt = params
    eng = _engine(pt, max_slots=2, max_len=96, prompt_buckets=(16, 32),
                  eos_token=-1, page_size=8)
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # 2 pages
    p1, p2 = shared + [2, 3], shared + [11, 12, 13]
    out1 = eng.generate([p1], max_new_tokens=8, temperature=0.0)[0]
    assert eng.kv_stats()["prefix_hits"] == 0
    out2 = eng.generate([p2], max_new_tokens=8, temperature=0.0)[0]
    assert eng.kv_stats()["prefix_hits"] == 1
    assert out1 == _naive_greedy(pj, p1, 8)
    assert out2 == _naive_greedy(pj, p2, 8)
    assert eng.kv_stats()["pages_in_use"] == 0


def test_chunked_prefill_long_prompt_exact(params):
    pj, pt = params
    eng = _engine(pt, max_slots=2, max_len=128, prompt_buckets=(16,),
                  eos_token=-1, page_size=16)
    rng = np.random.default_rng(3)
    long_prompt = [int(t) for t in rng.integers(1, 250, 60)]  # 60 > 16
    outs = eng.generate([long_prompt, [5, 6, 7]], max_new_tokens=6,
                        temperature=0.0)
    assert outs[0] == _naive_greedy(pj, long_prompt, 6)
    assert outs[1] == _naive_greedy(pj, [5, 6, 7], 6)
    assert eng.kv_stats()["prefix_hits"] >= 3  # chunks resume via the cache


def test_pool_exhaustion_preempts_and_stays_exact(params):
    pj, pt = params
    eng = _engine(pt, max_slots=4, max_len=64, prompt_buckets=(16,),
                  eos_token=-1, page_size=8, num_pages=10)
    prompts = [[5, 6, 7], [9, 10, 11], [3, 1, 4, 1, 5], [2, 7, 1, 8]]
    outs = eng.generate(prompts, max_new_tokens=20, temperature=0.0)
    for p, got in zip(prompts, outs):
        assert got == _naive_greedy(pj, p, 20)
    assert eng.kv_stats()["preemptions"] > 0


def test_logprobs_match_forward(params):
    """log p(token) from the engine against JAX `forward`'s log_softmax:
    fp32 throughout, 1e-4."""
    pj, pt = params
    eng = _engine(pt, max_slots=2, max_len=64, prompt_buckets=(16,),
                  eos_token=-1)
    prompt = [5, 6, 7]
    rid = eng.add_request(prompt, max_new_tokens=5, temperature=0.0,
                          logprobs=True)
    while eng.has_work():
        eng.step_window()
    req = eng.finished.pop(rid)
    assert len(req.token_logprobs) == len(req.generated) == 5
    seq = list(prompt)
    _naive_greedy(pj, prompt, 1)  # builds the jitted padded forward
    for tok, lp in zip(req.generated, req.token_logprobs):
        padded = seq + [0] * (96 - len(seq))
        logits = _FWD["f"](pj, jnp.asarray([padded]))[0, len(seq) - 1]
        want = float(jax.nn.log_softmax(logits)[tok])
        assert abs(lp - want) < 1e-4, (lp, want)
        seq.append(tok)


def test_sampling_masks():
    """top_k=1 and top_p~0 reduce to greedy at high temperature; top-k
    draws stay inside the top-k set; unconstrained hot sampling varies.
    Checked by mask, not by equality: the RNG streams differ from JAX's."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.normal(size=(4, 32)), dtype=torch.float32)
    greedy = logits.argmax(-1)
    hot = torch.full((4,), 5.0)
    gen = torch.Generator().manual_seed(0)
    ones, zeros = torch.ones(4), torch.zeros(4, dtype=torch.long)
    assert torch.equal(sample(logits, hot, gen, ones, torch.ones(
        4, dtype=torch.long)), greedy)
    assert torch.equal(sample(logits, hot, gen, torch.full((4,), 1e-6),
                              zeros), greedy)
    assert torch.equal(sample(logits, torch.zeros(4), gen), greedy)
    top3 = logits.topk(3, dim=-1).indices
    seen = set()
    for _ in range(64):
        tok = sample(logits, hot, gen, ones, torch.full((4,), 3,
                                                        dtype=torch.long))
        assert (top3 == tok[:, None]).any(-1).all()
        seen.add(tuple(tok.tolist()))
    assert len(seen) > 1
    # nucleus: every draw is inside the smallest prefix holding top_p mass
    probs = torch.softmax(logits / 5.0, -1)
    sp, order = probs.sort(-1, descending=True)
    keep = (sp.cumsum(-1) - sp) <= 0.5
    for _ in range(32):
        tok = sample(logits, hot, gen, torch.full((4,), 0.5), zeros)
        for r in range(4):
            assert tok[r] in order[r][keep[r]]
    free = {tuple(sample(logits, hot, gen, ones, zeros).tolist())
            for _ in range(8)}
    assert len(free) > 1


def test_engine_top_k_request_and_cancel(params):
    _, pt = params
    eng = _engine(pt, max_slots=1, max_len=64, prompt_buckets=(16,),
                  eos_token=-1)
    rid = eng.add_request([1, 2, 3], max_new_tokens=4, temperature=2.0,
                          top_k=1)
    while eng.has_work():
        eng.step_window()
    assert eng.finished.pop(rid).generated == _engine(
        pt, max_slots=1, max_len=64, prompt_buckets=(16,),
        eos_token=-1).generate([[1, 2, 3]], 4, 0.0)[0]
    r_active = eng.add_request([5, 6, 7], max_new_tokens=50, temperature=0.0)
    r_queued = eng.add_request([8, 9], max_new_tokens=50, temperature=0.0)
    for _ in range(3):
        eng.step_window()
    eng.cancel(r_active)
    eng.cancel(r_queued)
    eng.step_window()
    assert len(eng.finished[r_active].generated) >= 1
    assert eng.finished[r_queued].generated == []
    assert not eng.active.any() and eng.kv_stats()["pages_in_use"] == 0


def test_moe_engine_matches_port_forward():
    """The MoE family decodes through the same engine: greedy tokens equal
    the argmax loop over the port's own forward."""
    from ray_tpu_torch.models import init_params
    moe = ModelConfig(vocab=200, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_ff=96, moe_experts=4, moe_top_k=2,
                      dtype="float32")
    pt = init_params(moe, torch.Generator().manual_seed(3), "cpu")
    eng = InferenceEngine(moe, EngineConfig(max_slots=2, max_len=48,
                                            prompt_buckets=(16,),
                                            eos_token=-1),
                          params=pt, device="cpu")
    prompts = [[4, 5, 6], [11, 12]]
    outs = eng.generate(prompts, max_new_tokens=5, temperature=0.0)
    for p, got in zip(prompts, outs):
        seq = list(p)
        for _ in range(5):
            seq.append(int(forward(pt, torch.tensor([seq]), moe)[0, -1]
                           .argmax()))
        assert got == seq[len(p):]


def test_decode_step_writes_kv_and_matches_prefill(params):
    """One decode_paged step after an inserted prefill gives the same
    next-token logits as prefilling the longer prompt, and writes the new
    token's K/V into its page slot (inactive slots write scratch)."""
    _, pt = params
    page, L = 8, TINY.n_layers
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]          # 10 tokens
    shape = (L, TINY.n_kv_heads, 6, page, TINY.head_dim)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    _, ks, vs = prefill_batch(pt, torch.tensor([prompt[:-1] + [0] * 7]), TINY)
    insert_pages_batch(pk, pv, ks, vs, torch.tensor([[3, 5]]),
                       torch.tensor([9]))
    tables = torch.tensor([[3, 5], [0, 0]], dtype=torch.int32)
    logits = decode_paged(pt, pk, pv,
                          torch.tensor([prompt[-1], 4], dtype=torch.int32),
                          torch.tensor([9, 0], dtype=torch.int32),
                          torch.tensor([True, False]), tables, TINY,
                          decode_weights(pt, TINY))
    want, ks2, _ = prefill(pt, torch.tensor([prompt]), TINY)
    torch.testing.assert_close(logits[0], want[-1], atol=1e-4, rtol=0)
    assert logits[1, 0] == 0 and (logits[1, 1:] == -1e30).all()
    torch.testing.assert_close(pk[:, :, 5, 1], ks2[:, 9], atol=1e-5,
                               rtol=0)
    assert not pk[:, :, 1:3].any() and not pk[:, :, 4].any()


def test_not_in_slice_raises(params):
    """A mesh with sequence, pipeline or expert parallelism is not in this
    slice (NotImplementedError, for the decode and the prefill engine; tp
    runs, tests/test_torch_parallel.py); guided decoding, logprobs,
    resume tokens and KV handoff need the paged layout (ValueError, as in
    the JAX engine); an over-long prompt fails its own request."""
    import types
    from ray_tpu_torch.parallel import AXES
    _, pt = params
    for axis in ("sp", "pp", "ep"):
        mesh = types.SimpleNamespace(
            mesh_dim_names=AXES, shape=tuple(2 if a == axis else 1
                                             for a in AXES))
        for cls in (InferenceEngine, PrefillEngine):
            with pytest.raises(NotImplementedError, match="later slice"):
                cls(TINY, EngineConfig(), params=pt, mesh=mesh,
                    device="cpu")
    dense = _engine(pt, max_slots=1, max_len=32, prompt_buckets=(16,),
                    kv_layout="dense")
    for kw in (dict(guide=object()), dict(logprobs=True),
               dict(resume_token=3), dict(kv_handoff=(None, None))):
        with pytest.raises(ValueError, match="paged KV layout"):
            dense.add_request([1, 2], **kw)
    eng = _engine(pt, max_slots=1, max_len=32, prompt_buckets=(16,))
    with pytest.raises(ValueError, match="exceeds"):
        eng.add_request(list(range(40)))


# ---- the dense layout ----


def test_dense_decode_step_matches_jax(params):
    """One dense decode step on the same random caches, tokens and
    lengths: logits within 1e-4 of the JAX `decode_step` (both fp32, summed
    in another order), the new K/V rows written at each slot's position
    within 1e-5, every other cache entry unchanged, inactive rows carrying
    the mask logits exactly."""
    from ray_tpu.llm.engine import decode_step as j_decode_step
    pj, pt = params
    rng = np.random.default_rng(11)
    L, B, T = TINY.n_layers, 3, 24
    shape = (L, B, T, TINY.n_kv_heads, TINY.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    tokens = np.array([5, 17, 250], np.int32)
    lengths = np.array([0, 9, 23], np.int32)
    active = np.array([True, False, True])
    jl, jk, jv = j_decode_step(pj, jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(tokens), jnp.asarray(lengths),
                               jnp.asarray(active), _jax_cfg())
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    tl, ok, ov = decode_step(pt, tk, tv, torch.tensor(tokens),
                             torch.tensor(lengths), torch.tensor(active),
                             TINY)
    assert ok is tk and ov is tv                    # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tl[1, 0] == 0 and (tl[1, 1:] == -1e30).all()
    for got, want, old in ((tk, jk, ck), (tv, jv, cv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        keep = np.ones(shape[:3], bool)
        keep[:, np.arange(B), lengths] = False
        assert np.array_equal(got.numpy()[keep], old[keep])


def test_dense_insert_kv_zeroes_the_padded_tail(params):
    """insert_kv splices a prefill's K/V into one slot and zeroes the
    bucket's positions past the prompt, as the JAX insert does."""
    from ray_tpu.llm.engine import insert_kv as j_insert_kv
    rng = np.random.default_rng(12)
    shape = (2, 3, 16, 2, 16)
    ck = rng.standard_normal(shape).astype(np.float32)
    ks = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    jk, _ = j_insert_kv(jnp.asarray(ck), jnp.asarray(ck), jnp.asarray(ks),
                        jnp.asarray(ks), 1, 5)
    tk = torch.tensor(ck)
    insert_kv(tk, tk.clone(), torch.tensor(ks), torch.tensor(ks), 1, 5)
    assert np.array_equal(tk.numpy(), np.asarray(jk))


def test_dense_greedy_matches_jax_dense_engine(params):
    """The dense layout's greedy tokens equal the JAX dense engine's and
    the port's paged engine's, token for token, with more prompts than
    slots (slots are reused) and the single-step path."""
    pj, pt = params
    ecfg = dict(max_slots=2, max_len=64, prompt_buckets=(16,), eos_token=-1)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3, 1, 4, 1, 5, 9, 2, 6]]
    eng = _engine(pt, kv_layout="dense", **ecfg)
    got = eng.generate(prompts, max_new_tokens=8, temperature=0.0)
    jeng = JInferenceEngine(_jax_cfg(), JEngineConfig(kv_layout="dense",
                                                      **ecfg), params=pj)
    want = jeng.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert got == want
    assert got == _engine(pt, **ecfg).generate(prompts, 8, 0.0)
    # two prompts decode side by side for 7 steps, then the third for 7
    assert eng.kv_stats() == {"layout": "dense", "decode_steps": 14}
    assert eng.cache_k.shape == (TINY.n_layers, 2, 64, TINY.n_kv_heads,
                                 TINY.head_dim)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_head_dim_12_engine_pads_its_pools(spec):
    """head_dim 12 (d_model 48 over 4 heads; the kernels run multiples of
    8): the paged pools are allocated 16 columns wide, the padding stays
    zero through prefill, decode and the verify insert, and the greedy
    tokens equal the JAX engine's (its XLA path at hd % 8 != 0),
    token-exact, plain and speculative."""
    from ray_tpu.models import ModelConfig as JModelConfig
    from ray_tpu.models import init_params as j_init_params
    kw = dict(vocab=300, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=96, dtype="float32")
    pj = j_init_params(JModelConfig(**kw), jax.random.PRNGKey(5))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    ecfg = dict(max_slots=2, max_len=64, prompt_buckets=(16,), eos_token=-1,
                page_size=16)
    if spec:
        ecfg.update(speculation="ngram", spec_k=4)
    eng = InferenceEngine(ModelConfig(**kw), EngineConfig(**ecfg), params=pt,
                          device="cpu")
    assert eng.cache_k.shape[-1] == eng.cache_v.shape[-1] == 16
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 10, 11]]
    got = eng.generate(prompts, max_new_tokens=10, temperature=0.0)
    assert not eng.cache_k[..., 12:].any() and not eng.cache_v[..., 12:].any()
    assert eng.cache_k[..., :12].any()
    if spec:
        assert eng.kv_stats()["verify_steps"] > 0
    jeng = JInferenceEngine(JModelConfig(**kw), JEngineConfig(**ecfg),
                            params=pj)
    assert got == jeng.generate(prompts, max_new_tokens=10, temperature=0.0)
