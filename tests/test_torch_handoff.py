"""PyTorch port, disaggregated KV handoff: `PrefillEngine.prefill_export`
held to the JAX prefill engine (first token equal, K/V within 1e-5), and
`import_kv` + `resume_token` continuing bit for bit where the port's
monolithic engine and the JAX engine do, the imported pages prefix-hit,
including a mid-stream resume (the JAX package's
tests/test_serve_disagg.py handoff seam, TINY config)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.llm import PrefillEngine as JPrefillEngine
from ray_tpu_torch.llm import EngineConfig, InferenceEngine, PrefillEngine
from ray_tpu_torch.models import ModelConfig, params_from_numpy

TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")
ENG = dict(max_slots=4, max_len=64, prompt_buckets=(32,), eos_token=-1,
           default_max_new_tokens=8, page_size=8)
PROMPT = list(range(3, 23))   # 20 tokens: 2 full pages + a tail


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


def _jax_cfg():
    from ray_tpu.models import ModelConfig as JModelConfig
    return JModelConfig(**{f: getattr(TINY, f)
                           for f in TINY.__dataclass_fields__})


def _engine(pt):
    return InferenceEngine(TINY, EngineConfig(**ENG), params=pt,
                           device="cpu")


def _drain(eng, rid):
    while eng.has_work():
        eng.step_window()
    return eng.finished.pop(rid).generated


@pytest.fixture(scope="module")
def monolithic(params):
    """6 greedy tokens of PROMPT through the port's engine and the JAX
    engine (they must agree)."""
    pj, pt = params
    got = _engine(pt).generate([PROMPT], max_new_tokens=6,
                               temperature=0.0)[0]
    want = JInferenceEngine(_jax_cfg(), JEngineConfig(**ENG),
                            params=pj).generate([PROMPT], 6, 0.0)[0]
    assert got == want
    return got


@pytest.mark.parametrize("n", [20, 16, 7])
def test_prefill_export_matches_jax(params, n):
    """First token equal; K/V [L, S, hkv, hd] of the full pages within 1e-5
    of the JAX export (fp32 both, summed in another order), S = 16 for 20
    tokens, 8 for a page-aligned 16 (its last page stays behind), 0 for 7;
    log p of the first token within 1e-5."""
    pj, pt = params
    prompt = PROMPT[:n]
    first, ks, vs, lp = PrefillEngine(TINY, EngineConfig(**ENG), params=pt,
                                      device="cpu").prefill_export(
        prompt, temperature=0.0, want_logp=True)
    jfirst, jks, jvs, jlp = JPrefillEngine(
        _jax_cfg(), JEngineConfig(**ENG), params=pj).prefill_export(
        prompt, temperature=0.0, want_logp=True)
    assert first == jfirst
    assert ks.device.type == "cpu" and ks.dtype == torch.float32
    assert tuple(ks.shape) == jks.shape == (2, {20: 16, 16: 8, 7: 0}[n], 2,
                                           16)
    np.testing.assert_allclose(ks.numpy(), jks, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vs.numpy(), jvs, rtol=0, atol=1e-5)
    assert abs(lp - jlp) < 1e-5


@pytest.mark.parametrize("source", ["torch", "numpy"])
def test_import_and_resume_continue_the_stream(params, monolithic, source):
    """A prefill export spliced into a fresh engine (import_kv through
    add_request's kv_handoff, with the first token as resume_token)
    continues bit for bit where the monolithic engines do; the handed-off
    pages are prefix-hit. The export is taken as the port's CPU tensors
    and as the JAX engine's numpy arrays."""
    pj, pt = params
    if source == "torch":
        first, ks, vs = PrefillEngine(TINY, EngineConfig(**ENG), params=pt,
                                      device="cpu").prefill_export(PROMPT)
    else:
        first, ks, vs = JPrefillEngine(_jax_cfg(), JEngineConfig(**ENG),
                                       params=pj).prefill_export(PROMPT)
    assert first == monolithic[0]
    dec = _engine(pt)
    rid = dec.add_request(PROMPT, 6, 0.0, resume_token=first,
                          kv_handoff=(ks, vs))
    assert _drain(dec, rid) == monolithic
    assert dec.kv_stats()["prefix_hits"] >= 1


def test_mid_stream_resume(params, monolithic):
    """3 tokens already delivered: a fresh engine continues from the
    cursor without re-emitting a position (the JAX package's
    test_prefill_export_import_matches_engine, second half)."""
    _, pt = params
    _, ks, vs = PrefillEngine(TINY, EngineConfig(**ENG), params=pt,
                              device="cpu").prefill_export(PROMPT)
    gen = monolithic[:3]
    dec = _engine(pt)
    rid = dec.add_request(PROMPT + gen[:-1], 6 - len(gen) + 1, 0.0,
                          resume_token=gen[-1], kv_handoff=(ks, vs))
    assert _drain(dec, rid) == gen[-1:] + monolithic[3:]
    assert dec.kv_stats()["prefix_hits"] >= 1


def test_import_kv_lands_ref0_pages_in_the_prefix_cache(params):
    """import_kv splices full pages only (2 of a 20-token prompt), they
    sit ref-0 in the eviction LRU, a second import of the same prompt adds
    nothing, and the K/V in the pool's pages equal the export's."""
    _, pt = params
    _, ks, vs = PrefillEngine(TINY, EngineConfig(**ENG), params=pt,
                              device="cpu").prefill_export(PROMPT)
    eng = _engine(pt)
    assert eng.import_kv(PROMPT, ks, vs) == 2
    st = eng.kv_stats()
    assert st["cached_pages"] == 2 and st["pages_in_use"] == 0
    assert eng.import_kv(PROMPT, ks, vs) == 0
    pages = eng._find_prefix(PROMPT)
    assert len(pages) == 2
    got = eng.cache_k[:, :, pages].permute(0, 2, 3, 1, 4).reshape(
        ks.shape)
    assert torch.equal(got, ks)
    assert eng.import_kv(PROMPT[:7], ks[:, :0], vs[:, :0]) == 0
