"""PyTorch port, guided decoding: the copied guide compilers give the JAX
package's tables bit for bit; `sample(mask=)` keeps to the mask; the
port's engine gives the JAX engine's fp32 greedy tokens under a regex
and a JSON-schema guide (TINY config, weights carried across), its
sampled JSON parses to the schema, the stacked guide table uploads only
when the slot -> guide map changes, and a guided slot survives
preemption."""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.llm import guided as j_guided
from ray_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from ray_tpu_torch.llm import ByteTokenizer, EngineConfig, InferenceEngine
from ray_tpu_torch.llm import guided
from ray_tpu_torch.llm.engine import sample
from ray_tpu_torch.models import ModelConfig, params_from_numpy

TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")
TOK = ByteTokenizer()

# The patterns and schemas of the JAX package's tests/test_guided.py.
PATTERNS = ["abc", "a*b", "a+", "(ab|cd)+", "[a-c]x?", "[^0-9]", "a{2,3}",
            "a{2,}", r"\d+\.\d+", r"-?(0|[1-9][0-9]*)", r'"[^"]*"', "ab",
            "[ab]c", "[ab]{3}c", "[ab]{20}c"]
SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"},
                                      "ok": {"type": "boolean"}}},
    {"type": "array", "items": {"enum": ["x", "y"]}, "minItems": 1,
     "maxItems": 2},
    {"type": "object", "properties": {"n": {"type": "integer"}}},
    {"type": "object", "properties": {"name": {"type": "string",
                                               "maxLength": 8},
                                      "n": {"type": "integer"}}},
]
NAME_N = SCHEMAS[3]


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


# ---- the guide compilers ----


@pytest.mark.parametrize("pattern", PATTERNS)
def test_byte_dfa_and_token_guide_equal_the_reference(pattern):
    """Same pruned byte DFA (transitions and accepting states) and the
    same token table, for the byte tokenizer at the model's vocab."""
    got, want = guided.compile_byte_dfa(pattern), \
        j_guided.compile_byte_dfa(pattern)
    assert got.n_states == want.n_states
    assert np.array_equal(got.delta, want.delta)
    assert np.array_equal(got.accepting, want.accepting)
    tg = guided.compile_token_guide(pattern, TOK, vocab=300,
                                    eos_id=TOK.eos_id)
    jg = j_guided.compile_token_guide(pattern, JByteTokenizer(), vocab=300,
                                      eos_id=TOK.eos_id)
    assert tg.n_states == jg.n_states and tg.table.dtype == np.int32
    assert np.array_equal(tg.table, jg.table)


@pytest.mark.parametrize("schema", SCHEMAS, ids=range(len(SCHEMAS)))
def test_json_guide_equals_the_reference(schema):
    """Identical regex strings and token tables for each schema."""
    assert (guided.json_schema_to_regex(schema)
            == j_guided.json_schema_to_regex(schema))
    tg = guided.compile_json_guide(schema, TOK, vocab=300, eos_id=TOK.eos_id)
    jg = j_guided.compile_json_guide(schema, JByteTokenizer(), vocab=300,
                                     eos_id=TOK.eos_id)
    assert tg.n_states == jg.n_states
    assert np.array_equal(tg.table, jg.table)


def test_guide_serials_are_monotonic():
    a = guided.compile_token_guide("ab", TOK, 300, TOK.eos_id)
    b = guided.compile_token_guide("ab", TOK, 300, TOK.eos_id)
    assert b.serial > a.serial


# ---- sampling under a mask ----


@pytest.mark.parametrize("temperature", [0.0, 0.8, 5.0])
def test_sample_never_picks_a_masked_token(temperature):
    """The largest logits of every row are masked out; greedy and sampled
    draws (with and without top-k/top-p) land on allowed tokens only, and
    greedy on the best allowed one."""
    rng = np.random.default_rng(0)
    B, V = 64, 300
    logits = torch.tensor(rng.standard_normal((B, V)) * 3, dtype=torch.float32)
    mask = torch.tensor(rng.random((B, V)) < 0.1)
    mask[:, 7] = True                               # every row allows one
    logits = torch.where(mask, logits, logits + 100.0)  # masked look best
    temps = torch.full((B,), temperature)
    gen = torch.Generator().manual_seed(1)
    for trunc in (dict(), dict(top_p=torch.full((B,), 0.9),
                               top_k=torch.full((B,), 5))):
        for _ in range(5):
            tok = sample(logits, temps, gen, mask=mask, **trunc)
            assert mask[torch.arange(B), tok].all()
    if temperature == 0.0:
        best = torch.where(mask, logits, -1e30).argmax(-1)
        assert torch.equal(sample(logits, temps, gen, mask=mask), best)


# ---- the engine ----


def _engines(params, **ecfg):
    pj, pt = params
    jcfg = jax_model_config()
    return (InferenceEngine(TINY, EngineConfig(**ecfg), params=pt,
                            device="cpu"),
            JInferenceEngine(jcfg, JEngineConfig(**ecfg), params=pj))


def jax_model_config():
    from ray_tpu.models import ModelConfig as JModelConfig
    return JModelConfig(**{f: getattr(TINY, f)
                           for f in TINY.__dataclass_fields__})


def _run(eng, prompts, guide, **kw):
    rids = [eng.add_request(p, guide=guide, **kw) for p in prompts]
    while eng.has_work():
        eng.step_window()
    return [eng.finished.pop(r).generated for r in rids]


def _text(tokens):
    return TOK.decode([t for t in tokens if t != TOK.eos_id])


@pytest.mark.parametrize("kind", ["regex", "json"])
def test_guided_greedy_matches_jax_engine(params, kind):
    """fp32 greedy under a guide: the port's tokens equal the JAX
    engine's token for token (one guided and one unguided request side by
    side), and the guided output matches its constraint."""
    if kind == "regex":
        make = lambda g: g.compile_token_guide(  # noqa: E731
            "[ab]{3}c", TOK, vocab=300, eos_id=TOK.eos_id)
    else:
        make = lambda g: g.compile_json_guide(  # noqa: E731
            NAME_N, TOK, vocab=300, eos_id=TOK.eos_id)
    eng, jeng = _engines(params, max_slots=2, max_len=96,
                         prompt_buckets=(16,), eos_token=TOK.eos_id)
    got = _run(eng, [[5, 6, 7]], make(guided), max_new_tokens=40,
               temperature=0.0)
    want = _run(jeng, [[5, 6, 7]], make(j_guided), max_new_tokens=40,
                temperature=0.0)
    assert got == want
    free = _run(eng, [[5, 6, 7]], None, max_new_tokens=8, temperature=0.0)
    assert free == _run(jeng, [[5, 6, 7]], None, max_new_tokens=8,
                        temperature=0.0)
    if kind == "regex":
        assert re.fullmatch("[ab]{3}c", _text(got[0]))
        assert got[0][-1] == TOK.eos_id


def test_guided_json_sampled_parses_to_the_schema(params):
    """At temperature 0.8 (the two frameworks' random streams differ, so
    no equality) the port's guided output parses to the schema, while an
    unguided request runs beside it unconstrained."""
    eng = _engines(params, max_slots=2, max_len=96, prompt_buckets=(16,),
                   eos_token=TOK.eos_id)[0]
    g = guided.compile_json_guide(NAME_N, TOK, vocab=300, eos_id=TOK.eos_id)
    rid_free = eng.add_request([10, 11, 12], max_new_tokens=64,
                               temperature=0.8)
    out = _run(eng, [[10, 11, 12]], g, max_new_tokens=64, temperature=0.8)
    obj = json.loads(_text(out[0]))
    assert set(obj) == {"name", "n"}
    assert isinstance(obj["name"], str) and isinstance(obj["n"], int)
    assert eng.finished.pop(rid_free).generated


def test_guide_table_uploads_follow_the_serial(params):
    """The stacked table uploads once for a run of windows under one
    guide, not again for another object with the same serial (a new id()),
    and again for a newly compiled guide (a new serial)."""
    eng = _engines(params, max_slots=2, max_len=64, prompt_buckets=(16,),
                   eos_token=-1)[0]
    g = guided.compile_token_guide("[ab]{30}", TOK, 300, TOK.eos_id)
    _run(eng, [[5, 6, 7]], g, max_new_tokens=20, temperature=0.0)
    assert eng.kv_stats()["decode_steps"] > 8     # several windows
    assert eng.guide_uploads == 1
    _run(eng, [[5, 6, 7]], dataclasses.replace(g), max_new_tokens=4,
         temperature=0.0)
    assert eng.guide_uploads == 1
    g2 = guided.compile_token_guide("[ab]{30}", TOK, 300, TOK.eos_id)
    _run(eng, [[5, 6, 7]], g2, max_new_tokens=4, temperature=0.0)
    assert eng.guide_uploads == 2


def test_guided_slot_survives_preemption(params):
    """A pool of 10 pages preempts guided slots; re-admitted, each resumes
    its DFA state: every output matches the pattern and the tokens equal
    the JAX engine's under the same pressure."""
    eng, jeng = _engines(params, max_slots=4, max_len=64,
                         prompt_buckets=(16,), eos_token=TOK.eos_id,
                         page_size=8, num_pages=10)
    prompts = [[3 + i, 4, 5] for i in range(4)]
    make = lambda g: g.compile_token_guide(  # noqa: E731
        "[ab]{20}c", TOK, vocab=300, eos_id=TOK.eos_id)
    got = _run(eng, prompts, make(guided), max_new_tokens=40,
               temperature=0.0)
    assert eng.kv_stats()["preemptions"] > 0
    for out in got:
        assert re.fullmatch("[ab]{20}c", _text(out))
    assert got == _run(jeng, prompts, make(j_guided), max_new_tokens=40,
                       temperature=0.0)
