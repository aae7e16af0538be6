"""PyTorch port, tensor-parallel LLM replicas as gangs of processes
(`ray_tpu_torch.llm._tp_gang`, used by `ray_tpu_torch.llm.serve`) on the
CPU.

A replica with tensor_parallelism = 2 is two processes in lockstep. In
one gloo process group of two ranks (`tests/test_torch_dist_workers.py`,
`tp_serve_suite`: rank 0 builds the replica class, rank 1 follows it),
`_LLMServerImpl` at tp = 2 gives the text of the port's at tp = 1 and of
the JAX package's `_LLMServerImpl` at tp = 1 (on the same weights, the
JAX side on its XLA paged attention as `tests/test_llm.py` runs it),
token for token in fp32, in the requests of `serve_scenario`: under six
concurrent requests (one cancelled by a stop string, one abandoned;
the streams against the port's only, since the JAX server's streams
drop a token, F9 in ROADMAP), with a guide, with logprobs (1e-4) and
with an adapter; the first request also equals the JAX server's at
tp = 2. Both ranks end with the
same engine state. A direct tp = 2 engine given an adapter's deltas cut
by its `local_blocks` equals tp = 1. The tp = 2 prefill gang seals a
full-width handoff equal to the port's tp = 1 export and the JAX
package's (1e-5), and the tp = 2 decode gang's tokens from it, and
F12's resumed streams, equal the monolithic tp = 1 engines' of both
packages (logprobs 1e-4).

Through the port's runtime (one module runtime, two tests): the OpenAI
app at tp = 2 answers as tp = 1, an adapter registered through the
handle reaches both ranks, a SIGKILLed follower gets its gang replaced
and the next request is answered exactly; the disaggregated pools as
gangs answer as the monolithic engine; no gang process outlives its
app.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import re
import signal
import socket
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import LoraConfig as JLoraConfig
from ray_tpu.llm import PrefillEngine as JPrefillEngine
from ray_tpu.llm import serve as j_serve
from ray_tpu.models import ModelConfig as JModelConfig
from ray_tpu_torch import serve
from ray_tpu_torch.llm import (DisaggConfig, EngineConfig, InferenceEngine,
                               PrefillEngine, build_openai_app)
from ray_tpu_torch.llm import serve as t_serve
from ray_tpu_torch.llm.lora import merge_lora
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import ModelConfig, init_params, params_to_numpy
from tests import test_torch_dist_workers as W

# test_serve_disagg.py's TINY: configs.tiny() at the byte tokenizer's vocab
TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")
CFG_KW = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)}
ENGINE = dict(max_slots=2, max_len=48, prompt_buckets=(16,), eos_token=-1)
DISAGG = dict(max_slots=4, max_len=64, prompt_buckets=(32,), eos_token=-1,
              default_max_new_tokens=8, page_size=8)
GUIDE = r'\{"a": [0-9]+'   # unbounded: the engines here have no eos
PROMPTS = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14]]
HANDOFF = ["hello disagg world!", "resume cursor probe"]
TOL = 1e-5      # fp32 handoff values
LP_TOL = 1e-4   # logprobs (the engine tests' tolerance)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the test body with TimeoutError after `seconds`."""
    def expire(_sig, _frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def params():
    """The weights every replica here builds from seed 0."""
    return init_params(TINY, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def lora_np():
    """Rank-2 factors for every target, B nonzero, as numpy."""
    rng = np.random.default_rng(11)
    return {t: {"A": rng.normal(size=(2, 64, 2)).astype(np.float32),
                "B": rng.normal(size=(2, 2, cols)).astype(np.float32) * 0.5}
            for t, cols in (("wq", 64), ("wk", 32), ("wv", 32), ("wo", 64))}


def _reference(params, engine_kw, prompts, max_new, logprobs=False):
    """Greedy tokens (and logprobs) of the port's monolithic tp = 1
    engine."""
    eng = InferenceEngine(TINY, EngineConfig(**engine_kw), params=params,
                          device="cpu")
    out = []
    for p in prompts:
        rid = eng.add_request(p, max_new, 0.0, logprobs=logprobs)
        while eng.has_work():
            eng.step()
        req = eng.finished.pop(rid)
        out.append((req.generated, list(req.token_logprobs)))
    return out


@pytest.fixture(scope="module")
def resume(params):
    """F12's case: the last handoff prompt, its 8 greedy tokens and their
    logprobs."""
    ids = ByteTokenizer().encode(HANDOFF[-1])
    (want, want_lp), = _reference(params, DISAGG, [ids], 8, logprobs=True)
    return ids, want, want_lp


@pytest.fixture(scope="module")
def suite(params, lora_np, resume):
    """Rank 0's results of `tp_serve_suite` on two gloo ranks."""
    ids, want, _lp = resume
    tok = ByteTokenizer()
    with time_limit(240):
        return W.run_group(
            W.tp_serve_suite, 2, CFG_KW, ENGINE, GUIDE,
            params_to_numpy(params), lora_np, PROMPTS, DISAGG,
            [tok.encode(p) for p in HANDOFF], (ids, want, 8),
            timeout=220)[0]


@pytest.fixture(scope="module")
def tp1(lora_np):
    """`serve_scenario` on the port's `_LLMServerImpl` at tp = 1."""
    impl = t_serve._LLMServerImpl(W.llm_config(CFG_KW, ENGINE))
    try:
        with time_limit(120):
            return W.serve_scenario(impl, GUIDE, lora_np)
    finally:
        impl._stop = True


@contextlib.contextmanager
def _jax_server(params, tp: int):
    """The JAX package's `_LLMServerImpl` at `tp` on the port's weights,
    on its XLA paged attention (as `tests/test_llm.py` runs it)."""
    old = os.environ.get("RAY_TPU_PAGED_ATTN_IMPL")
    os.environ["RAY_TPU_PAGED_ATTN_IMPL"] = "xla"
    srv = j_serve._LLMServerImpl(JLLMConfig(
        model_id="tiny", model=JModelConfig(**CFG_KW),
        engine=JEngineConfig(**ENGINE), tokenizer="byte",
        tensor_parallelism=tp, seed=0, lora=JLoraConfig(rank=2)))
    try:
        srv.engine.params = srv._base_params = jax.tree.map(
            lambda new, old: jax.device_put(new, old.sharding),
            params_to_numpy(params), srv.engine.params)
        yield srv
    finally:
        srv._stop = True
        if old is None:
            os.environ.pop("RAY_TPU_PAGED_ATTN_IMPL", None)
        else:
            os.environ["RAY_TPU_PAGED_ATTN_IMPL"] = old


@pytest.fixture(scope="module")
def jax_tp1(params, lora_np):
    """`serve_scenario` on the JAX package's `_LLMServerImpl` at tp = 1."""
    with _jax_server(params, 1) as srv, time_limit(180):
        return W.serve_scenario(srv, GUIDE, lora_np)


def _jax_text(params, tp: int) -> str:
    """`test_llm.py::test_serve_tp2_decode_identical_to_tp1`'s request on
    the JAX package's `_LLMServerImpl` at `tp`, on the port's weights."""
    with _jax_server(params, tp) as srv, time_limit(120):
        out = asyncio.run(srv.completions("hello tp", max_tokens=5,
                                          temperature=0.0))
    return out["choices"][0]["text"]


def _same_state(states):
    """Both ranks' engine state (`gang_state`) is the same, and no
    request is left queued or decoding."""
    a, b = ({k: v for k, v in s.items() if k != "pid"} for s in states)
    assert a == b, states
    assert not a["queued"] and not a["decoding"] and a["pages_in_use"] == 0
    assert states[0]["pid"] != states[1]["pid"]
    return a


# ---- two gloo ranks, no runtime ----


def test_serve_tp2_decode_identical_to_tp1(suite, tp1, jax_tp1, params):
    """The counterpart of `tests/test_llm.py`'s test of the same name:
    greedy decode through the OpenAI surface at tp = 2 equals tp = 1 —
    the port's gang, the port at tp = 1, and the JAX package's server at
    tp = 1 and tp = 2 (its XLA paged attention)."""
    got = suite["serve"]["hello"]
    assert got == tp1["hello"] == jax_tp1["hello"] == \
        _jax_text(params, 2), got
    assert len(ByteTokenizer().encode(got)) >= 5


def test_lockstep_under_concurrent_submission(suite, tp1, jax_tp1):
    """Six requests submitted from threads while the pump steps (four
    completions of mixed lengths, a stream cut by a stop string whose
    request is cancelled, a stream abandoned after its first delta):
    every answer at tp = 2 equals tp = 1's, the completions also the
    JAX server's (its streams drop a token, F9 in ROADMAP), and both
    ranks end with the same rids numbered, pages in use and finished
    requests (every rid numbered and neither queued nor decoding), as
    tp = 1 does."""
    tp2 = suite["serve"]
    assert tp2["full"] == tp1["full"]
    assert tp2["stop_at"] in tp2["full"]
    assert tp2["concurrent"] == tp1["concurrent"]
    assert tp2["concurrent"][:4] == jax_tp1["concurrent"][:4]
    assert tp2["stop_at"] not in tp2["concurrent"][4]
    assert tp2["full"].startswith(tp2["concurrent"][4])
    state = _same_state(tp2["states"])
    (one,) = tp1["states"]
    # decode steps depend on how the arrivals batched, in each run
    for k in ("next_rid", "queued", "decoding", "pages_in_use"):
        assert state[k] == one[k], k
    assert state["next_rid"] == 11


def test_guided_and_logprobs_at_tp2_equal_tp1(suite, tp1, jax_tp1):
    """A guided completion (each rank compiles the pattern the log
    carries) and a completion with logprobs at tp = 2 equal tp = 1's and
    the JAX server's."""
    tp2 = suite["serve"]
    assert tp2["guided"] == tp1["guided"] == jax_tp1["guided"]
    assert re.fullmatch(GUIDE, tp2["guided"]), tp2["guided"]
    for ref in (tp1, jax_tp1):
        assert tp2["logprobs"]["tokens"] == ref["logprobs"]["tokens"]
        np.testing.assert_allclose(tp2["logprobs"]["token_logprobs"],
                                   ref["logprobs"]["token_logprobs"],
                                   rtol=0, atol=LP_TOL)


def test_merged_adapter_on_rank_blocks_equals_tp1(suite, tp1, jax_tp1,
                                                  params, lora_np):
    """An adapter on the gang (materialized on every rank, each merging
    the deltas its engine cut to its blocks) answers as the port at tp =
    1 and the JAX server with the same factors, and not as the base. A
    direct tp = 2 engine given the deltas its `local_blocks` cut decodes
    as a tp = 1 engine given `merge_lora` of the full params. Rank blocks
    given full deltas raise."""
    got = suite["serve"]["adapter"]
    assert got == tp1["adapter"] == jax_tp1["adapter"] != tp1["hello"]
    ec = EngineConfig(**ENGINE)
    merged = InferenceEngine(TINY, ec, params=merge_lora(
        params, lora_np, 16.0), device="cpu")
    want = merged.generate(PROMPTS, max_new_tokens=6, temperature=0.0)
    base = InferenceEngine(TINY, ec, params=params, device="cpu").generate(
        PROMPTS, max_new_tokens=6, temperature=0.0)
    assert suite["adapter"] == want != base
    blocks = {"layers": {"wq": params["layers"]["wq"][:, :, :32]}}
    with pytest.raises(ValueError, match="local_blocks"):
        merge_lora(blocks, {"wq": lora_np["wq"]}, 16.0)
    with pytest.raises(ValueError, match="other shapes"):
        merged.params = {**params, "layers": {
            **params["layers"], "wq": params["layers"]["wq"][:, :, :32]}}


def test_prefill_gang_seals_the_full_width_handoff(suite, params):
    """The tp = 2 prefill gang's sealed handoff is full width ([L, S,
    hkv, hd], the ranks' heads in rank order) and equals the port's tp =
    1 export and the JAX package's `PrefillEngine` export within 1e-5 in
    fp32; the first token and its logprob equal theirs."""
    pre = PrefillEngine(TINY, EngineConfig(**DISAGG), params=params,
                        device="cpu")
    jpre = JPrefillEngine(JModelConfig(**CFG_KW), JEngineConfig(**DISAGG),
                          params=jax.tree.map(jax.numpy.asarray,
                                              params_to_numpy(params)))
    tok = ByteTokenizer()
    for text, got in zip(HANDOFF, suite["prefill"]):
        ids = tok.encode(text)
        first, ks, vs, lp = pre.prefill_export(ids, temperature=0.0,
                                               want_logp=True)
        jfirst, jks, jvs, jlp = jpre.prefill_export(ids, temperature=0.0,
                                                    want_logp=True)
        name, k, v = got["kv"]
        assert name == "float32" and got["first"] == first == int(jfirst)
        assert got["kv_tokens"] == ks.shape[1] == 16
        assert k.shape == tuple(ks.shape) == np.shape(jks)
        assert ks.shape[2] == 2
        for want_k, want_v in ((ks.numpy(), vs.numpy()),
                               (np.asarray(jks), np.asarray(jvs))):
            np.testing.assert_allclose(k, want_k, rtol=0, atol=TOL)
            np.testing.assert_allclose(v, want_v, rtol=0, atol=TOL)
        assert abs(got["first_logp"] - lp) <= LP_TOL
        assert abs(got["first_logp"] - float(jlp)) <= LP_TOL


def test_decode_gang_from_the_handoff_equals_monolithic(suite, params,
                                                        resume):
    """The tp = 2 decode gang, each rank importing its own kv heads of
    the sealed handoff, streams the monolithic tp = 1 engines' tokens
    (the port's and the JAX package's); F12's resumed streams at tp = 2
    (1 and 3 tokens held, with the handoff and without it) yield exactly
    the positions after them, each with its own logprob; both ranks end
    in the same state."""
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in HANDOFF]
    want = _reference(params, DISAGG, ids, 8)
    jwant = JInferenceEngine(JModelConfig(**CFG_KW), JEngineConfig(**DISAGG),
                             params=jax.tree.map(jax.numpy.asarray,
                                                 params_to_numpy(params))
                             ).generate(ids, 8, 0.0)
    dec = suite["decode"]
    for (gen, _), jgen, pre, got in zip(want, jwant, suite["prefill"],
                                        dec["handoff"]):
        assert [pre["first"], *got] == gen == list(jgen)
    _ids, full, full_lp = resume
    for n in (1, 3):
        for handoff in (True, False):
            got = dec[(n, handoff)]
            assert [t for t, _ in got] == full[n:], (n, handoff)
            np.testing.assert_allclose([lp for _, lp in got], full_lp[n:],
                                       rtol=0, atol=LP_TOL)
    _same_state(dec["states"])


# ---- through the port's runtime ----


def _free_port() -> int:
    """An ephemeral port from the OS (never one of the JAX package's
    serve tests' fixed ports)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\nState:\tZ" not in f.read()
    except OSError:
        return False


def _all_gone(pids, timeout=60.0):
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids):
        assert time.monotonic() < deadline, [p for p in pids if _alive(p)]
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runtime():
    """The port's runtime and an HTTP port; serve, the runtime and their
    daemons go at teardown. Its workers take two intra-op threads each
    (OMP_NUM_THREADS, read by torch at import), as this process does:
    six rank processes run beside other test files."""
    import ray_tpu_torch as rt
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    rt.init(num_cpus=6, object_store_memory=64 << 20)
    try:
        yield rt, _free_port()
    finally:
        try:
            with time_limit(60):
                serve.shutdown()
                rt.shutdown()
        finally:
            if old is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = old


def test_gang_through_the_runtime_with_an_adapter_and_a_dead_follower(
        runtime, tp1, params, lora_np):
    """`serve.run(build_openai_app(tp = 2))`: two rank processes in one
    placement group; the HTTP answer equals tp = 1's; an adapter
    registered through the handle reaches both ranks (its text equals an
    engine on the merged params); a SIGKILLed follower breaks the gang,
    the controller replaces the whole replica and the next request is
    answered exactly; no rank of either gang outlives the app."""
    _rt, port = runtime
    cfg = W.llm_config(CFG_KW, ENGINE, tensor_parallelism=2)
    url = f"http://127.0.0.1:{port}/tp/v1/completions"
    with time_limit(240):
        serve.run(build_openai_app(cfg), name="tp", route_prefix="/tp",
                  http_port=port, blocking_timeout_s=180)
        h = serve.get_deployment_handle("LLMServer:tiny", "tp")
        hello = {"prompt": "hello tp", "max_tokens": 5, "temperature": 0.0}
        assert _post(url, hello)["choices"][0]["text"] == tp1["hello"]
        pids = [s["pid"] for s in h.gang_call.remote(
            "gang_state").result(timeout_s=60)]
        assert len(set(pids)) == 2 and all(map(_alive, pids))

        h.load_adapter.remote("tiny-ft", lora_np).result(timeout_s=60)
        got = _post(url, {**hello, "model": "tiny-ft"})
        eng = InferenceEngine(TINY, EngineConfig(**ENGINE), params=merge_lora(
            params, lora_np, 16.0), device="cpu")
        (want,) = eng.generate([ByteTokenizer().encode("hello tp")], 5, 0.0)
        assert got["choices"][0]["text"] == ByteTokenizer().decode(want)
        assert got["choices"][0]["text"] != tp1["hello"]

        os.kill(pids[1], signal.SIGKILL)
        deadline = time.monotonic() + 120
        while True:
            assert time.monotonic() < deadline, "the gang was not replaced"
            try:
                new = [s["pid"] for s in h.gang_call.remote(
                    "gang_state").result(timeout_s=30)]
                if not set(new) & set(pids):
                    break
            except Exception:  # noqa: BLE001 — the broken gang, replaced
                pass
            time.sleep(0.5)
        out = h.completions.remote("hello tp", max_tokens=5,
                                   temperature=0.0).result(timeout_s=60)
        assert out["choices"][0]["text"] == tp1["hello"]
        _all_gone(pids)
        serve.delete("tp")
        _all_gone(new)


def test_disagg_pools_as_gangs_through_the_runtime(runtime, params):
    """`serve.run(build_disagg_openai_app(tp = 2))`: the prefill pool and
    the decode pool each one gang of two ranks (four processes); the
    HTTP answers equal the monolithic tp = 1 engine's, and no rank
    outlives the app."""
    _rt, port = runtime
    cfg = W.llm_config(CFG_KW, DISAGG, tensor_parallelism=2)
    url = f"http://127.0.0.1:{port}/dtp/v1/completions"
    tok = ByteTokenizer()
    want = _reference(params, DISAGG, [tok.encode(p) for p in HANDOFF], 8)
    with time_limit(240):
        serve.run(t_serve.build_disagg_openai_app(cfg, DisaggConfig(
            prefill_replicas=1, decode_replicas=1)), name="dtp",
            route_prefix="/dtp", http_port=port, blocking_timeout_s=180)
        for text, (gen, _) in zip(HANDOFF, want):
            got = _post(url, {"prompt": text, "max_tokens": 8,
                              "temperature": 0.0})
            assert got["choices"][0]["text"] == tok.decode(gen)
        pids = [s["pid"] for name in ("PrefillPool:tiny", "DecodePool:tiny")
                for s in serve.get_deployment_handle(name, "dtp").gang_call
                .remote("gang_state").result(timeout_s=60)]
        assert len(set(pids)) == 4 and all(map(_alive, pids))
        serve.delete("dtp")
        _all_gone(pids)
