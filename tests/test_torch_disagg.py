"""PyTorch port, the disaggregated prefill/decode serving plane
(`ray_tpu_torch.llm.serve`: `DisaggConfig`, `build_disagg_deployment`,
`build_disagg_openai_app`) on the CPU.

Local testing mode, against the JAX package's plane: both packages' pools
get the same fp32 weights (the session's tiny LLM params, assigned to
every pool's engine), and the cases of `tests/test_serve_disagg.py` run
on both: greedy text equal to the JAX plane's and to the port's
monolithic engine, logprobs within 1e-4 (the engine tests' tolerance),
overload shedding, handoff loss, router drops and the per-pool shed
metric. Then the port's own contracts: a resumed `decode_stream` yields
exactly the positions after `generated` with each logprob paired to its
token, the sealed handoff crosses the store bit for bit, the route key
needs no engine, a stream with logprobs is refused, tp > 1 is refused.

Through the port's runtime (one module-scoped runtime): a decode replica
SIGKILLed mid-storm resumes every stream exactly once, and a sustained
shed rate grows the decode pool. The proxy binds an ephemeral port (the
JAX package's serve tests hold fixed ones and run beside these); each test
runs under its own time limit; serve, the runtime and their daemons go at
the module's teardown.
"""

import asyncio
import contextlib
import dataclasses
import json
import signal
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu import serve as j_serve_api
from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import build_disagg_deployment as j_build_disagg_deployment
from ray_tpu.llm import build_disagg_openai_app as j_build_disagg_openai_app
from ray_tpu.llm.tokenizer import get_tokenizer as j_get_tokenizer
from ray_tpu_torch import serve
from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.status import OverloadedError
from ray_tpu_torch.llm import (DisaggConfig, EngineConfig, InferenceEngine,
                               LLMConfig, PrefillEngine,
                               build_disagg_deployment,
                               build_disagg_openai_app, build_llm_deployment)
from ray_tpu_torch.llm import serve as t_serve
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import ModelConfig, params_from_numpy

# test_serve_disagg.py's TINY model and ENG shape
TINY = ModelConfig(vocab=300, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype="float32")
_ENG = dict(max_slots=4, max_len=64, prompt_buckets=(32,), eos_token=-1,
            default_max_new_tokens=8, page_size=8)
ENG = EngineConfig(**_ENG)
LP_TOL = 1e-4


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


def _cfg(max_new=8, **kw):
    return LLMConfig(model_id="tiny", model=TINY,
                     engine=EngineConfig(**dict(
                         _ENG, default_max_new_tokens=max_new)),
                     tokenizer="byte", num_gpus_per_replica=0, device="cpu",
                     **kw)


def _jcfg(max_new=8):
    return JLLMConfig(model_id="tiny", model=_jmodel(),
                      engine=JEngineConfig(**dict(
                          _ENG, default_max_new_tokens=max_new)),
                      tokenizer="byte")


def _jmodel():
    from ray_tpu.models import ModelConfig as JModelConfig
    return JModelConfig(**{f: getattr(TINY, f)
                           for f in TINY.__dataclass_fields__})


@pytest.fixture(scope="module")
def weights(tiny_llm_params):
    """(JAX params, the same as port tensors on the CPU)."""
    jcfg, pj = tiny_llm_params
    assert {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__} == {
        f: getattr(TINY, f) for f in TINY.__dataclass_fields__}
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _coordinator(handle):
    """The coordinator instance behind a local-mode handle (its root, or
    the OpenAI router's server)."""
    target = handle._target
    server = getattr(target, "server", None)
    return server._target if server is not None else target


@contextlib.contextmanager
def _local_plane(app, params):
    """serve.run(app) in local testing mode with `params` in both pools'
    engines; yields the root handle and the coordinator; the decode pool's
    engine pump stops at exit."""
    run = (serve.run if app.__class__.__module__.startswith("ray_tpu_torch")
           else j_serve_api.run)
    h = run(app, local_testing_mode=True)
    coord = _coordinator(h)
    pre, dec = coord.prefill._target, coord.decode._target
    pre.engine.params = params
    dec.engine.params = dec._base_params = params
    try:
        yield h, coord
    finally:
        dec._stop = True


def _port_reference(params, prompts, max_new, logprobs=False):
    """Greedy tokens (and logprobs) of the port's monolithic engine."""
    tok = ByteTokenizer()
    eng = InferenceEngine(TINY, ENG, params=params, device="cpu")
    out = {}
    for p in prompts:
        rid = eng.add_request(tok.encode(p), max_new, 0.0, logprobs=logprobs)
        while eng.has_work():
            eng.step()
        req = eng.finished.pop(rid)
        out[p] = (req.generated, list(req.token_logprobs))
    return out


def _jax_reference_texts(pj, prompts, max_new):
    """Greedy text of a plain JAX engine (test_serve_disagg's reference)."""
    tok = j_get_tokenizer("byte")
    eng = JInferenceEngine(_jmodel(), JEngineConfig(**_ENG), params=pj)
    return {p: tok.decode(eng.generate([tok.encode(p)], max_new, 0.0)[0])
            for p in prompts}


class _Req:
    path = "/v1/completions"
    method = "POST"

    def __init__(self, body: dict):
        self.body = json.dumps(body).encode()


# ---- local testing mode, against the JAX package's plane ----


def test_disagg_local_mode_matches_dense(weights):
    """Through the OpenAI app in local testing mode: the port plane's
    completion equals the JAX plane's (text and usage) and the port's
    monolithic engine's greedy text; the prompt's full pages were handed
    off."""
    pj, pt = weights
    req = _Req({"prompt": "hello disagg world!", "max_tokens": 6,
                "temperature": 0.0})
    with time_limit(120), \
            _local_plane(build_disagg_openai_app(_cfg(6)), pt) as (h, coord), \
            _local_plane(j_build_disagg_openai_app(_jcfg(6)), pj) as (jh, _):
        out = h.remote(req).result(timeout_s=60)
        ref = jh.remote(req).result(timeout_s=60)
        stats = coord.stats()
    assert out["choices"][0]["text"] == ref["choices"][0]["text"]
    assert out["usage"] == ref["usage"]
    toks = _port_reference(pt, ["hello disagg world!"], 6)[
        "hello disagg world!"][0]
    assert out["choices"][0]["text"] == ByteTokenizer().decode(toks)
    assert stats["handoff_tokens"] == 16 and stats["completed"] == 1


def test_disagg_logprobs_match_dense_path(weights):
    """Logprobs thread through prefill-export (the first token's rides
    the prefill answer) and the decode stream's (token, logprob) pairs:
    the same tokens as the JAX plane and the port's monolithic
    deployment, values within 1e-4 of both; guided decoding stays
    refused."""
    pj, pt = weights
    p = "logprob parity probe!"
    kw = dict(max_tokens=6, temperature=0.0, logprobs=1)
    with time_limit(120), \
            _local_plane(build_disagg_deployment(_cfg(6)), pt) as (h, _), \
            _local_plane(j_build_disagg_deployment(_jcfg(6)), pj) as (jh, _):
        out = h.completions.remote(p, **kw).result(timeout_s=60)
        ref = jh.completions.remote(p, **kw).result(timeout_s=60)
        with pytest.raises(ValueError, match="guided"):
            h.completions.remote("x", guided_regex="a+").result(timeout_s=60)
    mono = serve.run(build_llm_deployment(_cfg(6)), local_testing_mode=True)
    mono._target.engine.params = mono._target._base_params = pt
    try:
        dense = mono.completions.remote(p, **kw).result(timeout_s=60)
    finally:
        mono._target._stop = True
    lp, jlp = out["choices"][0]["logprobs"], ref["choices"][0]["logprobs"]
    assert out["choices"][0]["text"] == ref["choices"][0]["text"] == \
        dense["choices"][0]["text"]
    assert lp["tokens"] == jlp["tokens"] == \
        dense["choices"][0]["logprobs"]["tokens"]
    assert len(lp["token_logprobs"]) == 6
    np.testing.assert_allclose(lp["token_logprobs"], jlp["token_logprobs"],
                               rtol=0, atol=LP_TOL)
    np.testing.assert_allclose(
        lp["token_logprobs"],
        dense["choices"][0]["logprobs"]["token_logprobs"], rtol=0,
        atol=LP_TOL)


def test_overload_sheds_fast_while_admitted_complete(weights):
    """Past the decode token budget requests shed at once with
    OverloadedError (never queued behind decode work), every admitted
    request completes with the JAX engine's text, and the budget is
    released after the storm."""
    pj, pt = weights
    max_new = 8
    prompts = [f"overload probe {i}" for i in range(8)]
    refs = _jax_reference_texts(pj, prompts, max_new)
    # Budget fits ~2 requests: cost = prompt(~16) + max_new(8).
    disagg = DisaggConfig(max_decode_inflight_tokens=52,
                          max_prefill_queue_tokens=64)
    done, shed, slow_sheds = {}, [], []
    with time_limit(120), _local_plane(
            build_disagg_deployment(_cfg(max_new), disagg), pt) as (h, _):

        def one(p):
            t0 = time.monotonic()
            try:
                done[p] = h.completions.remote(
                    p, max_tokens=max_new, temperature=0.0).result(
                    timeout_s=60)
            except OverloadedError as e:
                shed.append(p)
                assert "shed" in str(e)
                if time.monotonic() - t0 > 2.0:
                    slow_sheds.append(p)

        ts = [threading.Thread(target=one, args=(p,)) for p in prompts]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in ts)
        again = h.completions.remote(prompts[0], max_tokens=max_new,
                                     temperature=0.0).result(timeout_s=60)
    assert shed, "the storm must overflow the token budget"
    assert done, "backpressure must not starve everything"
    assert not slow_sheds, f"sheds queued behind decode: {slow_sheds}"
    assert len(done) + len(shed) == len(prompts)
    for p, out in done.items():
        assert out["choices"][0]["text"] == refs[p], p
    assert again["choices"][0]["text"] == refs[prompts[0]]


def test_kv_handoff_loss_falls_back_to_reprefill(weights):
    """serve.kv_handoff.lose: the decode pool re-prefills and gives the
    JAX engine's text."""
    pj, pt = weights
    p = "handoff loss probe"
    ref = _jax_reference_texts(pj, [p], 6)[p]
    with time_limit(120), _local_plane(
            build_disagg_deployment(_cfg(6)), pt) as (h, _):
        chaos.configure("serve.kv_handoff.lose:1", seed=5)
        try:
            out = h.completions.remote(p, max_tokens=6,
                                       temperature=0.0).result(timeout_s=60)
            _hits, fires = chaos.snapshot()["serve.kv_handoff.lose"]
        finally:
            chaos.configure("")
    assert fires == 1, "loss never injected: the test proves nothing"
    assert out["choices"][0]["text"] == ref


def test_router_drop_redriven_through_backoff(weights):
    """serve.router.drop: a dropped dispatch is redriven through the
    shared Backoff and the request still gives the JAX engine's text."""
    pj, pt = weights
    p = "router drop probe"
    ref = _jax_reference_texts(pj, [p], 6)[p]
    with time_limit(120), _local_plane(
            build_disagg_deployment(_cfg(6)), pt) as (h, coord):
        chaos.configure("serve.router.drop:1", seed=5)
        try:
            out = h.completions.remote(p, max_tokens=6,
                                       temperature=0.0).result(timeout_s=60)
            log = chaos.fire_log()
        finally:
            chaos.configure("")
    assert ("serve.router.drop", 1) in log
    assert coord.stats()["router_drops"] == 1
    assert out["choices"][0]["text"] == ref


def test_shed_metric_per_pool_and_prometheus_escaping():
    """Every admission shed bumps `ray_tpu_serve_shed_total{pool=...}` in
    the port's registry, tagged with the budget that tripped, as the JAX
    package's coordinator does on the same budgets; label values are
    escaped per the exposition format."""
    import collections
    import types

    from ray_tpu.core.status import OverloadedError as JOverloadedError
    from ray_tpu.llm import DisaggConfig as JDisaggConfig
    from ray_tpu.llm import serve as j_serve
    from ray_tpu_torch.util import metrics as umetrics

    def mk_coord(mod, cfg_cls, **cfg):
        coord = types.SimpleNamespace(
            d=cfg_cls(**cfg), _lock=threading.Lock(),
            _prefill_queue_tokens=0, _decode_inflight_tokens=0,
            _ongoing=0, _tok_rate_ema=0.0,
            _n_decode_live=1, _shed_pending=0, _shed_reporting=False,
            _local_decode=object(),  # short-circuits the shed reporter
            counters=collections.Counter())
        for m in ("_admit", "_maybe_report_sheds"):
            setattr(coord, m, types.MethodType(
                getattr(mod._DisaggServerImpl, m), coord))
        return coord

    def shed_counts():
        m = t_serve._shed_metric
        return dict(m._values) if m is not None else {}

    budgets = dict(max_prefill_queue_tokens=4, max_decode_inflight_tokens=6,
                   max_ongoing_requests=1)
    calls = [((2, 8), "decode"), ((5, 1), "prefill"), ((1, 1), None),
             ((1, 1), "requests")]
    before = shed_counts()
    for mod, cfg_cls, err in ((t_serve, DisaggConfig, OverloadedError),
                              (j_serve, JDisaggConfig, JOverloadedError)):
        c = mk_coord(mod, cfg_cls, **budgets)
        for args, pool in calls:
            if pool is None:
                c._admit(*args)
            else:
                with pytest.raises(err, match=f"pool={pool}"):
                    c._admit(*args)
        assert c.counters["shed"] == 3 and c.counters["shed_decode"] == 1
        slo = mk_coord(mod, cfg_cls, max_prefill_queue_tokens=1 << 20,
                       max_decode_inflight_tokens=1 << 20,
                       max_ongoing_requests=64, admission_slo_ms=1.0)
        slo._tok_rate_ema = 10.0
        slo._decode_inflight_tokens = 1000  # est wait 100 s >> 1 ms SLO
        with pytest.raises(err, match="pool=slo"):
            slo._admit(1, 1)
    after = shed_counts()
    for pool in ("decode", "prefill", "requests", "slo"):
        assert after.get((pool,), 0) == before.get((pool,), 0) + 1, pool

    text = umetrics.prometheus_text()
    assert "# TYPE ray_tpu_serve_shed_total counter" in text
    for pool in ("decode", "prefill", "requests", "slo"):
        assert f'ray_tpu_serve_shed_total{{pool="{pool}"}}' in text, pool
    t_serve._record_shed('bad"pool\nwith\\slash')
    assert ('ray_tpu_serve_shed_total{pool="bad\\"pool\\nwith\\\\slash"}'
            in umetrics.prometheus_text())


# ---- the port's own contracts ----


def test_resumed_decode_stream_yields_exactly_the_positions_after_generated(
        weights):
    """A decode replica given a prompt's handoff and the `generated`
    tokens a client holds (1: the prefill's first token; 3: a stream
    resumed after its replica died) streams exactly the monolithic
    engine's tokens after them, each once, each paired with its own
    logprob (1e-4); without the handoff (re-prefill) too. A stream
    abandoned after its first chunk cancels its request and frees its
    pages."""
    _pj, pt = weights
    tok = ByteTokenizer()
    text, max_new = "resume cursor probe", 8
    prompt = tok.encode(text)
    want, want_lp = _port_reference(pt, [text], max_new, logprobs=True)[text]
    pe = PrefillEngine(TINY, ENG, params=pt, device="cpu")
    first, ks, vs = pe.prefill_export(prompt, temperature=0.0)
    assert first == want[0] and ks.shape[1] == 16
    rep = t_serve._DecodeReplicaImpl(_cfg(max_new))
    rep.engine.params = rep._base_params = pt
    try:
        with time_limit(60):
            for n in (1, 3):
                for kv in (t_serve._seal_kv(ks, vs), None):
                    got = [x for c in rep.decode_stream(
                        prompt, want[:n], kv, max_new, 0.0, chunk_tokens=2,
                        want_logp=True) for x in c]
                    assert [t for t, _ in got] == want[n:], (n, kv is None)
                    np.testing.assert_allclose(
                        [lp for _, lp in got], want_lp[n:], rtol=0,
                        atol=LP_TOL)
                    plain = [t for c in rep.decode_stream(
                        prompt, want[:n], kv, max_new, 0.0) for t in c]
                    assert plain == want[n:]
            stream = rep.decode_stream(prompt, want[:1], None, 40, 0.0,
                                       chunk_tokens=1)
            next(stream)
            stream.close()
            while (rep.engine.finished or rep._discard
                   or rep.engine.active.any() or rep._token_subs):
                time.sleep(0.02)
        assert rep.engine.kv_stats()["pages_in_use"] == 0
    finally:
        rep._stop = True


def test_route_key_is_stable_and_needs_no_engine(weights):
    """The coordinator's route keys are the bytes of each page-aligned
    token prefix: the same across calls and argument types, shared by
    prompts that share a page, and computed without an engine (the
    coordinator holds none); prefix routing then prefers the replica that
    served the page."""
    _pj, pt = weights
    with _local_plane(build_disagg_deployment(_cfg()), pt) as (_h, coord):
        assert not hasattr(coord, "engine")
        a = list(range(1, 21))            # 2 full pages of 8 + 4
        b = a[:8] + [99] * 12
        ka = coord._prefix_keys(a)
        assert ka == coord._prefix_keys(np.asarray(a)) == \
            coord._prefix_keys(tuple(a))
        assert len(ka) == 2 and all(isinstance(k, bytes) for k in ka)
        assert ka[0] == np.asarray(a[:8], np.int32).tobytes()
        kb = coord._prefix_keys(b)
        assert kb[0] == ka[0] and kb[1] != ka[1]
        coord._record_route("r1", ka)
        coord._replica_load["r1"] = 100   # busier, but holds the page
        assert coord._pick_by_prefix(["r0", "r1"], kb) == "r1"
        assert coord._pick_by_prefix(["r0", "r1"],
                                     coord._prefix_keys([7] * 20)) == "r0"
        assert coord.stats()["route_prefix_hits"] == 1


def test_stream_with_logprobs_raises_on_the_plane(weights):
    """The router passes `logprobs` to every completions_stream: the
    plane streams text (equal to its completion) and refuses a stream
    with logprobs with a ValueError that names the plane, before any
    admission."""
    _pj, pt = weights
    with time_limit(60), _local_plane(
            build_disagg_deployment(_cfg(6)), pt) as (_h, coord):
        args = ("stream probe", 6, 0.0, 1.0, 0, None, None)
        with pytest.raises(ValueError, match="disaggregated plane"):
            list(coord.completions_stream(*args, True))
        assert coord.stats()["ongoing"] == 0 and "admitted" not in \
            coord.stats()
        streamed = "".join(coord.completions_stream(*args, False))
        whole = asyncio.run(coord.completions("stream probe", max_tokens=6,
                                              temperature=0.0))
    assert streamed == whole["choices"][0]["text"]


def test_tp2_builders_raise_naming_item_7f():
    """tp > 1 replicas (the second half of ROADMAP item 7 (f)): both
    disaggregated deployment functions make each pool's replica a gang
    of tp ranks, each in a bundle of the replica's placement group with
    a tp-th of its GPUs, and the coordinator on none; a tp that does not
    divide n_kv_heads, and a CUDA pool that reserves no GPU, are refused
    with a ValueError before any replica starts."""
    for fn in (build_disagg_deployment, build_disagg_openai_app):
        app = fn(_cfg(tensor_parallelism=2))
        coord = app.root if fn is build_disagg_deployment else \
            app.root.init_args[0].root
        _llm, _d, prefill, decode = coord.init_args
        for pool in (prefill.root, decode.root):
            c = pool.deployment.config
            assert c.ray_actor_options == {"num_cpus": 1, "num_gpus": 0.0}
            assert c.placement_group_bundles == [{"CPU": 1.0}] * 2
        assert coord.deployment.config.placement_group_bundles is None
        with pytest.raises(ValueError, match="tp=4 needs tp to divide "
                                             "n_kv_heads=2"):
            fn(_cfg(tensor_parallelism=4))
        with pytest.raises(ValueError, match="reserve"):
            fn(dataclasses.replace(_cfg(tensor_parallelism=2),
                                   device="cuda"))


# ---- through the port's runtime ----


def _free_port() -> int:
    """An ephemeral port from the OS (never one of the JAX package's
    serve tests' fixed ports)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runtime():
    """The port's runtime; serve, the runtime and their daemons go at
    teardown."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    try:
        yield rt
    finally:
        with time_limit(60):
            serve.shutdown()
            rt.shutdown()


def test_sealed_handoff_crosses_the_store_bit_exactly(runtime):
    """Under a runtime the prefill worker seals its export as one store
    object (numpy arrays, bf16 as its uint16 bits) and the decode side's
    fetch gives back the export bit for bit, in bf16 and in fp32."""
    prompt = list(range(3, 23))
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(_cfg(), model=dataclasses.replace(
            TINY, dtype=dtype))
        worker = t_serve._PrefillWorkerImpl(cfg)
        out = worker.prefill(prompt, 0.0)
        assert isinstance(out["kv"], runtime.ObjectRef), type(out["kv"])
        assert out["kv_tokens"] == 16
        _f, ks, vs = worker.engine.prefill_export(prompt, temperature=0.0)
        dec = t_serve._DecodeReplicaImpl.__new__(t_serve._DecodeReplicaImpl)
        gk, gv = dec._fetch_handoff(out["kv"], prompt)
        for got, want in ((gk, ks), (gv, vs)):
            assert got.dtype == want.dtype == getattr(torch, dtype)
            assert got.shape == want.shape
            assert torch.equal(got.view(torch.uint8),
                               want.contiguous().view(torch.uint8))


def _post(url, body, timeout=60):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _replicas(runtime, handle):
    """(router, [actor handle of each live replica]) of a deployment."""
    router = handle._get_router()
    return router, [router._handle_for(i) for i in router.live_replicas()]


def test_decode_sigkill_mid_storm_resumes_exactly_once(runtime):
    """Both decode replicas armed to SIGKILL themselves mid-stream (each
    replica alone: a respawned one comes back clean); a storm of greedy
    requests through HTTP all complete with the tokens of the port's own
    in-process engine on the replicas' seed, the first two with its
    logprobs (1e-4), and the coordinator counts resumed streams."""
    max_new = 10
    prompts = [f"shared prefix req {i}" for i in range(6)]
    refs = _port_reference(
        InferenceEngine(TINY, ENG, seed=0, device="cpu").params, prompts,
        max_new, logprobs=True)
    port = _free_port()
    with time_limit(240):
        serve.run(build_disagg_openai_app(_cfg(max_new),
                                          DisaggConfig(decode_replicas=2)),
                  name="disagg-kill", route_prefix="/kill", http_port=port,
                  blocking_timeout_s=150)
        try:
            dec = serve.get_deployment_handle("DecodePool:tiny",
                                              "disagg-kill")
            _router, reps = _replicas(runtime, dec)
            assert len(reps) == 2
            pids = {runtime.get(r.handle_request.remote(
                "configure_chaos", ["serve.decode.kill:4", 11], {}, ""),
                timeout=60) for r in reps}
            assert len(pids) == 2, "both decode replicas must be armed"
            results, errs = {}, {}

            def one(i, p):
                try:
                    results[p] = _post(
                        f"http://127.0.0.1:{port}/kill/v1/completions",
                        {"prompt": p, "max_tokens": max_new,
                         "temperature": 0.0,
                         **({"logprobs": 1} if i < 2 else {})}, timeout=180)
                except Exception as e:  # noqa: BLE001 — asserted below
                    errs[p] = repr(e)

            ts = [threading.Thread(target=one, args=(i, p))
                  for i, p in enumerate(prompts)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=200)
            assert not any(t.is_alive() for t in ts)
            stats = serve.get_deployment_handle(
                "DisaggLLMServer:tiny", "disagg-kill").stats.remote().result(
                timeout_s=30)
        finally:
            serve.delete("disagg-kill")
    tok = ByteTokenizer()
    assert not errs, f"admitted requests dropped: {errs}"
    assert stats.get("streams_resumed", 0) >= 1, stats
    assert stats["completed"] == len(prompts), stats
    for i, p in enumerate(prompts):
        want, want_lp = refs[p]
        assert results[p]["choices"][0]["text"] == tok.decode(want), p
        assert results[p]["usage"]["completion_tokens"] == max_new
        if i < 2:
            np.testing.assert_allclose(
                results[p]["choices"][0]["logprobs"]["token_logprobs"],
                want_lp, rtol=0, atol=LP_TOL)


def test_shed_rate_autoscales_decode_pool(runtime):
    """A sustained admission-shed rate (forwarded by the coordinator as
    record_shed_metrics) makes the controller grow the decode pool, and
    since the decode token budget is per live replica, a wave that shed
    at one replica admits fully at two."""
    max_new = 8
    prompts = [f"autoscale probe {i}" for i in range(6)]
    disagg = DisaggConfig(
        decode_replicas=1, max_decode_inflight_tokens=60,
        decode_autoscale=dict(min_replicas=1, max_replicas=2,
                              upscale_shed_rate=0.2, shed_window_s=8.0,
                              upscale_delay_s=0.2))
    with time_limit(240):
        serve.run(build_disagg_deployment(_cfg(max_new), disagg),
                  name="disagg-auto", route_prefix=None,
                  blocking_timeout_s=150)
        try:
            h = serve.get_deployment_handle("DisaggLLMServer:tiny",
                                            "disagg-auto")

            def wave(ps):
                done, shed = [], []

                def one(p):
                    try:
                        done.append(h.completions.remote(
                            p, max_tokens=max_new,
                            temperature=0.0).result(timeout_s=120))
                    except Exception as e:  # noqa: BLE001 — sorted below
                        if not t_serve._is_overload(e):
                            raise
                        shed.append(p)

                ts = [threading.Thread(target=one, args=(p,)) for p in ps]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=150)
                assert not any(t.is_alive() for t in ts)
                return done, shed

            done1, shed1 = wave(prompts)
            assert shed1, "the storm must overflow the 1-replica budget"
            assert done1, "backpressure must not starve everything"
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                st = serve.status()["disagg-auto"]["deployments"]
                if st["DecodePool:tiny"]["running_replicas"] >= 2:
                    break
                time.sleep(0.5)
            else:
                raise AssertionError(f"decode pool never scaled up: {st}")
            # one dispatch refreshes the coordinator's live count...
            h.completions.remote(prompts[0], max_tokens=max_new,
                                 temperature=0.0).result(timeout_s=120)
            stats = h.stats.remote().result(timeout_s=30)
            # ...and the doubled budget admits the 4-wide wave
            done2, shed2 = wave(prompts[:4])
        finally:
            serve.delete("disagg-auto")
    assert stats["n_decode_live"] >= 2, stats
    assert not shed2, f"post-scale-up wave still shed: {shed2}"
    assert len(done2) == 4
