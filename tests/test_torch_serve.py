"""PyTorch port, serving (`ray_tpu_torch.serve`, `ray_tpu_torch.llm.serve`,
`ray_tpu_torch.llm.lora`) on the CPU.

In process: the port's `_LLMServerImpl` and the JAX package's, given the
same fp32 weights (the session's tiny LLM params, configs.tiny()'s
geometry at the byte tokenizer's vocab) through the reference's own
mechanism (`engine.params` and `_base_params`), give the same
temperature-0 completions and chat text, streams, stop-sequence cuts
and logprobs (1e-4, the engine tests' tolerance), with and without a
LoRA adapter given as the same numpy factors. The cases mirror
`tests/test_llm.py`'s.

Through the port's runtime (one module-scoped runtime and one OpenAI
app): a deployment and its handle, `@serve.batch`, the HTTP proxy's
OpenAI routes and SSE stream, and an adapter by `model=`. The proxy binds
an ephemeral port: the JAX package's serve tests hold fixed ports (8000,
8123, 8127) and run beside these in parallel test workers. Each test
runs under its own time limit; the runtime and its daemons go at the
module's teardown.
"""

import asyncio
import contextlib
import dataclasses
import http.client
import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import LoraConfig as JLoraConfig
from ray_tpu.llm import lora as j_lora
from ray_tpu.llm import serve as j_serve
from ray_tpu_torch.llm import EngineConfig, LLMConfig, LoraConfig
from ray_tpu_torch.llm import lora as t_lora
from ray_tpu_torch.llm import serve as t_serve
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import configs, params_from_numpy
from tests import test_torch_dist_workers as W

# configs.tiny() at the byte tokenizer's vocab (258 ids)
TINY = dataclasses.replace(configs.tiny(), vocab=300)
_ECFG = dict(max_slots=2, max_len=64, prompt_buckets=(32,), eos_token=-1,
             default_max_new_tokens=4)
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


def _port_cfg(**kw):
    return LLMConfig(model_id="tiny", model=TINY, engine=EngineConfig(**_ECFG),
                     tokenizer="byte", lora=LoraConfig(rank=2),
                     num_gpus_per_replica=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def servers(tiny_llm_params):
    """(JAX server, port server) on the same fp32 weights."""
    jcfg, pj = tiny_llm_params
    assert {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__} == {
        f: getattr(TINY, f) for f in TINY.__dataclass_fields__}
    js = j_serve._LLMServerImpl(JLLMConfig(
        model_id="tiny", model=jcfg, engine=JEngineConfig(**_ECFG),
        tokenizer="byte", lora=JLoraConfig(rank=2)))
    ts = t_serve._LLMServerImpl(_port_cfg())
    js.engine.params = js._base_params = pj
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    ts.engine.params = ts._base_params = pt
    yield js, ts
    js._stop = ts._stop = True


def _both(servers, method, *args, **kw):
    return [asyncio.run(getattr(s, method)(*args, **kw)) for s in servers]


def _stream(srv, *args, **kw):
    return list(srv.completions_stream(*args, **kw))


@pytest.fixture(scope="module")
def lora_np():
    """Rank-2 factors for every target, B nonzero, as numpy."""
    rng = np.random.default_rng(11)
    out = {}
    for t, (rows, cols) in {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32),
                            "wo": (64, 64)}.items():
        out[t] = {"A": rng.normal(size=(2, rows, 2)).astype(np.float32),
                  "B": rng.normal(size=(2, 2, cols)).astype(np.float32)
                  * 0.5}
    return out


# ---- in process, against the JAX package's server ----


def test_completions_and_chat_match_jax(servers):
    """Temperature-0 completions and chat: the same text, usage and
    finish reasons."""
    j, t = _both(servers, "completions", "hello there", max_tokens=8,
                 temperature=0.0)
    assert t["choices"][0]["text"] == j["choices"][0]["text"]
    assert t["usage"] == j["usage"] == {"prompt_tokens": 12,
                                        "completion_tokens": 8,
                                        "total_tokens": 20}
    assert t["choices"][0]["finish_reason"] == "length"
    msgs = [{"role": "user", "content": "hi"}]
    j, t = _both(servers, "chat", msgs, max_tokens=6, temperature=0.0)
    assert t["choices"][0]["message"] == j["choices"][0]["message"]
    assert t["object"] == j["object"] == "chat.completion"


def test_stop_sequences_and_logprobs_match_jax(servers):
    """A stop string cuts the text where the JAX server cuts it
    (finish_reason stop), and the logprobs block aligned with the cut
    text matches the JAX one within 1e-4."""
    j, t = _both(servers, "completions", "hi", max_tokens=8,
                 temperature=0.0)
    full = t["choices"][0]["text"]
    assert full == j["choices"][0]["text"] and len(full) >= 2
    stop_at = full[1]
    for stop in (None, [stop_at]):
        j, t = _both(servers, "completions", "hi", max_tokens=8,
                     temperature=0.0, stop=stop, logprobs=True)
        tc, jc = t["choices"][0], j["choices"][0]
        assert (tc["text"], tc["finish_reason"]) == (jc["text"],
                                                     jc["finish_reason"])
        assert tc["logprobs"]["tokens"] == jc["logprobs"]["tokens"]
        np.testing.assert_allclose(tc["logprobs"]["token_logprobs"],
                                   jc["logprobs"]["token_logprobs"],
                                   rtol=0, atol=LP_TOL)
    assert stop_at not in tc["text"] and full.startswith(tc["text"])
    assert tc["finish_reason"] == "stop"


def test_stream_matches_jax_with_logprobs(servers):
    """completions_stream streams the text of the JAX server's
    completions, with and without a stop string; with logprobs, the
    stream's entries together are the port's non-streaming logprobs block
    of the same text (read from the live request, `engine.request`) and
    the JAX server's within 1e-4. The JAX server's own stream loses a
    request's first token (ROADMAP queue 3, F8): its text is the rest."""
    js, ts = servers
    for stop in (None, ["!"], [","]):
        block = _both(servers, "completions", "hi", max_tokens=8,
                      temperature=0.0, stop=stop, logprobs=True)
        jc, tc = (b["choices"][0] for b in block)
        assert tc["text"] == jc["text"]
        assert "".join(_stream(ts, "hi", 8, 0.0, stop=stop)) == jc["text"]
        got = _stream(ts, "hi", 8, 0.0, stop=stop, logprobs=True)
        assert "".join(c["text"] for c in got) == jc["text"]
        tokens = [x for c in got for x in c["logprobs"]["tokens"]]
        lps = [x for c in got for x in c["logprobs"]["token_logprobs"]]
        assert tokens == tc["logprobs"]["tokens"] == jc["logprobs"]["tokens"]
        assert lps == tc["logprobs"]["token_logprobs"]
        np.testing.assert_allclose(lps, jc["logprobs"]["token_logprobs"],
                                   rtol=0, atol=LP_TOL)
    assert tc["finish_reason"] == "stop"
    full = _both(servers, "completions", "hi", max_tokens=8,
                 temperature=0.0, logprobs=True)[0]["choices"][0]
    first = full["logprobs"]["tokens"][0]
    assert full["text"] == first + "".join(_stream(js, "hi", 8, 0.0))


def test_hold_incomplete_utf8_matches_jax():
    """The UTF-8 holdback: the same function as the JAX package's, and a
    multi-byte character straddling byte tokens streams whole through the
    real completions_stream (a controlled token feed, as
    test_stream_utf8_boundary_holdback drives the JAX server)."""
    for s in ("abc", "a�", "��", "é�", "", "x�y"):
        assert t_serve._hold_incomplete_utf8(s) == \
            j_serve._hold_incomplete_utf8(s)
    impl = t_serve._LLMServerImpl.__new__(t_serve._LLMServerImpl)
    impl.tokenizer = ByteTokenizer()
    impl._lock = threading.Lock()
    impl._token_subs = {}
    impl._sub_sent = {}
    impl._discard = set()
    impl._log, impl._live, impl._opened = [], {}, {}

    class _Eng:
        params = None
        finished = {}

        def check_request(self, ids, *a, **k):
            pass

        def reserve_request_id(self):
            return 1

        def cancel(self, rid):
            raise AssertionError("a clean end must not cancel")

    impl.engine = _Eng()
    impl._params_for = lambda model: None
    payload = "a😀é!"

    def feed():
        deadline = time.monotonic() + 10
        while 1 not in impl._token_subs:
            if time.monotonic() > deadline:
                return
            time.sleep(0.005)
        q = impl._token_subs[1]
        for b in payload.encode("utf-8"):
            q.put(b)
        q.put(None)

    threading.Thread(target=feed, daemon=True).start()
    with time_limit(30):
        deltas = list(impl.completions_stream("hi", max_tokens=16))
    assert "".join(deltas) == payload
    assert all("�" not in d for d in deltas), deltas


def test_stream_early_stop_no_leak():
    """A stream cut by a stop sequence cancels its engine request: the
    slot frees, no finished record strands and the pump discards the
    cancelled request's record."""
    impl = t_serve._LLMServerImpl(_port_cfg())
    try:
        with time_limit(60):
            full = "".join(impl.completions_stream("hi", 6, 0.0))
            assert len(full) >= 2
            stop_at = full[1]
            out = "".join(impl.completions_stream("hi", 6, 0.0,
                                                  stop=[stop_at]))
            assert stop_at not in out and full.startswith(out)
            while (impl.engine.finished or impl._discard
                   or impl.engine.active.any()):
                time.sleep(0.05)
        assert impl.engine.kv_stats()["pages_in_use"] == 0
    finally:
        impl._stop = True


def test_stream_stopped_as_its_request_ends_strands_nothing():
    """F19: a stream whose consumer stops after the pump has ended its
    request (the record popped, the end queued but not read) cancels
    nothing and leaves no rid in the discard set, which no record would
    ever clear."""
    impl = t_serve._LLMServerImpl(_port_cfg())
    try:
        with time_limit(60):
            stream = impl.completions_stream("hi", 8, 0.0)
            next(stream)
            rid = impl.engine._next_id - 1
            req = impl.engine.request(rid)
            while not req.done or rid in impl.engine.finished:
                time.sleep(0.01)
            stream.close()         # stops before it reads the end
            time.sleep(0.2)        # a pump turn or more
            assert not impl._discard, impl._discard
            assert not impl.engine.finished
            assert not impl.engine.active.any()
    finally:
        impl._stop = True


def test_lora_merge_and_adapter_text_match_jax(servers, lora_np):
    """merge_lora folds the same delta as the JAX package's (B = 0 is the
    identity; fp32 within 1e-6), init_lora draws the JAX package's shapes
    and the demo adapter's seed is a digest of the id; an adapter given
    as the same numpy factors gives both servers the same text, which
    differs from the base text, and the base model's text comes back
    after it."""
    js, ts = servers
    pj = js._base_params
    pt = ts._base_params
    zero = t_lora.init_lora(TINY, 4, torch.Generator().manual_seed(1))
    jzero = j_lora.init_lora(TINY, 4, jax.random.PRNGKey(1))
    assert {t: {k: tuple(v.shape) for k, v in ab.items()}
            for t, ab in zero.items()} == {
        t: {k: tuple(v.shape) for k, v in ab.items()}
        for t, ab in jzero.items()}
    same = t_lora.merge_lora(pt, zero, alpha=16.0)
    for t in t_lora.TARGETS:
        assert torch.equal(same["layers"][t], pt["layers"][t])
    merged = t_lora.merge_lora(pt, lora_np, alpha=16.0)
    jmerged = j_lora.merge_lora(pj, lora_np, alpha=16.0)
    for t in t_lora.TARGETS:
        np.testing.assert_allclose(merged["layers"][t].numpy(),
                                   np.asarray(jmerged["layers"][t]),
                                   rtol=0, atol=1e-6)
    assert t_lora.adapter_seed("tiny-ft") == t_lora.adapter_seed("tiny-ft")
    assert t_lora.adapter_seed("tiny-ft") != t_lora.adapter_seed("tiny-ft2")

    base = _both(servers, "completions", "x", max_tokens=6,
                 temperature=0.0)
    for s in servers:
        s._materialize("tiny-ft", lora_np, 16.0)
    j, t = _both(servers, "completions", "x", max_tokens=6,
                 temperature=0.0, model="tiny-ft")
    assert t["model"] == "tiny-ft"
    assert t["choices"][0]["text"] == j["choices"][0]["text"]
    assert t["choices"][0]["text"] != base[1]["choices"][0]["text"]
    again = _both(servers, "completions", "x", max_tokens=6,
                  temperature=0.0)
    assert [a["choices"][0]["text"] for a in again] == [
        b["choices"][0]["text"] for b in base]
    assert ts.model_ids() == ["tiny", "tiny-ft"]


def test_serve_batch_across_event_loops():
    """A replica's async actor runs its calls on several event loops
    (the runtime's executor shards): two calls from two loops fill one
    batch, and the call whose loop did not run the batch is woken at
    once, not when its timed flush would have come (5 s here)."""
    from ray_tpu_torch import serve
    sizes = []

    @serve.batch(max_batch_size=2, batch_wait_timeout_s=5.0)
    async def double(xs):
        sizes.append(len(xs))
        return [2 * x for x in xs]

    out = {}

    def call(x):
        t0 = time.monotonic()
        out[x] = (asyncio.run(double(x)), time.monotonic() - t0)

    threads = [threading.Thread(target=call, args=(x,)) for x in (1, 2)]
    for t in threads:
        t.start()
        time.sleep(0.1)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sizes == [2]
    assert {x: r for x, (r, _) in out.items()} == {1: 2, 2: 4}
    assert max(dt for _, dt in out.values()) < 2.0, out


def test_proxy_requests_during_a_route_fetch_see_its_routes(monkeypatch):
    """A request that reaches the HTTP proxy while another's route fetch
    is in flight matches the fetched routes: it used to match the routes
    from before the fetch, so a new app's first concurrent requests could
    get 404."""
    from ray_tpu_torch.serve import proxy

    class _Controller:
        class get_http_routes:   # noqa: N801 — an actor method's handle
            @staticmethod
            def remote():
                return "ref"

    def slow_get(ref, timeout=None):
        time.sleep(0.3)
        return {"/app": ("app", "Ingress", "")}

    monkeypatch.setattr(proxy.ray_tpu_torch, "get_actor",
                        lambda name: _Controller())
    monkeypatch.setattr(proxy.ray_tpu_torch, "get", slow_get)
    p = proxy.ProxyActor(0)

    async def concurrent():
        async def late():
            await asyncio.sleep(0.1)   # while the first fetch is in flight
            await p._refresh_routes()
            return p._match("/app/v1/completions")
        _, match = await asyncio.gather(p._refresh_routes(), late())
        return match

    assert asyncio.run(concurrent()) == ("/app", ("app", "Ingress", ""))



def test_controller_keeps_one_health_check_in_flight(monkeypatch):
    """A replica that has not answered its health check (one still in
    its __init__) gets no second one: each check holds a thread of the
    controller loop's executor, which the controller's replies also
    need, so a check started every period starved them (get_status timed
    out while a tp gang booted). The check gives its thread back at the
    health-check timeout."""
    from ray_tpu_torch.serve import controller as ctl
    from ray_tpu_torch.serve.config import DeploymentConfig
    started, released = [], asyncio.Event()

    async def pending(ref, timeout=None):
        started.append(timeout)
        await released.wait()

    class _Handle:
        class check_health:
            @staticmethod
            def remote():
                return object()
    monkeypatch.setattr(ctl, "_await_ref", pending)
    cfg = DeploymentConfig(health_check_period_s=0.001,
                           health_check_timeout_s=7.0)
    ds = ctl._DeploymentState("app", "d", {"config": cfg})
    ds.replicas.append(ctl._ReplicaState("r1", "n", _Handle(), 0))
    c = ctl.ServeController(None)

    async def drive():
        for _ in range(20):
            await c._reconcile_deployment(ds)
            await asyncio.sleep(0.005)
        assert started == [7.0]
        released.set()
        await asyncio.sleep(0.01)
        await c._reconcile_deployment(ds)
        await asyncio.sleep(0.01)
    asyncio.run(drive())
    assert len(started) == 2 and ds.replicas[0].healthy

def test_not_in_slice_raises():
    """A tp > 1 replica builds, in the monolithic deployment and in both
    disaggregated pools: a gang of tp ranks in one placement group of tp
    bundles packed on one node, each rank a tp-th of the replica's GPUs.
    A tp that does not divide n_kv_heads is refused with a ValueError
    before any replica starts, and a CUDA replica that reserved no GPU
    raises instead of running on the CPU."""
    assert t_serve._tp_gang.join(_port_cfg(), None) is None   # tp = 1
    cuda = dataclasses.replace(_port_cfg(), device="cuda")
    tp2 = dataclasses.replace(cuda, tensor_parallelism=2,
                              num_gpus_per_replica=1.0)
    server = t_serve.build_openai_app(tp2).root.init_args[0].root
    coord = t_serve.build_disagg_openai_app(tp2).root.init_args[0].root
    _llm, _d, prefill, decode = coord.init_args
    for node in (server, prefill.root, decode.root):
        c = node.deployment.config
        assert c.ray_actor_options == {"num_cpus": 1, "num_gpus": 0.5}
        assert c.placement_group_bundles == [{"CPU": 1.0, "GPU": 0.5}] * 2
    assert coord.deployment.config.placement_group_bundles is None
    for fn in (t_serve.build_openai_app, t_serve.build_llm_deployment,
               t_serve.build_disagg_deployment,
               t_serve.build_disagg_openai_app):
        with pytest.raises(ValueError, match="tp=4.*n_kv_heads=2"):
            fn(_port_cfg(tensor_parallelism=4))
        with pytest.raises(ValueError, match="reserve"):
            fn(dataclasses.replace(cuda, tensor_parallelism=2))
    with pytest.raises(ValueError, match="reserve"):
        t_serve._replica_device(cuda)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no.*available|none is"):
            t_serve._replica_device(dataclasses.replace(
                cuda, num_gpus_per_replica=1))


# ---- through the port's runtime ----


def _free_port() -> int:
    """An ephemeral port from the OS (never one of the JAX package's
    serve tests' fixed ports)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def app():
    """The port's runtime and one OpenAI app on an ephemeral port;
    serve, the runtime and their daemons go at teardown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    port = _free_port()
    assert port not in (8000, 8123, 8127)
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    try:
        with time_limit(180):
            serve.run(t_serve.build_openai_app(_port_cfg()), name="llm",
                      route_prefix="/llm", http_port=port,
                      blocking_timeout_s=150)
        yield f"http://127.0.0.1:{port}/llm", port
    finally:
        with time_limit(60):
            serve.shutdown()
            rt.shutdown()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_deployment_and_handle(app):
    """The LLM deployment through its handle gives the text of an
    in-process server with the same config (the same seeded weights);
    the serve status and the metrics' replica gauge see it running."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.util import metrics
    with time_limit(120):
        h = serve.get_deployment_handle("LLMServer:tiny", "llm")
        got = h.completions.remote("hi", max_tokens=5,
                                   temperature=0.0).result(timeout_s=60)
        local = t_serve._LLMServerImpl(_port_cfg())
        try:
            want = asyncio.run(local.completions("hi", max_tokens=5,
                                                 temperature=0.0))
        finally:
            local._stop = True
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        st = serve.status()["llm"]
        assert st["status"] == "RUNNING"
        assert st["deployments"]["LLMServer:tiny"]["running_replicas"] == 1
        text = metrics.prometheus_text()
        assert ('serve_num_replicas{application="llm",'
                'deployment="LLMServer:tiny"} 1') in text


def test_serve_batch_gathers_concurrent_calls(app):
    """@serve.batch in a replica: concurrent handle calls ride one batch
    and each caller gets its own element."""
    from ray_tpu_torch import serve
    with time_limit(120):
        serve.run(serve.deployment(W.BatchedDoubler).bind(), name="batch",
                  route_prefix=None, blocking_timeout_s=90)
        try:
            h = serve.get_app_handle("batch")
            outs = [r.result(timeout_s=60)
                    for r in [h.remote(i) for i in range(4)]]
            assert [o[0] for o in outs] == [0, 2, 4, 6]
            assert max(o[1] for o in outs) > 1
        finally:
            serve.delete("batch")


def test_openai_routes_and_sse_stream(app):
    """/v1/models, /v1/completions, /v1/chat/completions and stop over
    HTTP; stream=true serves SSE chunks (logprobs carried when asked)
    ending in [DONE] whose text is the non-streaming text."""
    base, port = app
    with time_limit(120):
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            assert json.load(r)["data"][0]["id"] == "tiny"
        out = _post(base + "/v1/completions",
                    {"prompt": "hi", "max_tokens": 6, "temperature": 0.0,
                     "logprobs": True})
        assert out["object"] == "text_completion"
        assert out["usage"]["completion_tokens"] == 6
        lp = out["choices"][0]["logprobs"]
        assert len(lp["token_logprobs"]) == 6
        chat = _post(base + "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "hello"}],
                      "max_tokens": 2})
        assert chat["choices"][0]["message"]["role"] == "assistant"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/llm/v1/completions", body=json.dumps(
            {"prompt": "hi", "max_tokens": 6, "temperature": 0.0,
             "stream": True, "logprobs": True}).encode(),
            headers={"content-type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers.get("content-type", "").startswith(
            "text/event-stream")
        raw = resp.read().decode()
        conn.close()
    events = [ln for ln in raw.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]"
    chunks = [json.loads(e[6:]) for e in events[:-1]]
    assert chunks and all(c["choices"][0]["finish_reason"] is None
                          for c in chunks)
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        out["choices"][0]["text"]
    assert [x for c in chunks
            for x in c["choices"][0]["logprobs"]["token_logprobs"]] == \
        lp["token_logprobs"]


def test_adapter_by_model_over_http(app, lora_np):
    """An adapter registered through the handle (stored in the head KV as
    numpy factors) serves by `model=` with the text of an in-process
    server that merged the same factors; an unknown id is a 400."""
    from ray_tpu_torch import serve
    base, _ = app
    with time_limit(120):
        h = serve.get_deployment_handle("LLMServer:tiny", "llm")
        assert h.load_adapter.remote("tiny-ft", lora_np).result(
            timeout_s=60) == ["tiny-ft"]
        out = _post(base + "/v1/completions",
                    {"prompt": "x", "max_tokens": 5, "temperature": 0.0,
                     "model": "tiny-ft"})
        assert out["model"] == "tiny-ft"
        local = t_serve._LLMServerImpl(_port_cfg())
        try:
            local._materialize("tiny-ft", lora_np, 16.0)
            want = asyncio.run(local.completions(
                "x", max_tokens=5, temperature=0.0, model="tiny-ft"))
        finally:
            local._stop = True
        assert out["choices"][0]["text"] == want["choices"][0]["text"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/completions",
                  {"prompt": "x", "model": "no-such"})
        assert e.value.code == 400
