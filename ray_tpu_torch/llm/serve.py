"""LLM serving: the engine-backed deployment and the OpenAI-compatible
router in front of it (counterpart of `ray_tpu/llm/serve.py`, its
monolithic deployment).

Parity: reference `python/ray/llm/_internal/serve/` — `LLMServer`
deployment wrapping the engine (`deployments/llm/`), OpenAI-compatible
ingress (`deployments/routers/router.py`, /v1/chat/completions etc.), LoRA
multiplexing (`deployments/llm/multiplex/`). The engine is the port's
in-process continuous-batching engine (`llm/engine.py`) on the card the
replica reserved (`LLMConfig.num_gpus_per_replica`), its decode attention
the hand-written paged-decode kernel.

Not in this slice (ROADMAP queue 1 item 7 (f)): replicas with
tensor_parallelism > 1 (the port's tp engine is SPMD, so such a replica
is a gang of processes in lockstep) and the disaggregated prefill/decode
plane (`build_disagg_deployment`, `build_disagg_openai_app`). Both raise
NotImplementedError.
"""

from __future__ import annotations

import asyncio
import dataclasses
import pickle
import threading
import time
import uuid

import numpy as np
import torch

from ray_tpu_torch import resolve_device, serve
from ray_tpu_torch.core.status import OverloadedError
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.llm.lora import adapter_seed, init_lora, merge_lora
from ray_tpu_torch.llm.tokenizer import get_tokenizer

_LATER = ("a later slice of the PyTorch port (ROADMAP queue 1 item 7 (f): "
          "tensor-parallel replicas as process gangs and the disaggregated "
          "prefill/decode plane)")


def _wire_eos(engine_cfg: EngineConfig, tokenizer) -> EngineConfig:
    """Stop on the TOKENIZER's eos unless the user overrode the default."""
    eos = getattr(tokenizer, "eos_id", None)
    if eos is not None and engine_cfg.eos_token == EngineConfig().eos_token:
        return dataclasses.replace(engine_cfg, eos_token=eos)
    return engine_cfg


def _replica_mesh(llm_config: LLMConfig):
    """The replica's tp mesh: None at tp = 1. A tp > 1 replica is a gang
    of tp processes in lockstep under the port's SPMD engine, which is
    not ported yet."""
    if llm_config.tensor_parallelism <= 1:
        return None
    raise NotImplementedError(
        f"an LLM replica with tensor_parallelism="
        f"{llm_config.tensor_parallelism} is {_LATER}")


def _replica_device(llm_config: LLMConfig) -> torch.device:
    """The replica's engine device: the CPU when the config asks for it,
    else the card the replica reserved. A replica that asks for CUDA and
    reserved no GPU raises; it never falls back to the CPU."""
    if llm_config.device == "cpu":
        return torch.device("cpu")
    if llm_config.num_gpus_per_replica <= 0:
        raise ValueError(
            f"LLMConfig(device={llm_config.device!r}) with "
            f"num_gpus_per_replica={llm_config.num_gpus_per_replica}: a "
            f"replica runs on the card it reserves; reserve one, or ask "
            f"for device='cpu'")
    return resolve_device(llm_config.device)  # raises if CUDA sees none


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class _LLMServerImpl:
    """One engine per replica; a background thread pumps engine.step() and
    resolves per-request futures (continuous batching across concurrent
    HTTP callers)."""

    def __init__(self, llm_config: LLMConfig):
        self.cfg = llm_config
        model_cfg = llm_config.resolve_model()
        mesh = _replica_mesh(llm_config)
        self.tokenizer = get_tokenizer(llm_config.tokenizer)
        engine_cfg = _wire_eos(llm_config.engine, self.tokenizer)
        self.engine = InferenceEngine(
            model_cfg, engine_cfg, mesh=mesh, seed=llm_config.seed,
            device=_replica_device(llm_config))
        self.model_cfg = model_cfg
        self._base_params = self.engine.params
        self._adapters: dict[str, object] = {}
        self._guide_cache: dict[str, object] = {}
        self._waiters: dict[int, tuple] = {}  # rid -> (loop, future)
        self._token_subs: dict[int, "queue.Queue"] = {}  # rid -> tokens
        self._sub_sent: dict[int, int] = {}  # rid -> tokens put so far
        # rids whose consumer is gone (early-stopped/abandoned streams):
        # the pump discards their finished records instead of stranding
        # them in engine.finished forever.
        self._discard: set[int] = set()
        self._lock = threading.Lock()
        self._stop = False
        self._pump = threading.Thread(target=self._loop, daemon=True,
                                      name="llm-engine-pump")
        self._pump.start()

    # ---- engine pump ----

    def _loop(self):
        while not self._stop:
            if not self.engine.has_work():
                time.sleep(0.002)
                continue
            try:
                emitted = self.engine.step()
            except Exception:  # noqa: BLE001 — a dead pump hangs every
                # pending AND future request on the replica; log and go on.
                import traceback
                traceback.print_exc()
                time.sleep(0.1)
                continue
            done = []
            with self._lock:
                # Per-token fanout to streaming subscribers, from the live
                # request: a step can emit two tokens of one request (the
                # admission's first and a decode step's), and `emitted`
                # holds one token a request.
                for rid in emitted or ():
                    sub = self._token_subs.get(rid)
                    req = self.engine.request(rid)
                    if sub is None or req is None:
                        continue
                    n = self._sub_sent.get(rid, 0)
                    for tok in req.generated[n:]:
                        sub.put(int(tok))
                    self._sub_sent[rid] = len(req.generated)
                for rid, (loop, fut) in list(self._waiters.items()):
                    req = self.engine.finished.pop(rid, None)
                    if req is not None:
                        done.append((loop, fut, req))
                        del self._waiters[rid]
                for rid in list(self._token_subs):
                    if rid in self.engine.finished:
                        self.engine.finished.pop(rid)
                        self._token_subs[rid].put(None)  # end of stream
                for rid in list(self._discard):
                    if rid in self.engine.finished:
                        self.engine.finished.pop(rid)
                        self._discard.discard(rid)
            for loop, fut, req in done:
                loop.call_soon_threadsafe(fut.set_result, req)

    async def _submit(self, prompt_ids, max_new_tokens, temperature,
                      top_p=1.0, top_k=0, guide=None, logprobs=False):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._lock:
            rid = self.engine.add_request(prompt_ids, max_new_tokens,
                                          temperature, top_p=top_p,
                                          top_k=top_k, guide=guide,
                                          logprobs=logprobs)
            self._waiters[rid] = (loop, fut)
        return await fut

    def _resolve_guide(self, guided_regex=None, guided_json=None):
        """Compile (and cache) a TokenGuide from the vLLM-style request
        fields. Compilation is per-pattern, not per-request — repeated
        schemas (the common case for structured extraction) hit the
        cache."""
        if guided_regex is None and guided_json is None:
            return None
        from ray_tpu_torch.llm.guided import (compile_token_guide,
                                              json_schema_to_regex)
        if guided_json is not None:
            pattern = json_schema_to_regex(guided_json)
        else:
            pattern = guided_regex
        g = self._guide_cache.get(pattern)
        if g is None:
            g = compile_token_guide(pattern, self.tokenizer,
                                    self.model_cfg.vocab,
                                    self.engine.e.eos_token)
            # Bounded LRU: patterns are user-supplied and each table is
            # [n_states, vocab] int32 — an unbounded cache is a
            # client-controllable memory leak in a long-lived replica.
            while len(self._guide_cache) >= 64:
                self._guide_cache.pop(next(iter(self._guide_cache)))
            self._guide_cache[pattern] = g
        else:
            # refresh recency (dict preserves insertion order)
            self._guide_cache.pop(pattern, None)
        self._guide_cache[pattern] = g
        return g

    # ---- model multiplexing (LoRA) ----

    @staticmethod
    def _kv_get(key):
        from ray_tpu_torch.core.runtime import Runtime, get_runtime
        rt = get_runtime()
        if isinstance(rt, Runtime):
            return rt.kv.get(key)
        return rt.request("kv_get", key)

    @staticmethod
    def _kv_put(key, value):
        from ray_tpu_torch.core.runtime import Runtime, get_runtime
        rt = get_runtime()
        if isinstance(rt, Runtime):
            rt.kv[key] = value
        else:
            rt.request("kv_put", (key, value))

    def load_adapter(self, model_id: str, lora_tree=None, alpha=None):
        """Register a LoRA adapter under `model_id`, cluster-wide: its
        factors are stored in the head KV as numpy arrays, so every
        replica can materialize it lazily (parity: the multiplex LoRA
        checkpoint store). None = a demo adapter drawn from a generator
        seeded by the id (tests); production passes trained factors
        (tensors or numpy arrays)."""
        cfg = self.cfg.lora
        if cfg is None:
            raise ValueError("llm_config.lora is not configured")
        if lora_tree is None:
            lora_tree = init_lora(self.model_cfg, cfg.rank,
                                  torch.Generator().manual_seed(
                                      adapter_seed(model_id)))
        lora_np = _numpy_tree(lora_tree)
        alpha = alpha or cfg.alpha
        self._kv_put(("llm_adapter", self.cfg.model_id, model_id),
                     pickle.dumps((lora_np, alpha), protocol=5))
        self._materialize(model_id, lora_np, alpha)
        return list(self._adapters)

    def _materialize(self, model_id: str, lora_tree, alpha):
        cfg = self.cfg.lora
        if len(self._adapters) >= cfg.max_adapters_per_replica:
            self._adapters.pop(next(iter(self._adapters)))
        # rank inferred from the tree itself: a trained adapter's rank wins
        # over the config default (wrong rank silently mis-scales).
        self._adapters[model_id] = merge_lora(self._base_params, lora_tree,
                                              alpha)

    def _params_for(self, model: str | None):
        if model is None or model == self.cfg.model_id:
            return self._base_params
        merged = self._adapters.get(model)
        if merged is None:
            # Lazy load-on-request from the cluster-wide registry: every
            # replica can serve every REGISTERED adapter; unknown ids fail
            # (a typo must not silently get a random adapter).
            blob = self._kv_get(("llm_adapter", self.cfg.model_id, model))
            if blob is None:
                raise ValueError(
                    f"model {model!r} is not a registered adapter of "
                    f"{self.cfg.model_id!r}")
            lora_tree, alpha = pickle.loads(blob)  # numpy arrays we stored
            self._materialize(model, lora_tree, alpha)
            merged = self._adapters[model]
        return merged

    # ---- request API (called via handle) ----

    @staticmethod
    def _apply_stop(text: str, stop) -> tuple[str, bool]:
        """Truncate at the earliest stop sequence (OpenAI `stop` param:
        str or up to 4 strings; the stop text itself is not returned)."""
        if not stop:
            return text, False
        seqs = [stop] if isinstance(stop, str) else list(stop)
        cut = min((i for i in (text.find(s) for s in seqs if s)
                   if i >= 0), default=-1)
        if cut < 0:
            return text, False
        return text[:cut], True

    async def completions(self, prompt: str, *, max_tokens=None,
                          temperature=None, top_p: float = 1.0,
                          top_k: int = 0, model=None, guided_regex=None,
                          guided_json=None, stop=None,
                          logprobs=None) -> dict:
        # Adapter swap: the engine's params are the weights of every later
        # step (the setter derives its decode weights again), so point the
        # engine at the requested tree. Mixed-adapter batches decode with
        # the most recent selection (documented simplification).
        self.engine.params = self._params_for(model)
        guide = self._resolve_guide(guided_regex, guided_json)
        ids = self.tokenizer.encode(prompt)
        req = await self._submit(ids, max_tokens, temperature,
                                 top_p=top_p, top_k=top_k, guide=guide,
                                 logprobs=bool(logprobs))
        text = self.tokenizer.decode(req.generated)
        text, stopped = self._apply_stop(text, stop)
        lp = None
        if logprobs:
            lp = _logprob_fields(self.tokenizer, text, stopped,
                                 req.generated, req.token_logprobs)
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "model": model or self.cfg.model_id,
            "choices": [{"index": 0, "text": text, "logprobs": lp,
                         "finish_reason": "stop" if stopped else
                         ("length" if len(req.generated)
                          >= (max_tokens
                              or self.engine.e.default_max_new_tokens)
                          else "stop")}],
            "usage": {"prompt_tokens": len(ids),
                      "completion_tokens": len(req.generated),
                      "total_tokens": len(ids) + len(req.generated)},
        }

    async def chat(self, messages: list, *, max_tokens=None,
                   temperature=None, top_p: float = 1.0, top_k: int = 0,
                   model=None, guided_regex=None, guided_json=None,
                   stop=None) -> dict:
        prompt = "".join(
            f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
            for m in messages) + "<|assistant|>"
        out = await self.completions(prompt, max_tokens=max_tokens,
                                     temperature=temperature, top_p=top_p,
                                     top_k=top_k, model=model,
                                     guided_regex=guided_regex,
                                     guided_json=guided_json, stop=stop)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "model": out["model"],
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": out["choices"][0]["text"]},
                         "finish_reason": "stop"}],
            "usage": out["usage"],
        }

    def completions_stream(self, prompt: str, max_tokens=None,
                           temperature=None, top_p: float = 1.0,
                           top_k: int = 0, model=None, stop=None,
                           logprobs=False):
        """Per-token stream: yields incremental text deltas as the engine
        decodes (sync generator — runs as a streaming actor method next to
        the replica's asyncio loop). `stop` truncates the stream at the
        earliest stop string (the stop text itself is never emitted).

        `logprobs`: each item is {"text": delta, "logprobs": {"tokens",
        "token_logprobs"}} instead, carrying the entries of the tokens the
        text sent so far covers (read from the live request,
        `engine.request`); the stream's entries together are the
        non-streaming `completions` logprobs block of the same text."""
        import queue as _queue

        self.engine.params = self._params_for(model)
        ids = self.tokenizer.encode(prompt)
        stops = ([stop] if isinstance(stop, str) else list(stop or []))
        hold = max((len(s) for s in stops), default=1) - 1
        sub: "_queue.Queue" = _queue.Queue()
        with self._lock:
            rid = self.engine.add_request(ids, max_tokens, temperature,
                                          top_p=top_p, top_k=top_k,
                                          logprobs=bool(logprobs))
            self._token_subs[rid] = sub
        # the pump appends a token's logprob before it puts the token
        req_obj = self.engine.request(rid) if logprobs else None
        ended = False  # engine finished the request (pump popped it)
        try:
            generated: list[int] = []
            sent = ""
            lp_sent = 0   # logprob entries streamed so far
            done = stopped = False
            while not done:
                tok = sub.get(timeout=300)
                if tok is None:
                    done = ended = True
                    text = self.tokenizer.decode(generated)
                else:
                    generated.append(tok)
                    # Incremental decode of the full sequence keeps
                    # multi-token merges correct; emit only the unseen
                    # suffix.
                    text = _hold_incomplete_utf8(
                        self.tokenizer.decode(generated))
                if stops:
                    cut = min((i for i in (text.find(s) for s in stops
                                           if s) if i >= 0), default=-1)
                    if cut >= 0:
                        text, done, stopped = text[:cut], True, True
                    elif not done:
                        # hold back a stop-length tail: a stop string can
                        # straddle the next token
                        text = text[:max(len(text) - hold, len(sent))] \
                            if hold else text
                delta = ""
                if len(text) > len(sent):
                    delta, sent = text[len(sent):], text
                if req_obj is None:
                    if delta:
                        yield delta
                    continue
                if done:
                    n = len(_logprob_fields(self.tokenizer, sent, stopped,
                                            generated, ())["tokens"])
                else:
                    n = _covered_tokens(self.tokenizer, sent, generated)
                if delta or n > lp_sent:
                    kept = generated[lp_sent:n]
                    yield {"text": delta, "logprobs": {
                        "tokens": [self.tokenizer.decode([t]) for t in kept],
                        "token_logprobs": [float(x) for x in
                                           req_obj.token_logprobs[lp_sent:n]]}}
                    lp_sent = n
        finally:
            with self._lock:
                self._token_subs.pop(rid, None)
                self._sub_sent.pop(rid, None)
                if ended:
                    pass  # pump already popped the finished record
                elif rid in self.engine.finished:
                    self.engine.finished.pop(rid, None)
                else:
                    # Still decoding (early stop / abandoned stream):
                    # cancel so the slot frees instead of burning to
                    # max_new_tokens, and have the pump discard the
                    # finished record when it lands.
                    self.engine.cancel(rid)
                    self._discard.add(rid)

    def model_ids(self) -> list:
        return [self.cfg.model_id, *self._adapters]

    def __del__(self):
        self._stop = True


def _covered_tokens(tokenizer, text: str, generated) -> int:
    """How many leading tokens of `generated` a stream's text so far
    covers whole, by the per-token text lengths `_logprob_fields` aligns
    with, and never more than it keeps for a text cut there."""
    n = decoded = 0
    for t in generated:
        if n and decoded >= len(text):
            break
        decoded += len(tokenizer.decode([t]))
        if decoded > len(text):
            break
        n += 1
    return n


def _logprob_fields(tokenizer, text: str, stopped: bool, generated,
                    token_logprobs) -> dict:
    """The OpenAI `logprobs` response block, aligned with the (possibly
    stop-truncated) text."""
    kept = list(generated)
    if stopped:
        # Align the logprob arrays with the TRUNCATED text by
        # accumulating per-token text lengths — one decode per token
        # (O(n)) instead of re-decoding the growing prefix per kept
        # token (O(n²)), and consistent with the per-token `tokens`
        # strings reported below.
        kept = []
        decoded_len = 0
        for t in generated:
            kept.append(t)
            decoded_len += len(tokenizer.decode([t]))
            if decoded_len >= len(text):
                break
    return {"tokens": [tokenizer.decode([t]) for t in kept],
            "token_logprobs": list(token_logprobs[:len(kept)])}


def _hold_incomplete_utf8(text: str) -> str:
    """UTF-8 boundary holdback for streaming text deltas: a multi-byte
    character whose bytes straddle a token/chunk edge decodes to U+FFFD
    until its continuation bytes arrive — emitting it would bake the
    replacement char into the client's stream. Hold the trailing
    replacement run back until the next delta completes it; the FINAL
    decode (stream end) bypasses this, so genuinely invalid bytes still
    surface as U+FFFD."""
    if text.endswith("�"):
        return text.rstrip("�")
    return text


def _is_overload(e: Exception) -> bool:
    """OverloadedError, possibly wrapped in the remote TaskError chain."""
    if isinstance(e, OverloadedError):
        return True
    cause = getattr(e, "cause", None)
    if isinstance(cause, OverloadedError):
        return True
    return "OverloadedError" in str(e) or "overloaded" in str(e)


def _guided_fields(body: dict):
    """vLLM-style guided_regex/guided_json fields, plus the OpenAI
    response_format json_schema spelling."""
    guided_regex = body.get("guided_regex")
    guided_json = body.get("guided_json")
    rf = body.get("response_format")
    if guided_json is None and isinstance(rf, dict):
        if rf.get("type") == "json_schema":
            guided_json = rf.get("json_schema", {}).get("schema", {})
        elif rf.get("type") == "json_object":
            # a free-form JSON OBJECT (flat: scalar values — see
            # json_schema_to_regex's depth-1 approximation)
            guided_json = {"type": "object"}
    return guided_regex, guided_json


class _OpenAiRouterImpl:
    """OpenAI-surface ingress: /v1/models, /v1/completions,
    /v1/chat/completions — stream=true serves SSE deltas
    (parity: deployments/routers/router.py; the OpenAI surface is
    stream-first in practice)."""

    def __init__(self, server_handle):
        self.server = server_handle

    def __stream__(self, request):
        """SSE for {"stream": true} requests: one OpenAI chunk per text
        delta, then data: [DONE]. The proxy routes stream-requesting
        requests here; everything else goes through __call__. A
        completions request with "logprobs" carries each chunk's entries
        in its choice's "logprobs"."""
        import json
        path = request.path
        try:
            body = json.loads(request.body or b"{}")
        except json.JSONDecodeError:
            yield 'data: {"error": "invalid JSON body"}\n\n'
            return
        chat = path == "/v1/chat/completions"
        if chat:
            prompt = "".join(
                f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
                for m in body.get("messages", [])) + "<|assistant|>"
        else:
            prompt = body.get("prompt", "")
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        model = body.get("model")
        deltas = self.server.completions_stream.remote_streaming(
            prompt, body.get("max_tokens"), body.get("temperature"),
            body.get("top_p", 1.0), body.get("top_k", 0), model,
            body.get("stop"), bool(body.get("logprobs")) and not chat)
        obj = "chat.completion.chunk" if chat else "text_completion"
        for delta in deltas:
            if chat:
                choice = {"index": 0, "delta": {"content": delta},
                          "finish_reason": None}
            elif isinstance(delta, dict):
                choice = {"index": 0, "text": delta["text"],
                          "logprobs": delta["logprobs"],
                          "finish_reason": None}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": None}
            yield "data: " + json.dumps(
                {"id": rid, "object": obj, "model": model,
                 "choices": [choice]}) + "\n\n"
        yield "data: [DONE]\n\n"

    async def __call__(self, request):
        import json
        path = request.path
        if path == "/v1/models":
            ids = await self.server.model_ids.remote()
            return {"object": "list",
                    "data": [{"id": i, "object": "model"} for i in ids]}
        if request.method != "POST":
            return 405, {"error": "method not allowed"}
        try:
            body = json.loads(request.body or b"{}")
        except json.JSONDecodeError:
            return 400, {"error": "invalid JSON body"}
        try:
            guided_regex, guided_json = _guided_fields(body)
            if path == "/v1/completions":
                return await self.server.completions.remote(
                    body.get("prompt", ""),
                    max_tokens=body.get("max_tokens"),
                    temperature=body.get("temperature"),
                    top_p=body.get("top_p", 1.0),
                    top_k=body.get("top_k", 0),
                    model=body.get("model"),
                    guided_regex=guided_regex, guided_json=guided_json,
                    stop=body.get("stop"),
                    logprobs=body.get("logprobs"))
            if path == "/v1/chat/completions":
                return await self.server.chat.remote(
                    body.get("messages", []),
                    max_tokens=body.get("max_tokens"),
                    temperature=body.get("temperature"),
                    top_p=body.get("top_p", 1.0),
                    top_k=body.get("top_k", 0),
                    model=body.get("model"),
                    guided_regex=guided_regex, guided_json=guided_json,
                    stop=body.get("stop"))
        except Exception as e:  # noqa: BLE001 — surface as API error
            if _is_overload(e):
                # Admission shed: the OpenAI rate-limit status, so clients
                # back off instead of retrying hot.
                return 429, {"error": str(e)}
            return 400, {"error": str(e)}
        return 404, {"error": f"no route {path}"}


def build_llm_deployment(llm_config: LLMConfig):
    """The engine deployment: `num_replicas` replicas, each reserving
    `num_gpus_per_replica` of the "GPU" resource."""
    d = serve.deployment(
        _LLMServerImpl, name=f"LLMServer:{llm_config.model_id}")
    return d.options(
        num_replicas=llm_config.num_replicas,
        ray_actor_options={"num_gpus": llm_config.num_gpus_per_replica},
    ).bind(llm_config)


def build_openai_app(llm_config: LLMConfig):
    """Parity: reference `build_openai_app` — OpenAI router in front of an
    engine deployment; `serve.run(app)` serves it over HTTP."""
    server = build_llm_deployment(llm_config)
    router = serve.deployment(_OpenAiRouterImpl, name="OpenAiRouter")
    return router.bind(server)


def build_disagg_deployment(llm_config: LLMConfig, disagg=None):
    """The disaggregated prefill/decode plane: not ported yet."""
    raise NotImplementedError(f"the disaggregated serving plane is {_LATER}")


def build_disagg_openai_app(llm_config: LLMConfig, disagg=None):
    """The OpenAI app over the disaggregated plane: not ported yet."""
    raise NotImplementedError(f"the disaggregated serving plane is {_LATER}")
