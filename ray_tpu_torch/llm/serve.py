"""LLM serving: the engine-backed deployment, the OpenAI-compatible
router in front of it and the disaggregated prefill/decode plane
(counterpart of `ray_tpu/llm/serve.py`).

Parity: reference `python/ray/llm/_internal/serve/` — `LLMServer`
deployment wrapping the engine (`deployments/llm/`), OpenAI-compatible
ingress (`deployments/routers/router.py`, /v1/chat/completions etc.), LoRA
multiplexing (`deployments/llm/multiplex/`). The engine is the port's
in-process continuous-batching engine (`llm/engine.py`) on the card the
replica reserved (`LLMConfig.num_gpus_per_replica`), its decode attention
the hand-written paged-decode kernel.

The disaggregated plane (`build_disagg_deployment`,
`build_disagg_openai_app`) runs prefill and decode as separate replica
pools: a prefill worker exports the prompt's full-page KV sealed as one
store object, a decode replica splices it into its paged pool
(`import_kv`) and streams the tokens after the ones the client holds;
the coordinator admits or sheds by per-pool token budgets, routes by
prompt prefix and re-resolves a stream whose decode replica died.

A replica with tensor_parallelism = tp > 1, in either deployment and in
both pools, is a gang of tp processes in lockstep (`llm/_tp_gang.py`):
the port's tp engine is SPMD, where the reference's tp replica is one
process over tp chips. Rank 0 is the replica actor. Every mutation of
its engine (a request with its handoff or resume token, a cancel, an
adapter swap by model id, a guide by pattern) joins an ordered log that
rank 0's pump sends to the other ranks once a turn; every rank applies
it in order and steps, so their schedules never part. A prefill export
runs on every rank alike, and the ranks' kv heads are gathered to the
full width before the handoff is sealed; a decode rank imports its own
heads of it.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import os
import pickle
import sys
import threading
import time
import traceback
import uuid

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.retry import Backoff
from ray_tpu_torch.core.status import (ActorDiedError, GetTimeoutError,
                                       OverloadedError, RayTpuError)
from ray_tpu_torch.llm import _tp_gang
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import (InferenceEngine, PrefillEngine,
                                      _prompt_bucket)
from ray_tpu_torch.llm.lora import (adapter_seed, add_deltas, init_lora,
                                    lora_deltas)
from ray_tpu_torch.llm.tokenizer import get_tokenizer


def _replica_options(llm_config: LLMConfig) -> dict:
    """Deployment options placing one replica: its GPU reservation, and
    at tp > 1 a placement group of one bundle a rank (the controller
    packs it on one node), rank 0 (the replica actor) in bundle 0 with
    its share of the GPUs."""
    tp = llm_config.tensor_parallelism
    if tp <= 1:
        return {"ray_actor_options": {
            "num_gpus": llm_config.num_gpus_per_replica}}
    return {"ray_actor_options": {"num_cpus": 1,
                                  "num_gpus": _tp_gang.rank_share(llm_config)},
            "placement_group_bundles": _tp_gang.rank_bundles(llm_config)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class _LLMServerImpl:
    """One engine per replica; a background thread pumps engine.step() and
    resolves per-request futures (continuous batching across concurrent
    HTTP callers). Request threads never touch the engine: they put its
    mutations in `_log`, and the pump applies the log before each step,
    at tp > 1 on every rank of the gang alike (module docstring)."""

    _gang = None   # this replica's tp gang (llm/_tp_gang.py); None at tp 1

    def __init__(self, llm_config: LLMConfig):
        self.cfg = llm_config
        model_cfg = llm_config.resolve_model()
        # at tp > 1 the gang's mesh is the reference's _replica_mesh
        self._gang = _tp_gang.join(llm_config, type(self))
        self.tokenizer = get_tokenizer(llm_config.tokenizer)
        engine_cfg = llm_config.engine_config(self.tokenizer)
        self.engine = InferenceEngine(
            model_cfg, engine_cfg, mesh=self._gang and self._gang.mesh,
            seed=llm_config.seed, device=llm_config.replica_device())
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
        # The pump's next turn: (kind, *args) engine mutations, in order.
        self._log: list[tuple] = []
        # rank 0: handoffs its request threads opened, by rid, and the
        # live Requests of its streams (the engine's map is weak)
        self._opened: dict[int, tuple] = {}
        self._live: dict[int, object] = {}
        self._lock = threading.Lock()
        self._stop = False
        if self._leader:
            self._pump = threading.Thread(target=self._loop, daemon=True,
                                          name="llm-engine-pump")
            self._pump.start()

    # ---- engine pump ----

    @property
    def _leader(self) -> bool:
        """Rank 0, the one that answers (every replica at tp = 1)."""
        return self._gang is None or self._gang.leader

    def _loop(self):
        while not self._stop:
            try:
                emitted = self._pump_turn()
            except Exception as e:  # noqa: BLE001
                if self._gang is not None:
                    # a rank failed: the gang never goes on with fewer
                    self._fail_all(self._gang.fail(e))
                    return
                # one engine: a dead pump hangs every pending AND future
                # request on the replica; log and go on.
                traceback.print_exc()
                time.sleep(0.1)
                continue
            if emitted is None:
                time.sleep(0.002)
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
                        # end of stream: the subscription goes with the
                        # record, so a consumer that stops before it
                        # reads the end cancels nothing (F19)
                        self.engine.finished.pop(rid)
                        self._token_subs.pop(rid).put(None)
                for rid in list(self._discard):
                    if rid in self.engine.finished:
                        self.engine.finished.pop(rid)
                        self._discard.discard(rid)
            for loop, fut, req in done:
                loop.call_soon_threadsafe(fut.set_result, req)

    def _pump_turn(self):
        """Rank 0's turn: take the log, send it to the other ranks of a
        gang, apply it and step; step's emitted tokens, or None when
        there was nothing to do (the heartbeat keeps an idle gang in
        touch)."""
        with self._lock:
            entries, self._log = self._log, []
        if not entries and not self.engine.has_work():
            return None
        if self._gang is None:
            return self._turn(entries)
        with self._gang.lock:
            self._gang.send("turn", entries)
            return self._turn(entries)

    def _turn(self, entries) -> dict:
        """Every rank: apply a turn's log in order, then step."""
        for kind, *args in entries:
            getattr(self, "_do_" + kind)(*args)
        return self.engine.step() if self.engine.has_work() else {}

    def _follow(self, kind: str, payload):
        """A follower rank: rank 0's message."""
        if kind == "turn":
            self._turn(payload)
            self.engine.finished.clear()   # rank 0 answers; nothing waits
        else:
            self._gang_method(*payload)

    def _do_add(self, rid: int, prompt, max_new, temperature, top_p,
                top_k, pattern, logprobs, resume_token, kv):
        handoff = self._opened.pop(rid, None)
        if handoff is None and kv is not None:
            handoff = _open_kv(kv if isinstance(kv, tuple)
                               else ray_tpu_torch.get(kv, timeout=30))
        if handoff is not None:
            handoff = self._rank_heads(handoff)
        got = self.engine.add_request(
            prompt, max_new, temperature, top_p=top_p, top_k=top_k,
            guide=self._guide_for(pattern), logprobs=logprobs,
            resume_token=resume_token, kv_handoff=handoff,
            request_id=rid if self._leader else None)
        if got != rid:
            raise _tp_gang.GangBroken(
                f"tp gang rank {self._gang.rank} numbered a request {got}, "
                f"rank 0 {rid}")
        if rid in self._token_subs:
            self._live[rid] = self.engine.request(rid)

    def _do_cancel(self, rid: int):
        self.engine.cancel(rid)

    def _do_params(self, model):
        self.engine.params = self._params_for(model)

    def _do_load(self, model_id: str, lora_np, alpha):
        if not self._leader:   # rank 0 merged it in load_adapter
            self._materialize(model_id, lora_np, alpha)

    def _rank_heads(self, handoff) -> tuple:
        """This rank's kv heads of a full-width (ks, vs) handoff."""
        c = self.engine.c
        if getattr(c, "tp", 1) == 1:
            return handoff
        lo = c.tp_rank * c.n_kv_heads
        return tuple(t[:, :, lo:lo + c.n_kv_heads].contiguous()
                     for t in handoff)

    def _fail_all(self, exc: BaseException):
        """A broken gang: every waiter and stream gets `exc`."""
        with self._lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
            for sub in self._token_subs.values():
                sub.put(exc)
        for loop, fut in waiters:
            loop.call_soon_threadsafe(fut.set_exception, exc)

    def _enqueue(self, prompt, max_new, temperature, *, top_p=1.0,
                 top_k=0, guide=None, logprobs=False, resume_token=None,
                 handoff=None, kv=None) -> int:
        """Submit a request; the caller holds `_lock` and registers its
        waiter or stream under the returned rid before releasing it. Rank
        0's engine checks and numbers it now, and the log carries it
        (`guide` by pattern, the handoff by `kv`, the sealed object or
        its ref) to every rank's engine at the next turn."""
        if self._gang is not None and self._gang.error is not None:
            raise self._gang.error
        self.engine.check_request(prompt, self._guide_for(guide), logprobs,
                                  resume_token, handoff)
        rid = self.engine.reserve_request_id()
        if handoff is not None:
            self._opened[rid] = handoff
        self._log.append(("add", rid, list(map(int, prompt)), max_new,
                          temperature, float(top_p), int(top_k), guide,
                          bool(logprobs), resume_token,
                          kv if handoff is not None else None))
        return rid

    def _cancel(self, rid: int):
        """Cancel a request at the next turn (the caller holds `_lock`)."""
        self._log.append(("cancel", rid))

    def _select(self, model):
        """Point the engine at `model`'s weights (the base or an adapter)
        from the next turn on, on every rank (a model id that is no
        registered adapter raises here)."""
        self._params_for(model)
        with self._lock:
            self._log.append(("params", model))

    def _next_token(self, sub):
        """A stream's next item: a token, None at its end. A broken gang
        raises its error."""
        tok = sub.get(timeout=300)
        if isinstance(tok, BaseException):
            raise tok
        return tok

    async def _submit(self, prompt_ids, max_new_tokens, temperature,
                      top_p=1.0, top_k=0, guide=None, logprobs=False):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._lock:
            rid = self._enqueue(prompt_ids, max_new_tokens, temperature,
                                top_p=top_p, top_k=top_k, guide=guide,
                                logprobs=logprobs)
            self._waiters[rid] = (loop, fut)
        return await fut

    @staticmethod
    def _guide_pattern(guided_regex=None, guided_json=None):
        """The regex of the vLLM-style request fields (None: unguided)."""
        if guided_json is not None:
            from ray_tpu_torch.llm.guided import json_schema_to_regex
            return json_schema_to_regex(guided_json)
        return guided_regex

    def _guide_for(self, pattern):
        """Compile (and cache) the TokenGuide of a pattern (None: none).
        Compilation is per-pattern, not per-request — repeated schemas
        (the common case for structured extraction) hit the cache; every
        rank of a gang compiles its own from the pattern the log
        carries."""
        if pattern is None:
            return None
        from ray_tpu_torch.llm.guided import compile_token_guide
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

    # ---- the gang's health and its ranks ----

    def check_health(self):
        """The serve controller's probe: a broken gang fails it, and the
        controller replaces the whole replica."""
        if self._gang is not None:
            self._gang.check()

    def gang_call(self, method: str, *args) -> list:
        """`method(*args)` on every rank of the replica, between two
        engine steps; the results by rank (one at tp = 1)."""
        if self._gang is None:
            return [getattr(self, method)(*args)]
        with self._gang.lock:
            self._gang.send("call", (method, args))
            return self._gang_method(method, args)

    def _gang_method(self, method: str, args) -> list:
        return self._gang.all_gather_object(getattr(self, method)(*args))

    def gang_state(self) -> dict:
        """This rank's engine state that lockstep keeps equal on every
        rank: rids numbered, those queued and decoding, pages in use and
        decode steps (every other rid numbered has finished)."""
        e = self.engine
        return dict(pid=os.getpid(), next_rid=e._next_id,
                    queued=[r.request_id for r in e.queue],
                    decoding=[r.request_id for r in e.slot_req if r],
                    pages_in_use=e.kv_stats().get("pages_in_use"),
                    decode_steps=e.decode_steps)

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
        (tensors or numpy arrays). In a gang the log carries the factors
        to every rank."""
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
        with self._lock:
            self._log.append(("load", model_id, lora_np, alpha))
        return list(self._adapters)

    def _materialize(self, model_id: str, lora_tree, alpha):
        cfg = self.cfg.lora
        if len(self._adapters) >= cfg.max_adapters_per_replica:
            self._adapters.pop(next(iter(self._adapters)))
        # rank inferred from the tree itself: a trained adapter's rank wins
        # over the config default (wrong rank silently mis-scales). The
        # engine cuts the full deltas as it cut its params (its rank's
        # blocks under a tp mesh).
        deltas = self.engine.local_blocks(
            lora_deltas(lora_tree, alpha, device=self.engine.device))
        self._adapters[model_id] = add_deltas(self._base_params, deltas)

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
        self._select(model)
        guide = self._guide_pattern(guided_regex, guided_json)
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
        text sent so far covers (read from the live request, `_live`,
        once the pump has applied the add); the stream's entries
        together are the non-streaming `completions` logprobs block of
        the same text."""
        import queue as _queue

        self._select(model)
        ids = self.tokenizer.encode(prompt)
        stops = ([stop] if isinstance(stop, str) else list(stop or []))
        hold = max((len(s) for s in stops), default=1) - 1
        sub: "_queue.Queue" = _queue.Queue()
        with self._lock:
            rid = self._enqueue(ids, max_tokens, temperature, top_p=top_p,
                                top_k=top_k, logprobs=bool(logprobs))
            self._token_subs[rid] = sub
        # the pump appends a token's logprob before it puts the token
        req_obj = self._live.get(rid) if logprobs else None
        ended = False  # engine finished the request (pump popped it)
        try:
            generated: list[int] = []
            sent = ""
            lp_sent = 0   # logprob entries streamed so far
            done = stopped = False
            while not done:
                tok = self._next_token(sub)
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
                if not logprobs:
                    if delta:
                        yield delta
                    continue
                if req_obj is None:
                    req_obj = self._live.get(rid)
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
            self._end_stream(rid, ended)

    def _end_stream(self, rid: int, ended: bool):
        """A stream's consumer is done: drop its subscription and, when
        the engine has not finished the request (an early stop or an
        abandoned stream), cancel it so the slot frees instead of burning
        to max_new_tokens, and have the pump discard the finished record
        when it lands."""
        with self._lock:
            # no subscription left: the pump ended the stream (F19)
            ended = self._token_subs.pop(rid, None) is None or ended
            self._sub_sent.pop(rid, None)
            self._live.pop(rid, None)
            if ended:
                pass  # pump already popped the finished record
            elif rid in self.engine.finished:
                self.engine.finished.pop(rid, None)
            else:
                self._cancel(rid)
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
    `num_gpus_per_replica` of the "GPU" resource (at tp > 1 a gang of tp
    ranks, each reserving a tp-th of it: `_replica_options`)."""
    llm_config.check()
    d = serve.deployment(
        _LLMServerImpl, name=f"LLMServer:{llm_config.model_id}")
    return d.options(num_replicas=llm_config.num_replicas,
                     **_replica_options(llm_config)).bind(llm_config)


def build_openai_app(llm_config: LLMConfig):
    """Parity: reference `build_openai_app` — OpenAI router in front of an
    engine deployment; `serve.run(app)` serves it over HTTP."""
    server = build_llm_deployment(llm_config)
    router = serve.deployment(_OpenAiRouterImpl, name="OpenAiRouter")
    return router.bind(server)




# ================= disaggregated prefill/decode plane =================


_shed_metric = None


def _record_shed(pool: str) -> None:
    """Bump `ray_tpu_serve_shed_total{pool=...}` — rendered at /metrics
    by the local registry (driver-side serving) or shipped to the head
    on the worker metric-delta frames (replica processes). Lazy: the
    metric registers on the first shed so importing this module never
    touches the registry."""
    global _shed_metric
    if _shed_metric is None:
        from ray_tpu_torch.util.metrics import Counter as _MetricCounter
        _shed_metric = _MetricCounter(
            "ray_tpu_serve_shed_total",
            "requests shed by serving-plane admission control, by the "
            "pool whose budget tripped (requests|prefill|decode|slo)",
            tag_keys=("pool",))
    _shed_metric.inc(tags={"pool": pool})


@dataclasses.dataclass
class DisaggConfig:
    """Knobs for the disaggregated serving plane (module docstring).

    Admission control is per-pool token-budget backpressure: a request
    costs `prompt_tokens` against the prefill queue until its KV is
    exported, and `prompt_tokens + max_new_tokens` against the decode
    pool until its stream completes. Overflow — either budget, the
    request cap, or the estimated queue wait against `admission_slo_ms` —
    sheds immediately with OverloadedError instead of queueing."""

    prefill_replicas: int = 1
    decode_replicas: int = 2
    # --- admission control (the overload contract) ---
    max_prefill_queue_tokens: int = 8192
    # PER LIVE DECODE REPLICA: the coordinator multiplies this budget by
    # the decode pool's live replica count (refreshed on dispatch and on
    # shed reports), so an autoscaled pool admits proportionally more.
    max_decode_inflight_tokens: int = 16384
    max_ongoing_requests: int = 256
    admission_slo_ms: float | None = None  # est decode wait SLO; None=off
    # --- autoscaling (scale decode on shed rate) ---
    # AutoscalingConfig kwargs for the DecodePool deployment (e.g.
    # dict(min_replicas=1, max_replicas=4, upscale_shed_rate=1.0)):
    # the coordinator attributes decode/slo admission sheds to the pool
    # (record_shed_metrics), and the controller adds a replica when the
    # sustained shed rate crosses upscale_shed_rate. None = fixed
    # decode_replicas.
    decode_autoscale: dict | None = None
    # --- routing / handoff ---
    handoff: bool = True          # False: decode pool always re-prefills
    route_cache_prefixes: int = 4096  # prefix keys remembered per replica
    stream_chunk_tokens: int = 8  # decode stream: max tokens per chunk
    # --- recovery pacing (core/retry.Backoff deadlines) ---
    dispatch_deadline_s: float = 15.0  # route+prefill redrive budget
    resume_deadline_s: float = 60.0    # mid-stream death re-resolve budget


def _seal_kv(ks, vs) -> tuple:
    """A prefill export as host arrays: (dtype name, K, V), bfloat16
    carried as its uint16 bits (numpy has no bfloat16 of its own), so the
    store's pickle-5 path moves the arrays without a copy and no process
    needs a numpy bfloat16 dtype to read them."""
    def bits(t):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return (str(ks.dtype).removeprefix("torch."), bits(ks), bits(vs))


def _open_kv(sealed) -> tuple:
    """`_seal_kv`'s (dtype name, K, V) -> (K, V) CPU tensors of that
    dtype, bit for bit, as `import_kv` takes them."""
    name, k, v = sealed

    def tensor(a):
        # store reads may be read-only views of the arena: copy those
        t = torch.from_numpy(np.require(a, requirements="W"))
        if name == "bfloat16":
            return t.view(torch.int16).view(torch.bfloat16)
        return t
    return tensor(k), tensor(v)


class _PrefillWorkerImpl:
    """One prefill-pool worker: prompt -> (first token, sealed KV handoff).

    The KV export (full prompt pages, post-RoPE) is sealed as ONE store
    object via `ray_tpu_torch.put` (numpy arrays, `_seal_kv`) and only the
    small ObjectRef travels through the coordinator. Outside a runtime
    (serve local testing mode) the arrays ride inline instead. At tp > 1
    every rank of the gang exports alike and the ranks' kv heads are
    gathered, in rank order, to the full [L, S, hkv, hd] before rank 0
    seals them: the handoff is the same at every tp."""

    _gang = None   # this worker's tp gang (llm/_tp_gang.py); None at tp 1

    def __init__(self, llm_config: LLMConfig):
        self.cfg = llm_config
        model_cfg = llm_config.resolve_model()
        self._gang = _tp_gang.join(llm_config, type(self))
        self.tokenizer = get_tokenizer(llm_config.tokenizer)
        engine_cfg = llm_config.engine_config(self.tokenizer)
        self.engine = PrefillEngine(model_cfg, engine_cfg,
                                    mesh=self._gang and self._gang.mesh,
                                    seed=llm_config.seed,
                                    device=llm_config.replica_device())

    def prefill(self, prompt_ids, temperature=None, top_p: float = 1.0,
                top_k: int = 0, want_logp: bool = False) -> dict:
        chaos.delay("serve.prefill.stall", max_s=0.25)
        args = (list(map(int, prompt_ids)), temperature, float(top_p),
                int(top_k), bool(want_logp))
        if self._gang is None:
            out = self._export(*args)
        else:
            # refused here, before any rank starts: a follower that raises
            # breaks the gang
            _prompt_bucket(self.engine.e, len(args[0]))
            with self._gang.lock:
                self._gang.send("prefill", args)
                try:
                    out = self._export(*args)
                except Exception as e:
                    raise self._gang.fail(e) from e
        first, ks, vs = out[:3]
        kv = None
        if ks.shape[1]:
            kv = _seal_kv(ks, vs)
            if ray_tpu_torch.is_initialized():
                kv = ray_tpu_torch.put(kv)  # sealed store object
        return {"first": int(first), "kv": kv,
                "kv_tokens": int(ks.shape[1]),
                "first_logp": out[3] if want_logp else None}

    def _export(self, prompt_ids, temperature, top_p, top_k, want_logp):
        """Every rank: `prefill_export`, in a gang with the ranks' kv
        heads gathered to the full width (each rank's first token must be
        rank 0's)."""
        out = self.engine.prefill_export(
            prompt_ids, temperature=temperature, top_p=top_p, top_k=top_k,
            want_logp=want_logp)
        if self._gang is None:
            return out
        firsts = self._gang.all_gather_object(int(out[0]))
        if len(set(firsts)) != 1:
            raise _tp_gang.GangBroken(f"the ranks sampled {firsts}")
        return (out[0], self._gang.gather_heads(out[1]),
                self._gang.gather_heads(out[2]), *out[3:])

    def _follow(self, kind: str, payload):
        """A follower rank: rank 0's message."""
        if kind == "prefill":
            self._export(*payload)
        else:
            self._gang_method(*payload)

    def gang_state(self) -> dict:
        return dict(pid=os.getpid())

    check_health = _LLMServerImpl.check_health
    gang_call = _LLMServerImpl.gang_call
    _gang_method = _LLMServerImpl._gang_method


class _DecodeReplicaImpl(_LLMServerImpl):
    """Decode-pool replica: imports KV handoffs into the engine's prefix
    cache and serves resumable token streams under continuous batching."""

    def _fetch_handoff(self, kv, prompt_ids):
        """Resolve the handoff to (ks, vs) CPU tensors, or None — the
        caller re-prefills. Loss (injected via serve.kv_handoff.lose or
        real: the owning prefill worker died and took the object with it)
        degrades to a re-prefill, never a failed stream."""
        if kv is None:
            return None
        if chaos.site("serve.kv_handoff.lose"):
            return None  # injected in-flight loss
        if not isinstance(kv, tuple):
            try:
                kv = ray_tpu_torch.get(kv, timeout=30)
            except RayTpuError as e:
                print(f"serve: KV handoff lost ({e}); re-prefilling "
                      f"{len(prompt_ids)}-token prompt", file=sys.stderr)
                return None
        return _open_kv(kv)

    def configure_chaos(self, schedule: str, seed: int = 0) -> int:
        """Arm chaos in THIS replica process only and return its pid
        (test/bench hook: a cluster-wide serve.decode.kill schedule would
        re-arm every controller-respawned replica and crash-loop the pool
        at low Nth counts)."""
        import os
        chaos.configure(schedule, seed)
        return os.getpid()

    def decode_stream(self, prompt_ids, generated, kv=None,
                      max_tokens=None, temperature=None,
                      top_p: float = 1.0, top_k: int = 0,
                      chunk_tokens: int = 8, want_logp: bool = False):
        """Continue a request whose prompt was prefilled elsewhere.

        `generated` = tokens the client already holds (>=1: the prefill's
        first token; more when resuming a stream whose previous replica
        died). Yields lists of NEW token ids — exactly the positions
        after `generated`, each exactly once — or, with `want_logp`,
        lists of (token, logprob) pairs: a resumed request appends one
        token_logprobs entry per NEWLY decoded position (the resume
        token itself is never re-sampled), so the k-th streamed token
        pairs with token_logprobs[k]. The prompt KV comes from the
        handoff (import_kv prefix splice) or, when the handoff is lost,
        a full re-prefill; tokens in `generated` beyond the prompt
        re-prefill as suffix either way."""
        import queue as _queue
        e = self.engine.e
        max_new = max_tokens or e.default_max_new_tokens
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("decode_stream needs >=1 seed token (the "
                             "prefill's first sample)")
        rem = max_new - len(generated)
        if rem <= 0 or generated[-1] == e.eos_token:
            return
        handoff = self._fetch_handoff(kv, prompt_ids)
        sub: "_queue.Queue" = _queue.Queue()
        with self._lock:
            # in a gang every rank fetches the handoff by `kv` and imports
            # its own kv heads of it
            rid = self._enqueue(
                list(prompt_ids) + generated[:-1], rem + 1, temperature,
                top_p=top_p, top_k=top_k, resume_token=generated[-1],
                handoff=handoff, kv=kv, logprobs=want_logp)
            # The pump forwards req.generated from this cursor, and
            # add_request put the resume token there, which the client
            # holds already: the stream starts after it. (A constant, not
            # len(req.generated): the pump may step this request before
            # the lock is released, and its fanout waits for the lock.)
            self._sub_sent[rid] = 1
            self._token_subs[rid] = sub
        del handoff
        req_obj = self._live.get(rid) if want_logp else None
        ended = False
        # cursor into req_obj.token_logprobs (append-only; the engine
        # appends the k-th entry before the pump puts the k-th token): a
        # resumed request has none for the resume token
        lp_i = 0

        def _pair(tok):
            nonlocal lp_i, req_obj
            if not want_logp:
                return tok
            if req_obj is None:
                req_obj = self._live.get(rid)
            lp = (float(req_obj.token_logprobs[lp_i])
                  if lp_i < len(req_obj.token_logprobs) else None)
            lp_i += 1
            return (tok, lp)

        try:
            while True:
                tok = self._next_token(sub)
                if tok is None:
                    ended = True
                    return
                chunk = [_pair(tok)]
                while len(chunk) < max(chunk_tokens, 1):
                    try:
                        nxt = sub.get_nowait()
                    except _queue.Empty:
                        break
                    if isinstance(nxt, BaseException):
                        raise nxt
                    if nxt is None:
                        ended = True
                        break
                    chunk.append(_pair(nxt))
                # The mid-stream crash probe: one hit per emitted chunk,
                # fired BEFORE the yield so the dying replica takes the
                # chunk with it — the consumer must re-resolve from its
                # last DELIVERED position, not ours.
                chaos.kill("serve.decode.kill")
                yield chunk
                if ended:
                    return
        finally:
            self._end_stream(rid, ended)

    def kv_stats(self) -> dict:
        return self.engine.kv_stats()


class _DisaggServerImpl:
    """The disaggregated serving coordinator: SLO-aware admission,
    prefix-aware decode routing, prefill->decode KV handoff, and
    exactly-once stream recovery across decode replica death. Exposes the
    same request surface as _LLMServerImpl (completions / chat /
    completions_stream / model_ids) so the OpenAI ingress composes with
    either backend unchanged. It holds no engine and reserves no GPU."""

    def __init__(self, llm_config: LLMConfig, disagg: DisaggConfig | None,
                 prefill_handle, decode_handle):
        import concurrent.futures
        self.cfg = llm_config
        self.d = disagg or DisaggConfig()
        self.tokenizer = get_tokenizer(llm_config.tokenizer)
        engine_cfg = llm_config.engine_config(self.tokenizer)
        self._page = engine_cfg.page_size
        self._eos = engine_cfg.eos_token
        self._max_new_default = engine_cfg.default_max_new_tokens
        self.prefill = prefill_handle
        self.decode = decode_handle
        # Local-testing mode: the "pools" are single in-process instances.
        self._local_decode = getattr(decode_handle, "_target", None)
        self._lock = threading.Lock()
        # ---- admission accounting (token budgets per pool) ----
        self._prefill_queue_tokens = 0
        self._decode_inflight_tokens = 0
        self._ongoing = 0
        self._tok_rate_ema = 0.0  # decode tokens/s across the pool
        # Live decode replica count (scales the decode token budget):
        # refreshed on dispatch and on shed reports — starts at 1, the
        # local-testing pool size, and never blocks the admission path.
        self._n_decode_live = 1
        self._shed_pending = 0      # sheds not yet reported upstream
        self._shed_reporting = False
        # ---- routing state ----
        self._route_cache: dict = {}    # replica_id -> OrderedDict(keys)
        self._replica_load: dict = {}   # replica_id -> inflight tokens
        self.counters = collections.Counter()
        # Blocking prefill/stream work runs here, NOT on the replica's
        # asyncio loop (and not on its tiny default executor): admitted
        # concurrency is bounded by admission control, not thread count.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(self.d.max_ongoing_requests, 8),
            thread_name_prefix="disagg")

    # ---- admission control ----

    def _admit(self, n_prompt: int, max_new: int) -> int:
        """Admit or shed, synchronously and fast (called on the request
        path BEFORE any pool work is scheduled). Returns the decode-pool
        token cost the caller must release. Every shed is attributed to
        the POOL whose budget tripped and exported as
        `ray_tpu_serve_shed_total{pool=...}` — the per-pool signal the
        serve autoscaler scales decode replicas on."""
        d = self.d
        cost = n_prompt + max_new
        with self._lock:
            decode_budget = (d.max_decode_inflight_tokens
                             * max(1, self._n_decode_live))
            est_ms = None
            if d.admission_slo_ms is not None and self._tok_rate_ema > 1.0:
                est_ms = 1e3 * (self._decode_inflight_tokens
                                / self._tok_rate_ema)
            shed_pool = None
            if self._ongoing >= d.max_ongoing_requests:
                shed_pool = "requests"
            elif (self._prefill_queue_tokens + n_prompt
                    > d.max_prefill_queue_tokens):
                shed_pool = "prefill"
            elif (self._decode_inflight_tokens + cost
                    > decode_budget):
                shed_pool = "decode"
            elif est_ms is not None and est_ms > d.admission_slo_ms:
                shed_pool = "slo"
            if shed_pool is not None:
                self.counters["shed"] += 1
                self.counters[f"shed_{shed_pool}"] += 1
                _record_shed(shed_pool)
                if shed_pool in ("decode", "slo"):
                    # Decode-capacity signal: feed the serve autoscaler
                    # (reported off-path; the shed itself stays fast).
                    self._shed_pending += 1
                msg = ("serving plane overloaded: request shed "
                       f"(pool={shed_pool}, ongoing={self._ongoing}, "
                       f"prefill_q={self._prefill_queue_tokens}tok, "
                       f"decode_inflight={self._decode_inflight_tokens}"
                       "tok"
                       + (f", est_wait={est_ms:.0f}ms"
                          if est_ms is not None else "") + ")")
            else:
                self._ongoing += 1
                self._prefill_queue_tokens += n_prompt
                self._decode_inflight_tokens += cost
                self.counters["admitted"] += 1
        if shed_pool is not None:
            self._maybe_report_sheds()
            raise OverloadedError(msg)
        return cost

    def _maybe_report_sheds(self):
        """Forward pending decode-capacity sheds to the serve controller
        (record_shed_metrics on the DecodePool deployment) — the signal
        the shed-rate autoscaler scales decode replicas on. The shed
        path only flips a flag and (at most once per burst) spawns a
        short-lived drainer thread, so a shed stays fast even when the
        controller is busy; the drainer also refreshes the live-replica
        count so the decode budget tracks scale-ups."""
        if self._local_decode is not None:
            return  # local-testing mode: no controller, fixed pool
        with self._lock:
            if self._shed_pending == 0 or self._shed_reporting:
                return
            self._shed_reporting = True
        threading.Thread(target=self._shed_report_loop, daemon=True,
                         name="disagg-shed-report").start()

    def _shed_report_loop(self):
        """Drain pending shed counts to the controller at ~2Hz until the
        burst subsides (a storm's sheds land faster than one report per
        shed could ship them; a trailing remainder must still reach the
        autoscaler or the observed rate under-counts)."""
        try:
            while True:
                with self._lock:
                    delta = self._shed_pending
                    self._shed_pending = 0
                if delta == 0:
                    return
                try:
                    router = self._decode_router()
                    reps = router.live_replicas()
                    if reps:
                        with self._lock:
                            self._n_decode_live = len(reps)
                    router._controller().record_shed_metrics.remote(
                        router.app, router.deployment, delta)
                except Exception:  # noqa: BLE001 — best-effort reporting
                    pass
                time.sleep(0.5)
        finally:
            with self._lock:
                self._shed_reporting = False

    def _release(self, cost: int, tokens_emitted: int, dt_s: float):
        with self._lock:
            self._ongoing -= 1
            self._decode_inflight_tokens -= cost
            if tokens_emitted > 0 and dt_s > 0:
                rate = tokens_emitted / dt_s
                self._tok_rate_ema = (rate if self._tok_rate_ema == 0.0
                                      else 0.7 * self._tok_rate_ema
                                      + 0.3 * rate)

    def _release_prefill(self, n_prompt: int):
        with self._lock:
            self._prefill_queue_tokens -= n_prompt

    # ---- prefix-aware routing over the decode pool ----

    def _prefix_keys(self, ids) -> list:
        """One key per full page of `ids`: the bytes of its page-aligned
        token prefix. The coordinator holds no engine (an engine's
        prefix-cache key also carries its weights' generation); the keys
        only have to agree across the coordinator's own calls."""
        page = self._page
        toks = np.asarray(ids, np.int32)
        return [toks[:(i + 1) * page].tobytes()
                for i in range(len(ids) // page)]

    def _decode_router(self):
        return self.decode._get_router()

    def _live_decode_replicas(self) -> list:
        if self._local_decode is not None:
            return ["local"]
        return self._decode_router().live_replicas()

    @staticmethod
    def _rep_id(rep) -> str:
        return rep if isinstance(rep, str) else rep.replica_id

    def _pick_by_prefix(self, reps: list, keys: list):
        """The replica whose recorded prefix keys cover the longest
        leading run of this prompt's page keys; ties break to the least
        loaded (the continuous-batching analogue of pow-2)."""
        best, best_hit, best_load = None, -1, 0
        for rep in reps:
            rid = self._rep_id(rep)
            cache = self._route_cache.get(rid)
            hit = 0
            if cache:
                for k in keys:
                    if k not in cache:
                        break
                    hit += 1
            load = self._replica_load.get(rid, 0)
            if hit > best_hit or (hit == best_hit and load < best_load):
                best, best_hit, best_load = rep, hit, load
        if best_hit > 0:
            self.counters["route_prefix_hits"] += 1
        return best

    def _record_route(self, rep, keys: list):
        rid = self._rep_id(rep)
        cache = self._route_cache.setdefault(
            rid, collections.OrderedDict())
        for k in keys:
            cache.pop(k, None)
            cache[k] = None
        while len(cache) > self.d.route_cache_prefixes:
            cache.popitem(last=False)

    def _dispatch_decode(self, ids: list, cost: int):
        """Pick a decode replica (prefix-aware), surviving injected
        dispatch drops and empty replica sets; every redrive is paced by
        the shared Backoff policy."""
        keys = self._prefix_keys(ids)
        bo = Backoff(deadline_s=self.d.dispatch_deadline_s)
        while True:
            reps = self._live_decode_replicas()
            if reps:
                if self._local_decode is None:
                    with self._lock:
                        self._n_decode_live = len(reps)
                rep = self._pick_by_prefix(reps, keys)
                if chaos.site("serve.router.drop"):
                    # Injected: the routed dispatch vanished before the
                    # pool saw it. Redrive, paced — a tight retry loop
                    # here is exactly the storm the jitter exists for.
                    self.counters["router_drops"] += 1
                    if not bo.sleep():
                        raise RayTpuError(
                            "serve router: dispatch dropped and redrive "
                            "deadline exhausted")
                    continue
                with self._lock:
                    rid = self._rep_id(rep)
                    self._replica_load[rid] = (
                        self._replica_load.get(rid, 0) + cost)
                self._record_route(rep, keys)
                return rep
            if not bo.sleep():
                raise RayTpuError(
                    f"no live decode replicas within "
                    f"{self.d.dispatch_deadline_s}s")

    def _unload(self, rep, cost: int):
        with self._lock:
            rid = self._rep_id(rep)
            left = self._replica_load.get(rid, 0) - cost
            if left > 0:
                self._replica_load[rid] = left
            else:
                self._replica_load.pop(rid, None)

    def _note_decode_failure(self, rep, exc):
        """A decode replica failed mid-stream: forget its prefix cache,
        report it dead so the controller respawns it, and route around."""
        self.counters["decode_failures"] += 1
        rid = self._rep_id(rep)
        self._route_cache.pop(rid, None)
        with self._lock:
            self._replica_load.pop(rid, None)
        if self._local_decode is None:
            self._decode_router().mark_replica_dead(rid)
        print(f"serve: decode replica {rid} failed mid-stream ({exc}); "
              "re-resolving its streams", file=sys.stderr)

    # ---- prefill + decode streams, with recovery ----

    def _prefill_with_retry(self, ids, temperature, top_p, top_k,
                            want_logp: bool = False) -> dict:
        """Prefill through the pool handle; worker death / timeout
        redrives through the shared backoff (the sealed handoff object,
        once exported, survives its worker's death)."""
        bo = Backoff(deadline_s=self.d.dispatch_deadline_s)
        while True:
            try:
                return self.prefill.prefill.remote(
                    list(ids), temperature, top_p, top_k,
                    want_logp).result(timeout_s=60)
            except (ActorDiedError, GetTimeoutError) as e:
                if not bo.sleep():
                    raise RayTpuError(
                        f"prefill pool unavailable: {e}") from e

    def _open_decode_stream(self, rep, ids, generated, kv, max_new,
                            temperature, top_p, top_k,
                            want_logp: bool = False):
        """One decode stream attempt on one replica: yields token chunks
        ((token, logprob) pair chunks with want_logp); raises RayTpuError
        when the replica dies mid-stream."""
        args = [list(ids), list(generated), kv, max_new, temperature,
                top_p, top_k, self.d.stream_chunk_tokens, want_logp]
        if self._local_decode is not None:
            yield from self._local_decode.decode_stream(*args)
            return
        router = self._decode_router()
        gen = router.assign_streaming_to(rep, "decode_stream", args, {})
        try:
            for ref in gen:
                yield ray_tpu_torch.get(ref, timeout=120)
        finally:
            gen.close()
            router.release_streaming(rep.replica_id)

    def _stream_tokens(self, ids, generated, kv, max_new, temperature,
                       top_p, top_k, cost: int, logps: list | None = None):
        """Yield the tokens after `generated` EXACTLY ONCE, re-resolving
        the stream on a surviving replica when a decode replica dies
        mid-flight. `generated` is mutated in place (the recovery cursor:
        a resumed stream continues from the last delivered position).
        When `logps` is a list, the decode pool streams (token, logprob)
        pairs and logps grows in lockstep with generated — a resumed
        stream keeps the logprobs of already-delivered positions (they
        were never re-decoded) and appends only the new ones."""
        bo = Backoff(deadline_s=self.d.resume_deadline_s)
        want_logp = logps is not None
        while len(generated) < max_new and generated[-1] != self._eos:
            rep = self._dispatch_decode(ids, cost)
            try:
                for chunk in self._open_decode_stream(
                        rep, ids, generated, kv, max_new, temperature,
                        top_p, top_k, want_logp):
                    for item in chunk:
                        if want_logp:
                            tok, lp = item
                            logps.append(lp)
                        else:
                            tok = item
                        generated.append(int(tok))
                        yield int(tok)
                    bo.reset()  # progress restarts the recovery budget
                return  # clean close: the engine finished the request
            except RayTpuError as e:
                # Mid-stream death (or torn stream): re-resolve from the
                # last DELIVERED token. Tokens already yielded are never
                # re-emitted; the next attempt re-prefills (or re-imports
                # the sealed handoff) and decodes positions
                # len(generated).. only.
                self._note_decode_failure(rep, e)
                self.counters["streams_resumed"] += 1
                if not bo.sleep():
                    raise
            finally:
                self._unload(rep, cost)

    def _run_admitted(self, ids, max_new, temperature, top_p, top_k,
                      cost: int, want_logp: bool = False) -> tuple:
        """Prefill -> route -> stream to completion; returns
        (tokens, logprobs-or-None) (admission already charged; released
        here)."""
        t0 = time.monotonic()
        toks: list = []
        logps: list | None = [] if want_logp else None
        try:
            try:
                pre = self._prefill_with_retry(ids, temperature, top_p,
                                               top_k, want_logp)
            finally:
                self._release_prefill(len(ids))
            kv = pre["kv"] if self.d.handoff else None
            self.counters["handoff_tokens"] += (pre["kv_tokens"]
                                                if kv is not None else 0)
            toks = [pre["first"]]
            if want_logp:
                logps.append(pre.get("first_logp"))
            if toks[0] != self._eos:
                for tok in self._stream_tokens(
                        ids, toks, kv, max_new, temperature, top_p,
                        top_k, cost, logps):
                    pass  # _stream_tokens appends into toks/logps
            self.counters["completed"] += 1
            return toks, logps
        finally:
            self._release(cost, len(toks), time.monotonic() - t0)

    # ---- request surface (mirrors _LLMServerImpl) ----

    def _check_plain(self, model, guided_regex=None, guided_json=None):
        if model is not None and model != self.cfg.model_id:
            raise ValueError(
                f"model {model!r}: the disaggregated plane serves only "
                f"the base model {self.cfg.model_id!r}")
        if guided_regex or guided_json:
            raise ValueError("guided decoding is not supported on the "
                             "disaggregated plane")

    async def completions(self, prompt: str, *, max_tokens=None,
                          temperature=None, top_p: float = 1.0,
                          top_k: int = 0, model=None, guided_regex=None,
                          guided_json=None, stop=None,
                          logprobs=None) -> dict:
        self._check_plain(model, guided_regex, guided_json)
        want_logp = bool(logprobs)
        ids = self.tokenizer.encode(prompt)
        max_new = max_tokens or self._max_new_default
        # Admission runs HERE, on the replica's event loop, before any
        # executor hop: a shed must stay fast and loud even when every
        # worker thread is busy decoding admitted traffic.
        cost = self._admit(len(ids), max_new)
        loop = asyncio.get_running_loop()
        toks, logps = await loop.run_in_executor(
            self._pool, self._run_admitted, ids, max_new, temperature,
            top_p, top_k, cost, want_logp)
        text = self.tokenizer.decode(toks)
        text, stopped = _LLMServerImpl._apply_stop(text, stop)
        lp = None
        if want_logp:
            # Same alignment helper as the dense replica: logprobs
            # gathered across prefill-export, the decode stream, and any
            # mid-stream resumes read as ONE per-token array.
            lp = _logprob_fields(self.tokenizer, text, stopped, toks,
                                 logps or [])
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "model": self.cfg.model_id,
            "choices": [{"index": 0, "text": text, "logprobs": lp,
                         "finish_reason": "stop" if stopped else
                         ("length" if len(toks) >= max_new else "stop")}],
            "usage": {"prompt_tokens": len(ids),
                      "completion_tokens": len(toks),
                      "total_tokens": len(ids) + len(toks)},
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
        """Streaming text deltas through the disaggregated plane (same
        stop-sequence holdback semantics as the dense replica's stream).
        `logprobs` is the router's argument; a stream with logprobs is
        refused (ValueError): the plane streams text only, and a
        non-streaming `completions` request carries logprobs."""
        if logprobs:
            raise ValueError("a stream with logprobs is not served on the "
                             "disaggregated plane (ask without stream)")
        self._check_plain(model)
        ids = self.tokenizer.encode(prompt)
        max_new = max_tokens or self._max_new_default
        cost = self._admit(len(ids), max_new)
        t0 = time.monotonic()
        stops = ([stop] if isinstance(stop, str) else list(stop or []))
        hold = max((len(s) for s in stops), default=1) - 1
        toks: list = []
        try:
            try:
                pre = self._prefill_with_retry(ids, temperature, top_p,
                                               top_k)
            finally:
                self._release_prefill(len(ids))
            kv = pre["kv"] if self.d.handoff else None
            toks = [pre["first"]]

            def token_iter():
                yield toks[0]
                if toks[0] != self._eos:
                    yield from self._stream_tokens(
                        ids, toks, kv, max_new, temperature, top_p,
                        top_k, cost)

            sent = ""
            done = False
            seen: list = []
            it = token_iter()
            while not done:
                try:
                    seen.append(next(it))
                    text = _hold_incomplete_utf8(
                        self.tokenizer.decode(seen))
                except StopIteration:
                    done = True
                    text = self.tokenizer.decode(seen)
                if stops:
                    cut = min((i for i in (text.find(s) for s in stops
                                           if s) if i >= 0), default=-1)
                    if cut >= 0:
                        text, done = text[:cut], True
                    elif not done and hold:
                        text = text[:max(len(text) - hold, len(sent))]
                if len(text) > len(sent):
                    delta, sent = text[len(sent):], text
                    yield delta
            self.counters["completed"] += 1
        finally:
            self._release(cost, len(toks), time.monotonic() - t0)

    def model_ids(self) -> list:
        return [self.cfg.model_id]

    def stats(self) -> dict:
        """Admission/routing/recovery counters + live gauges (tests, the
        smoke run, and dashboards)."""
        with self._lock:
            out = dict(self.counters)
            out.update(
                ongoing=self._ongoing,
                prefill_queue_tokens=self._prefill_queue_tokens,
                decode_inflight_tokens=self._decode_inflight_tokens,
                decode_tok_rate_ema=round(self._tok_rate_ema, 1),
                n_decode_live=self._n_decode_live)
        return out


def build_disagg_deployment(llm_config: LLMConfig,
                            disagg: DisaggConfig | None = None):
    """The disaggregated serving plane as an Application rooted at the
    coordinator: a prefill pool + a decode pool + the coordinator wiring
    them (admission, prefix routing, handoff, recovery). Each pool replica
    reserves `num_gpus_per_replica` of the "GPU" resource (a fraction
    lets one card hold several; at tp > 1 each of its ranks a tp-th of
    it, `_replica_options`); the coordinator reserves none."""
    llm_config.check()   # refused before any replica starts
    d = disagg or DisaggConfig()
    mid = llm_config.model_id
    place = _replica_options(llm_config)
    prefill = serve.deployment(
        _PrefillWorkerImpl, name=f"PrefillPool:{mid}").options(
        num_replicas=d.prefill_replicas, **place,
    ).bind(llm_config)
    decode = serve.deployment(
        _DecodeReplicaImpl, name=f"DecodePool:{mid}").options(
        num_replicas=d.decode_replicas,
        health_check_period_s=0.5,
        # Shed-rate autoscaling (DisaggConfig.decode_autoscale): the
        # coordinator attributes decode-capacity sheds to this pool and
        # the controller grows it when the rate sustains.
        autoscaling_config=d.decode_autoscale, **place,
    ).bind(llm_config)
    coord = serve.deployment(
        _DisaggServerImpl, name=f"DisaggLLMServer:{mid}")
    return coord.bind(llm_config, d, prefill, decode)


def build_disagg_openai_app(llm_config: LLMConfig,
                            disagg: DisaggConfig | None = None):
    """OpenAI-surface ingress over the disaggregated plane — the drop-in
    sibling of `build_openai_app` (same routes; overload sheds surface as
    HTTP 429)."""
    server = build_disagg_deployment(llm_config, disagg)
    router = serve.deployment(_OpenAiRouterImpl, name="OpenAiRouter")
    return router.bind(server)
