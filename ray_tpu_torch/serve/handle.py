"""DeploymentHandle + Router with power-of-two-choices replica scheduling
(counterpart of `ray_tpu/serve/handle.py`).

Parity: reference `python/ray/serve/handle.py:628` (DeploymentHandle /
DeploymentResponse) and `_private/replica_scheduler/pow_2_scheduler.py:52`.
The reference probes replica queue lengths over RPC; here each router keeps a
local in-flight count per replica (decremented by a background waiter thread)
and pow-2 picks the emptier of two sampled replicas — same load-balancing
effect without doubling the RPC count.
"""

from __future__ import annotations

import random
import threading
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch.core.status import ActorDiedError, RayTpuError
from ray_tpu_torch.serve.config import CONTROLLER_NAME

# get_actor raises ValueError for a missing name; controller RPCs raise
# RayTpuError subclasses. Routers must survive both (controller restarts).
_CONTROLLER_ERRORS = (RayTpuError, ValueError)


class DeploymentResponse:
    """Future-like result of handle.remote() (parity: handle.py DeploymentResponse)."""

    def __init__(self, ref, router, replica_id):
        self._ref = ref
        self._router = router
        self._replica_id = replica_id

    def result(self, timeout_s: float | None = 60.0):
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        except ActorDiedError:
            self._router._mark_dead(self._replica_id)
            raise

    def __await__(self):
        def _block():
            return self.result(timeout_s=None)
        # Run the blocking get in a thread so async actors don't stall.
        import asyncio
        return asyncio.get_event_loop().run_in_executor(None, _block).__await__()

    @property
    def object_ref(self):
        return self._ref


class Router:
    """Per-handle replica set cache + pow-2 load balancing + metrics push."""

    REFRESH_PERIOD_S = 1.0
    METRICS_PERIOD_S = 1.0

    # Process-wide serve metrics (parity: the serve_* metrics the
    # reference's router/proxy export for the Grafana serve board;
    # serve_deployment_metrics.py). Lazily created so importing handle
    # doesn't register metrics in processes that never route.
    _METRICS = None
    _METRICS_LOCK = threading.Lock()

    @classmethod
    def _metrics(cls):
        with Router._METRICS_LOCK:
            return cls._metrics_locked()

    @classmethod
    def _metrics_locked(cls):
        if Router._METRICS is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram
            Router._METRICS = {
                "requests": Counter(
                    "serve_num_router_requests",
                    "Requests routed, by deployment",
                    tag_keys=("deployment", "application")),
                "latency": Histogram(
                    "serve_request_latency_ms",
                    "End-to-end request latency (ms)",
                    boundaries=(1, 5, 10, 50, 100, 500, 1000, 5000),
                    tag_keys=("deployment", "application")),
            }
        return Router._METRICS

    def __init__(self, app_name: str, deployment_name: str):
        self.app = app_name
        self.deployment = deployment_name
        self.router_id = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._replicas = []           # [ReplicaInfo]
        self._handles = {}            # replica_id -> ActorHandle
        self._inflight = {}           # replica_id -> int
        self._version = -1
        self._last_refresh = 0.0
        self._last_metrics_push = 0.0
        self._pending = []            # [(ref, replica_id)] awaiting completion
        self._pending_cv = threading.Condition(self._lock)
        self._waiter = None
        self._closed = False

    # -- replica set maintenance ------------------------------------------
    def _controller(self):
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    def _refresh(self, force=False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self.REFRESH_PERIOD_S:
            return
        self._last_refresh = now
        try:
            target = ray_tpu_torch.get(
                self._controller().get_deployment_target.remote(
                    self.app, self.deployment), timeout=10)
        except _CONTROLLER_ERRORS:
            return
        if target is None:
            # App deleted: full reset so a later redeploy (whose snapshot
            # version may coincide with ours) is not mistaken for cached state.
            with self._lock:
                self._replicas, self._handles = [], {}
                self._inflight = {}
                self._version = -1
            return
        with self._lock:
            if target.version == self._version:
                return
            self._version = target.version
            self._replicas = list(target.replicas)
            live = {r.replica_id for r in self._replicas}
            self._handles = {k: v for k, v in self._handles.items() if k in live}
            self._inflight = {
                k: self._inflight.get(k, 0) for k in live}

    def _mark_dead(self, replica_id: str):
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r.replica_id != replica_id]
            self._handles.pop(replica_id, None)
        try:
            self._controller().report_replica_death.remote(
                self.app, self.deployment, replica_id)
        except _CONTROLLER_ERRORS:
            pass
        self._last_refresh = 0.0  # force refresh on next send

    def _handle_for(self, info):
        h = self._handles.get(info.replica_id)
        if h is None:
            h = ray_tpu_torch.get_actor(info.actor_name)
            self._handles[info.replica_id] = h
        return h

    # -- pow-2 choice ------------------------------------------------------
    def _pick(self):
        # Replica-wait pacing rides the shared backoff policy
        # (core/retry.py) instead of a fixed 50ms poll: N routers hammering
        # a restarting controller is the retry storm jitter exists for.
        from ray_tpu_torch.core.retry import Backoff
        bo = Backoff(deadline_s=30.0)
        while True:
            self._refresh()
            with self._lock:
                reps = list(self._replicas)
            if reps:
                break
            if not bo.sleep():
                raise RayTpuError(
                    f"no replicas for {self.app}/{self.deployment} after 30s")
            self._last_refresh = 0.0
        with self._lock:
            if len(reps) == 1:
                chosen = reps[0]
            else:
                a, b = random.sample(reps, 2)
                chosen = a if (self._inflight.get(a.replica_id, 0)
                               <= self._inflight.get(b.replica_id, 0)) else b
            self._inflight[chosen.replica_id] = (
                self._inflight.get(chosen.replica_id, 0) + 1)
            return chosen

    # -- request path ------------------------------------------------------
    def assign_streaming(self, method_name, args, kwargs,
                         multiplexed_model_id: str = ""):
        """Streaming request: returns the raw ObjectRefGenerator of the
        replica's handle_streaming_request (parity: the generator path of
        serve/_private/proxy.py:420)."""
        info = self._pick()
        h = self._handle_for(info)
        self._metrics()["requests"].inc(
            tags={"deployment": self.deployment, "application": self.app})
        gen = h.handle_streaming_request.options(
            num_returns="streaming").remote(
                method_name, list(args), dict(kwargs), multiplexed_model_id)
        # In-flight accounting: streaming requests count until the stream
        # closes; the drain loop cannot watch a generator, so decrement in
        # the generator wrapper's close path instead.
        return gen, info.replica_id

    def release_streaming(self, replica_id):
        with self._lock:
            if replica_id in self._inflight and self._inflight[replica_id] > 0:
                self._inflight[replica_id] -= 1
        self._maybe_push_metrics()

    # -- replica-addressed routing (the serve-llm prefix router) -----------
    def live_replicas(self) -> list:
        """The current replica set (refreshing the cached controller
        snapshot). Callers that route by replica IDENTITY — e.g. the
        disaggregated LLM plane's longest-prefix decode routing — pick
        from this list and dispatch via assign_streaming_to; pow-2 stays
        the default anonymous path."""
        self._refresh()
        with self._lock:
            return list(self._replicas)

    def assign_streaming_to(self, info, method_name, args, kwargs,
                            multiplexed_model_id: str = ""):
        """Streaming request pinned to a SPECIFIC replica (from
        live_replicas). The caller owns the stream: call
        release_streaming(info.replica_id) when it closes."""
        h = self._handle_for(info)
        self._metrics()["requests"].inc(
            tags={"deployment": self.deployment, "application": self.app})
        with self._lock:
            self._inflight[info.replica_id] = (
                self._inflight.get(info.replica_id, 0) + 1)
        return h.handle_streaming_request.options(
            num_returns="streaming").remote(
                method_name, list(args), dict(kwargs), multiplexed_model_id)

    def mark_replica_dead(self, replica_id: str):
        """Public seam for identity-routing callers that observed a
        replica die mid-request (reports to the controller + forces a
        snapshot refresh)."""
        self._mark_dead(replica_id)

    def assign(self, method_name, args, kwargs,
               multiplexed_model_id: str = "") -> DeploymentResponse:
        info = self._pick()
        h = self._handle_for(info)
        self._metrics()["requests"].inc(
            tags={"deployment": self.deployment, "application": self.app})
        ref = h.handle_request.remote(method_name, list(args), dict(kwargs),
                                      multiplexed_model_id)
        with self._pending_cv:
            self._pending.append((ref, info.replica_id, time.monotonic()))
            self._pending_cv.notify()
            if self._waiter is None:
                self._waiter = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name=f"serve-router-{self.deployment}")
                self._waiter.start()
        self._maybe_push_metrics()
        return DeploymentResponse(ref, self, info.replica_id)

    def _drain_loop(self):
        """Completes in-flight bookkeeping (decrement on task finish)."""
        while True:
            try:
                with self._pending_cv:
                    while not self._pending and not self._closed:
                        self._pending_cv.wait(timeout=1.0)
                    if self._closed:
                        return
                    batch = self._pending
                    self._pending = []
                refs = [r for r, *_ in batch]
                done, not_done = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=0.5)
                done_set = {id(d) for d in done}
                still = []
                for ref, rid, t0 in batch:
                    if id(ref) in done_set:
                        with self._lock:
                            if rid in self._inflight and self._inflight[rid] > 0:
                                self._inflight[rid] -= 1
                        self._metrics()["latency"].observe(
                            (time.monotonic() - t0) * 1e3,
                            tags={"deployment": self.deployment,
                                  "application": self.app})
                    else:
                        still.append((ref, rid, t0))
                if still:
                    with self._pending_cv:
                        self._pending.extend(still)
                    time.sleep(0.02)
                self._maybe_push_metrics()
            except Exception:
                # The drain thread must outlive transient controller/runtime
                # errors, or in-flight counts freeze and pow-2 goes blind.
                time.sleep(0.2)

    def _maybe_push_metrics(self):
        now = time.monotonic()
        if now - self._last_metrics_push < self.METRICS_PERIOD_S:
            return
        self._last_metrics_push = now
        with self._lock:
            total = sum(self._inflight.values())
        try:
            self._controller().record_handle_metrics.remote(
                self.app, self.deployment, total, self.router_id)
        except _CONTROLLER_ERRORS:
            pass

    def close(self):
        with self._pending_cv:
            self._closed = True
            self._pending_cv.notify_all()


class DeploymentHandle:
    """Callable handle to a deployment (parity: serve/handle.py:628)."""

    def __init__(self, app_name: str, deployment_name: str,
                 method_name: str | None = None,
                 multiplexed_model_id: str = ""):
        self._app = app_name
        self._deployment = deployment_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._router = None
        self._lock = threading.Lock()

    def _get_router(self) -> Router:
        with self._lock:
            if self._router is None:
                self._router = Router(self._app, self._deployment)
            return self._router

    def options(self, method_name: str | None = None,
                multiplexed_model_id: str | None = None) -> "DeploymentHandle":
        h = DeploymentHandle(
            self._app, self._deployment,
            self._method if method_name is None else method_name,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id)
        h._router = self._router  # share the router/in-flight accounting
        return h

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return DeploymentHandle.options(self, method_name=item)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._get_router().assign(
            self._method, args, kwargs, self._model_id)

    def remote_streaming(self, *args, **kwargs):
        """Call a generator deployment: yields each streamed value as it is
        produced (first item arrives before the generator finishes)."""
        router = self._get_router()
        gen, replica_id = router.assign_streaming(
            self._method, args, kwargs, self._model_id)

        def value_iter():
            try:
                for ref in gen:
                    yield ray_tpu_torch.get(ref, timeout=300)
            finally:
                gen.close()
                router.release_streaming(replica_id)

        return value_iter()

    def __reduce__(self):
        return (DeploymentHandle, (self._app, self._deployment, self._method,
                                   self._model_id))

    def __repr__(self):
        m = f".{self._method}" if self._method else ""
        return f"DeploymentHandle({self._app}/{self._deployment}{m})"
