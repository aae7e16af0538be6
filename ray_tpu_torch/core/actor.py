"""Actor machinery: ActorClass / ActorHandle / ActorMethod.

Parity: reference `python/ray/actor.py` (ActorClass:612, _remote:900,
ActorMethod:116, ActorHandle:1280) and the GCS-managed lifecycle
(`gcs_actor_manager.h:328`). Calls are delivered in submission order per
submitter over FIFO sockets (parity: actor_task_submitter.h:78 sequence
numbers); async/threaded actors opt into out-of-order execution like the
reference's fiber/concurrency-group queues.
"""

from __future__ import annotations

import inspect
import os

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.core.jobs import current_job_id
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.remote_function import _promote_large
from ray_tpu_torch.core.task import ActorCreationSpec, TaskSpec


def _method_meta(cls) -> dict:
    meta = {}
    for name, fn in inspect.getmembers(cls, predicate=callable):
        if name.startswith("__") and name != "__call__":
            continue
        opts = getattr(fn, "_method_options", {})
        meta[name] = {
            "num_returns": opts.get("num_returns", 1),
            "is_async": inspect.iscoroutinefunction(fn),
        }
    return meta


def method(**opts):
    """Per-method options decorator (parity: ray.method)."""
    def wrap(fn):
        fn._method_options = opts
        return fn
    return wrap


class ActorClass:
    def __init__(self, cls, **default_options):
        self._cls = cls
        self._options = default_options
        self._cls_id = None
        self._cls_blob = None
        self._meta = _method_meta(cls)
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **opts):
        clone = ActorClass(self._cls, **{**self._options, **opts})
        clone._cls_id, clone._cls_blob = self._cls_id, self._cls_blob
        return clone

    def __call__(self, *a, **kw):
        raise TypeError(f"Actors must be created with {self.__name__}.remote()")

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, opts):
        from ray_tpu_torch.core.runtime import Runtime, get_runtime
        rt = get_runtime()
        if self._cls_id is None:
            self._cls_id, self._cls_blob = serialization.serialize_function(self._cls)
        args = [_promote_large(rt, a) for a in args]
        kwargs = {k: _promote_large(rt, v) for k, v in kwargs.items()}
        payload, buffers, refs = serialization.serialize_args(args, kwargs)
        actor_id = ActorID.from_random()
        has_async = any(m["is_async"] for m in self._meta.values())
        cfg = get_config()
        cspec = ActorCreationSpec(
            actor_id=actor_id.binary(),
            cls_id=self._cls_id,
            name=opts.get("name"),
            payload=payload,
            buffers=buffers,
            max_restarts=opts.get("max_restarts", cfg.actor_max_restarts_default),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get(
                "max_concurrency",
                cfg.async_actor_default_max_concurrency if has_async else 1),
            is_async=has_async,
            # Parity with the reference: an actor holds 0 CPUs for its
            # lifetime unless asked (actor.py default) — a 1-CPU default
            # would starve the cluster as long-lived actors accumulate.
            num_cpus=opts.get("num_cpus", 0),
            num_gpus=opts.get("num_gpus", 0),
            resources=opts.get("resources"),
            placement_group_id=_pg_id(opts),
            bundle_index=_pg_bundle(opts),
            scheduling_strategy=opts.get("scheduling_strategy"),
            dependencies=[r.id.binary() for r in refs],
            runtime_env=opts.get("runtime_env"),
            job_id=current_job_id(opts, rt),
        )
        cspec.methods_meta = self._meta
        if isinstance(rt, Runtime):
            rt.create_actor(cspec, fn_blob=self._cls_blob)
        else:
            rt.send(("export_fn", self._cls_id, self._cls_blob))
            rt.send(("create_actor", cspec))
        return ActorHandle(actor_id.binary(), self.__name__, self._meta)


def _pg_id(opts):
    strategy = opts.get("scheduling_strategy")
    pg = getattr(strategy, "placement_group", None) or opts.get("placement_group")
    return pg.id.binary() if pg is not None else None


def _pg_bundle(opts):
    strategy = opts.get("scheduling_strategy")
    if strategy is not None:
        return getattr(strategy, "placement_group_bundle_index", None)
    return opts.get("placement_group_bundle_index")


class ActorMethod:
    __slots__ = ("_handle", "_name", "_num_returns")

    def __init__(self, handle, name, num_returns=1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, num_returns=self._num_returns)

    def options(self, **opts):
        m = ActorMethod(self._handle, self._name,
                        opts.get("num_returns", self._num_returns))
        return m

    def _remote(self, args, kwargs, num_returns=1):
        from ray_tpu_torch.util import tracing as _tr
        if _tr._enabled:
            with _tr.submit_span(f"{self._handle._name}.{self._name}",
                                 "actor_task"):
                return self._remote_inner(args, kwargs, num_returns)
        return self._remote_inner(args, kwargs, num_returns)

    def _remote_inner(self, args, kwargs, num_returns=1):
        from ray_tpu_torch.core.runtime import Runtime, get_runtime
        rt = get_runtime()
        streaming = num_returns == "streaming"
        if streaming:
            # Submittable from the driver or any worker: workers consume
            # the stream through head-side stream_next RPCs.
            num_returns = 0
        args = [_promote_large(rt, a) for a in args]
        kwargs = {k: _promote_large(rt, v) for k, v in kwargs.items()}
        payload, buffers, refs = serialization.serialize_args(args, kwargs)
        # Large pickle-5 buffers ship through the shm arena (one copy, read
        # back zero-copy) instead of riding two socket hops via the head.
        # Calls with returns only: the pack's caller-side ref release keys
        # on the returns resolving (streaming calls have none).
        args_ref = None
        if not streaming and num_returns >= 1:
            args_ref, payload, buffers = serialization.maybe_offload_args(
                rt, payload, buffers)
        from ray_tpu_torch.util import tracing as _tracing
        trace_ctx = _tracing.inject_context() if _tracing._enabled else None
        # One entropy read for every id this call needs.
        rnd = os.urandom(16 + 16 * num_returns)
        task_id = TaskID(rnd[:16])
        return_ids = [rnd[16 + 16 * i : 32 + 16 * i]
                      for i in range(num_returns)]
        spec = TaskSpec(
            task_id=task_id.binary(),
            fn_id=None,
            name=self._handle._name,
            payload=payload,
            buffers=buffers,
            return_ids=return_ids,
            num_cpus=0,
            num_gpus=0,
            actor_id=self._handle._actor_id,
            method_name=self._name,
            max_retries=0,
            retries_left=0,
            dependencies=([r.id.binary() for r in refs]
                          + ([args_ref] if args_ref else [])),
            trace_ctx=trace_ctx,
            streaming=streaming,
            args_ref=args_ref,
            # Caller-pays attribution: the submitting job owns the call
            # (actor tasks hold no CPUs, so this only feeds event
            # retention + the dashboard, not the quota gate).
            job_id=current_job_id(None, rt),
        )
        if isinstance(rt, Runtime):
            rt.submit_task(spec)
        else:
            # Direct path (parity: actor_task_submitter.h:78 direct gRPC):
            # a worker on an agent node ships the call straight to the
            # actor's agent, skipping the head relay entirely. The agent
            # falls back to the head on stale locations / dead peers.
            cfg = get_config()
            on_agent = getattr(rt, "on_agent_node", False)
            direct_capable = on_agent and cfg.direct_actor_calls
            # Head-node workers have their own direct transport: the
            # worker<->worker UDS peer plane (worker.py _WorkerPeer) —
            # same two-racing-transports shape as the agent plane, so the
            # same seq stamping + executor-side order gate applies.
            # hasattr guard: client-mode drivers (util/client.py) share
            # this code path but have no peer plane — resolving locations
            # there would aim agent-plane frames at the head.
            worker_capable = (not on_agent and cfg.direct_actor_calls
                              and cfg.worker_direct_calls
                              and hasattr(rt, "send_direct_worker"))
            if direct_capable or worker_capable:
                # This caller may interleave direct and head-path calls to
                # the same actor (ref-arg/streaming calls must ride the
                # head). The two transports race, so every call carries a
                # per-(caller, actor) sequence number and the executing
                # node's agent restores submission order before delivery
                # (parity: actor_task_submitter.h:78 sequence numbers). A
                # call the head parks on still-pending deps has its slot
                # skip-released so it can't stall later calls: it orders
                # at dep-resolution time, matching the reference (seq
                # claimed post-resolution, dependency_resolver.h).
                spec.owner = rt.worker_id.binary()
                spec.caller_seq = rt.next_actor_call_seq(
                    self._handle._actor_id)
            # Ref args normally need the head's dependency gating/pinning:
            # a direct delivery would block the actor in arg resolution
            # (head-of-line) and skip the owner's borrow pin. BUT when
            # every ref dep is owned by THIS worker and already sealed in
            # the arena, both hazards vanish — the executor resolves them
            # instantly from shm and pin_call_deps holds the owner's refs
            # until the returns land. That keeps with-arg call bursts
            # (actor fan-outs passing a put() handle) on the direct plane
            # instead of paying a per-call head round trip.
            local_deps = (bool(refs)
                          and (direct_capable or worker_capable)
                          and hasattr(rt, "deps_ready_local")
                          and rt.deps_ready_local(refs))
            direct_ok = not refs or local_deps
            dep_oids = [r.id.binary() for r in refs] if local_deps else []
            held = [args_ref] if args_ref else []
            if (dep_oids or held) and hasattr(rt, "pin_call_deps"):
                # Pin BEFORE any send so a racing completion can't release
                # first; adds on non-owned keys are no-ops.
                rt.pin_call_deps(spec, add_oids=dep_oids, held_oids=held)
            loc = None
            if not streaming and direct_ok and (direct_capable
                                                or worker_capable):
                loc = rt.resolve_actor_location(self._handle._actor_id)
            if loc is not None and loc[0] == "uds":
                # Worker peer plane: ship straight to the hosting
                # worker's unix socket — 2 frame hops instead of 4, the
                # head entirely out of the data path.
                spec.retries_left = 1 if (len(loc) > 2 and loc[2]) else 0
                if not rt.send_direct_worker(loc[1], spec):
                    # Stale path / dead worker: drop the cached location
                    # and take the thin head dispatch.
                    rt.actor_locations.pop(self._handle._actor_id, None)
                    rt.send(("direct_actor_head", spec))
            elif loc is not None and on_agent:
                # The resolution carries whether the actor permits task
                # retries: a direct call whose channel dies mid-flight may
                # have executed, and only retry-permitted calls replay.
                spec.retries_left = 1 if (len(loc) > 2 and loc[2]) else 0
                rt.send(("direct_actor", loc[0], loc[1], spec))
            elif (not streaming and direct_ok and not on_agent
                  and cfg.direct_actor_calls):
                # Head-node worker, no direct location (head-hosted /
                # unstable actor or plane disabled): the head still takes
                # the THIN dispatch (straight to _send_actor_task,
                # skipping journal/SUBMITTED-event/rid_to_spec/dep-pin
                # bookkeeping a dep-free actor call doesn't need).
                rt.send(("direct_actor_head", spec))
            else:
                rt.send(("submit", spec))
        if streaming:
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(task_id.binary(), rt)
        out = [ObjectRef(ObjectID(rid)) for rid in return_ids]
        return out[0] if num_returns == 1 else out

    def bind(self, *args, **kwargs):
        """DAG-building edge (parity: dag/class_node.py bind)."""
        raise NotImplementedError(
            "actor method .bind() builds a DAG (ray_tpu.dag), which the "
            "PyTorch port takes up with ROADMAP queue 1 item 9 (channels and "
            "compiled graphs); not ported yet")

    def __call__(self, *a, **kw):
        raise TypeError(f"Actor method {self._name} must be called with .remote()")


class ActorHandle:
    def __init__(self, actor_id: bytes, name: str, methods: dict):
        self._actor_id = actor_id
        self._name = name
        self._methods = methods

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        meta = self._methods.get(item)
        if meta is None:
            raise AttributeError(
                f"actor {self._name} has no method {item!r}")
        return ActorMethod(self, item, meta.get("num_returns", 1))

    @property
    def actor_id(self):
        return ActorID(self._actor_id)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._name, self._methods))

    def __repr__(self):
        return f"ActorHandle({self._name}, {self._actor_id.hex()[:12]})"
