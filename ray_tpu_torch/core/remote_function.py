"""@remote function machinery.

Parity: reference `python/ray/remote_function.py:303` (RemoteFunction._remote):
serialize args (inline small, shm for large), record contained ObjectRefs as
dependencies, create deterministic return ids, and hand the spec to the local
runtime (head) or ship it over the worker socket.
"""

from __future__ import annotations

import os

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ObjectID, TaskID, random_bytes
from ray_tpu_torch.core.jobs import current_job_id
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task import TaskSpec

_LARGE_ARG_THRESHOLD = 1024 * 1024  # promote args above this to the shm store

# Per-call `from x import y` resolves through importlib's fromlist handler
# every time — measurable on the submit hot loop. Cache the modules once
# (still lazy: runtime/tracing must not import at module load).
_rt_mod = None
_tr_mod = None


def _runtime_mod():
    global _rt_mod
    if _rt_mod is None:
        from ray_tpu_torch.core import runtime as _rt_mod_  # noqa: N813
        _rt_mod = _rt_mod_
    return _rt_mod


def _tracing_mod():
    global _tr_mod
    if _tr_mod is None:
        from ray_tpu_torch.util import tracing as _tr_mod_
        _tr_mod = _tr_mod_
    return _tr_mod


class RemoteFunction:
    def __init__(self, fn, **default_options):
        self._fn = fn
        self._options = default_options
        self._fn_id = None
        self._fn_blob = None
        self._exported_in: set[int] = set()  # pids this fn was exported from
        self.__name__ = getattr(fn, "__name__", "remote_fn")

    def _ensure_serialized(self):
        if self._fn_id is None:
            self._fn_id, self._fn_blob = serialization.serialize_function(self._fn)
        return self._fn_id, self._fn_blob

    def options(self, **opts):
        merged = {**self._options, **opts}
        clone = RemoteFunction(self._fn, **merged)
        clone._fn_id, clone._fn_blob = self._ensure_serialized()
        clone._exported_in = self._exported_in
        return clone

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        """Task-DAG edge (parity: dag/function_node.py bind; consumed by
        ray_tpu_torch.workflow)."""
        raise NotImplementedError(
            "task .bind() builds a workflow DAG (ray_tpu.workflow), a "
            "library on the runtime that the PyTorch port copies when a "
            "slice needs it (ROADMAP queue 1 item 6, 'copy on need'); not "
            "ported yet")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote().")

    def _remote(self, args, kwargs, opts):
        _tr = _tracing_mod()  # lazy: tracing pulls otel
        if _tr._enabled:
            # The submit span parents the worker-side execute span via the
            # carrier injected below (parity: tracing_helper decorators).
            with _tr.submit_span(self.__name__, "task"):
                return self._remote_inner(args, kwargs, opts)
        return self._remote_inner(args, kwargs, opts)

    def _remote_inner(self, args, kwargs, opts):
        rt_mod = _runtime_mod()
        Runtime, rt = rt_mod.Runtime, rt_mod.get_runtime()
        fn_id, fn_blob = self._ensure_serialized()

        # Large plain args go to the shm store so the payload frame stays small.
        args = [_promote_large(rt, a) for a in args]
        kwargs = {k: _promote_large(rt, v) for k, v in kwargs.items()}

        payload, buffers, refs = serialization.serialize_args(args, kwargs)
        num_returns = opts.get("num_returns", 1)
        # Large pickle-5 buffers (nested arrays the per-arg promotion above
        # can't see) ship through the shm arena instead of the socket frame.
        # Only for calls with returns: the caller-side ref release keys on
        # the returns resolving, and a streaming/0-return call would drop
        # the pack before the submit frame even leaves the socket.
        args_ref = None
        if num_returns not in ("streaming", 0):
            args_ref, payload, buffers = serialization.maybe_offload_args(
                rt, payload, buffers)
        streaming = num_returns == "streaming"
        if streaming:
            # Generator task (parity: num_returns="streaming"): yields
            # stream back one at a time; no fixed return ids. Retries are
            # off — a half-streamed task must not silently replay. Workers
            # consume the stream through head-side stream_next RPCs.
            num_returns = 0
        _tracing = _tracing_mod()
        trace_ctx = _tracing.inject_context() if _tracing._enabled else None
        rnd = random_bytes(16 + 16 * num_returns)
        task_id = TaskID(rnd[:16])
        return_ids = [rnd[16 + 16 * i : 32 + 16 * i]
                      for i in range(num_returns)]
        max_retries = (0 if streaming else opts.get(
            "max_retries", get_config().task_max_retries_default))
        spec = TaskSpec(
            task_id=task_id.binary(),
            fn_id=fn_id,
            name=self.__name__,
            payload=payload,
            buffers=buffers,
            return_ids=return_ids,
            num_cpus=opts.get("num_cpus", 1),
            num_gpus=opts.get("num_gpus", 0),
            resources=opts.get("resources"),
            max_retries=max_retries,
            retries_left=max_retries,
            scheduling_strategy=opts.get("scheduling_strategy"),
            dependencies=([r.id.binary() for r in refs]
                          + ([args_ref] if args_ref else [])),
            trace_ctx=trace_ctx,
            streaming=streaming,
            runtime_env=opts.get("runtime_env"),
            idempotent=bool(opts.get("idempotent", False)),
            args_ref=args_ref,
            job_id=current_job_id(opts, rt),
        )
        if isinstance(rt, Runtime):
            rt.submit_task(spec, fn_blob)
        else:
            if os.getpid() not in self._exported_in:
                rt.send(("export_fn", fn_id, fn_blob))
                self._exported_in.add(os.getpid())
            if args_ref is not None:
                # The put-time local ref releases when the returns resolve.
                rt.pin_call_deps(spec, held_oids=[args_ref])
            rt.submit(spec)
        if streaming:
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(task_id.binary(), rt)
        out = [ObjectRef(ObjectID(rid)) for rid in return_ids]
        return out[0] if num_returns == 1 else out


def _promote_large(rt, value):
    """ray.put large array-like args implicitly (parity: remote_function.py
    inlines <100KB, ray.put's the rest)."""
    if isinstance(value, ObjectRef):
        return value
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, (int, float)) and nbytes > _LARGE_ARG_THRESHOLD:
        return rt.put(value)
    return value
