"""Public API: init/shutdown, @remote, get/put/wait, actors, introspection.

Parity: reference `python/ray/_private/worker.py` (ray.init:1285, get:2684,
put:2820, wait:2885, shutdown:1901) and the `@ray.remote` entry points.
"""

from __future__ import annotations

import inspect

from ray_tpu_torch.core.actor import ActorClass, ActorHandle, method  # noqa: F401
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.status import RayTpuError


def init(address=None, *, num_cpus=None, num_gpus=None, resources=None,
         object_store_memory=None, _system_config=None, ignore_reinit_error=True,
         **_ignored):
    """Boot the head runtime in this process (driver), or — with
    `address="host:port"` — connect this process as a remote client driver
    (parity: ray.init("ray://...") client mode)."""
    from ray_tpu_torch.core import runtime as rt_mod
    if address is not None:
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        if rt_mod.current_runtime() is not None:
            if ignore_reinit_error:
                return rt_mod.current_runtime()
            raise RayTpuError("ray_tpu_torch.init() called twice")
        raise NotImplementedError(
            "client mode (init(address=...)) reaches a head on another "
            "host: the PyTorch port's multi-node slice (ROADMAP queue 1 "
            "item 6, what was left out); not ported yet")
    if rt_mod._runtime is not None:
        if ignore_reinit_error:
            return rt_mod._runtime
        raise RayTpuError("ray_tpu_torch.init() called twice")
    return rt_mod.init_runtime(
        num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
        object_store_memory=object_store_memory, system_config=_system_config)


def shutdown():
    from ray_tpu_torch.core import runtime as rt_mod
    rt_mod.shutdown_runtime()


def is_initialized() -> bool:
    from ray_tpu_torch.core.runtime import current_runtime
    return current_runtime() is not None


def remote(*args, **options):
    """@remote decorator for functions (tasks) and classes (actors).
    `language="cpp"` (a C++ worker's native symbol) raises: not ported."""
    def decorate(obj):
        if options.get("language") == "cpp":
            _no_cpp_worker()
        if inspect.isclass(obj):
            return ActorClass(obj, **options)
        return RemoteFunction(obj, **options)

    if len(args) == 1 and not options and (inspect.isfunction(args[0])
                                           or inspect.isclass(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate


def cpp_function(symbol: str, **options):
    """Handle for a native function of the C++ worker runtime: raises,
    the C++ worker is not ported."""
    _no_cpp_worker()


def _no_cpp_worker():
    raise NotImplementedError(
        "language='cpp' tasks run on the C++ worker (cpp/raytpu_worker.cc), "
        "which node agents spawn: the PyTorch port's multi-node slice "
        "(ROADMAP queue 1 item 6, what was left out); not ported yet")


def get(refs, *, timeout=None):
    from ray_tpu_torch.core.runtime import get_runtime
    if isinstance(refs, list):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"get() takes ObjectRefs, got {type(bad[0])}")
    elif not isinstance(refs, ObjectRef):
        raise TypeError(f"get() takes an ObjectRef or list, got {type(refs)}")
    return get_runtime().get(refs, timeout=timeout)


def put(value):
    from ray_tpu_torch.core.runtime import get_runtime
    return get_runtime().put(value)


def wait(refs, *, num_returns=1, timeout=None):
    from ray_tpu_torch.core.runtime import get_runtime
    return get_runtime().wait(refs, num_returns=num_returns, timeout=timeout)


def cancel(ref, *, force: bool = False) -> bool:
    """Cancel the task behind `ref` (parity: ray.cancel). Queued tasks fail
    with TaskCancelledError; running tasks are only interrupted with
    force=True. Accepts an ObjectRef or an ObjectRefGenerator (streaming
    tasks resolve by task id). Returns whether a cancellation took effect."""
    from ray_tpu_torch.core.object_ref import ObjectRefGenerator
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    key = (ref._task_id if isinstance(ref, ObjectRefGenerator)
           else ref.id.binary())
    if isinstance(rt, Runtime):
        return rt.cancel_task(key, force=force)
    return rt.request("cancel", (key, force))


def kill(actor: ActorHandle, *, no_restart=True):
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        rt.kill_actor_by_id(actor._actor_id, no_restart=no_restart)
    else:
        rt.request("kill_actor", actor._actor_id)


def get_actor(name: str) -> ActorHandle:
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        aid = rt.named_actors.get(name)
        if aid is None:
            raise ValueError(f"no actor named {name!r}")
        st = rt.actors[aid]
        return ActorHandle(aid, name, st.cspec.methods_meta or {})
    resp = rt.request("get_actor", name)
    if resp is None:
        raise ValueError(f"no actor named {name!r}")
    aid, _ = resp
    # methods meta travels with the head's record; ask for a full handle
    meta = rt.request("actor_methods", aid)
    return ActorHandle(aid, name, meta or {})


def cluster_resources() -> dict:
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return rt.cluster_resources()
    return rt.request("cluster_resources")


def available_resources() -> dict:
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return rt.available_resources()
    return rt.request("available_resources")


def nodes() -> list:
    """The cluster node table (parity: ray.nodes())."""
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return rt.nodes_table()
    return rt.request("nodes")


def get_node_id() -> str:
    """Hex id of the node this process runs on (parity:
    ray.get_runtime_context().get_node_id())."""
    import os

    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    env = os.environ.get("RAY_TPU_TORCH_NODE_ID")
    if env:
        return env
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return rt.head_node_id.hex()
    # Head-node worker (spawned before multi-node was enabled).
    return ""


def timeline(filename: str | None = None):
    """Chrome/Perfetto trace of the cluster's task-event pipeline
    (parity: ray.timeline(), _private/state.py:965): one row per worker
    (B/E-paired exec phases with deserialize-args / execute /
    store-outputs sub-spans), per-node lease and spill rows, the head's
    scheduler row, lease-spill hops as flow arrows, and TensorChannel /
    objxfer transfer spans. With `filename`, the trace JSON is also
    written there (load via chrome://tracing or ui.perfetto.dev)."""
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if not isinstance(rt, Runtime):
        raise RayTpuError("timeline() is head-only")
    rt.sync_task_store()
    trace = rt.task_store.chrome_trace()
    if filename is not None:
        import json
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
