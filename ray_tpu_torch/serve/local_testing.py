"""Local testing mode: run a serve app in-process, no cluster
(counterpart of `ray_tpu/serve/local_testing.py`).

Parity: reference `python/ray/serve/_private/local_testing_mode.py` —
deployments instantiate directly in the test process, nested bound
deployments become local handles, and `.remote()` schedules onto a shared
background event loop so async deployments work unchanged.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import threading

from ray_tpu_torch.serve.deployment import Application, BoundDeployment

_loop: asyncio.AbstractEventLoop | None = None
_loop_lock = threading.Lock()


def _get_loop() -> asyncio.AbstractEventLoop:
    global _loop
    with _loop_lock:
        if _loop is None or _loop.is_closed():
            loop = asyncio.new_event_loop()
            threading.Thread(target=loop.run_forever, daemon=True,
                             name="serve-local-loop").start()
            _loop = loop
        return _loop


class LocalDeploymentResponse:
    def __init__(self, fut: concurrent.futures.Future):
        self._fut = fut

    def result(self, timeout_s: float | None = 60.0):
        return self._fut.result(timeout_s)

    def __await__(self):
        return asyncio.wrap_future(self._fut).__await__()


def _materialize(out, loop):
    """Match ReplicaActor.handle_request: generators stream back as lists
    so local-mode results equal cluster-mode results."""
    if inspect.isasyncgen(out):
        async def drain():
            return [x async for x in out]
        return asyncio.run_coroutine_threadsafe(drain(), loop).result()
    if inspect.isgenerator(out):
        return list(out)
    return out


class LocalDeploymentHandle:
    """DeploymentHandle-alike over an in-process instance."""

    def __init__(self, target, method_name: str | None = None,
                 model_id: str = ""):
        self._target = target
        self._method = method_name
        self._model_id = model_id

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return LocalDeploymentHandle(self._target, item, self._model_id)

    def options(self, method_name: str | None = None, *,
                multiplexed_model_id: str | None = None, **_ignored):
        return LocalDeploymentHandle(
            self._target, method_name or self._method,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id)

    def remote(self, *args, **kwargs) -> LocalDeploymentResponse:
        from ray_tpu_torch.serve.multiplex import _current_model_id
        fn = (getattr(self._target, self._method) if self._method
              else self._target)
        loop = _get_loop()
        model_id = self._model_id
        if inspect.iscoroutinefunction(fn):
            async def run_async():
                token = _current_model_id.set(model_id)
                try:
                    out = await fn(*args, **kwargs)
                    # Same materialization as the sync path — but inline:
                    # _materialize's .result() would deadlock ON the loop.
                    if inspect.isasyncgen(out):
                        return [x async for x in out]
                    if inspect.isgenerator(out):
                        return list(out)
                    return out
                finally:
                    _current_model_id.reset(token)
            fut = asyncio.run_coroutine_threadsafe(run_async(), loop)
        else:
            fut = concurrent.futures.Future()

            def call():
                token = _current_model_id.set(model_id)
                try:
                    out = fn(*args, **kwargs)
                    if inspect.iscoroutine(out):
                        # sync wrapper returning a coroutine
                        out = asyncio.run_coroutine_threadsafe(
                            out, loop).result()
                    fut.set_result(_materialize(out, loop))
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)
                finally:
                    _current_model_id.reset(token)

            threading.Thread(target=call, daemon=True).start()
        return LocalDeploymentResponse(fut)


def run_local(app: Application) -> LocalDeploymentHandle:
    """Instantiate the app graph in-process; returns the ingress handle."""
    memo: dict[int, LocalDeploymentHandle] = {}

    def build(bound: BoundDeployment) -> LocalDeploymentHandle:
        if id(bound) in memo:
            return memo[id(bound)]

        def swap(v):
            if isinstance(v, Application):
                return build(v.root)
            if isinstance(v, BoundDeployment):
                return build(v)
            return v

        args = tuple(swap(a) for a in bound.init_args)
        kwargs = {k: swap(v) for k, v in bound.init_kwargs.items()}
        target = bound.deployment.func_or_class
        if inspect.isclass(target):
            target = target(*args, **kwargs)
        user_config = bound.deployment.config.user_config
        if user_config is not None:
            # Same contract as ReplicaActor._apply_user_config — function
            # deployments must fail here too, not only at real deploy time.
            if not hasattr(target, "reconfigure"):
                raise ValueError(
                    f"deployment {bound.name} got user_config but "
                    f"defines no reconfigure()")
            target.reconfigure(user_config)
        handle = LocalDeploymentHandle(target)
        memo[id(bound)] = handle
        return handle

    return build(app.root)
