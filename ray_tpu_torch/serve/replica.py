"""Replica actor: wraps the user's deployment callable (counterpart of
`ray_tpu/serve/replica.py`).

Parity: reference `python/ray/serve/_private/replica.py:841` (Replica actor
wrapping the user callable, queue-length reporting, reconfigure, health
check). One async actor per replica; concurrency is bounded by
`max_ongoing_requests` via the actor's asyncio concurrency.
"""

from __future__ import annotations

import asyncio
import inspect
import time


class ReplicaActor:
    """Generic replica body. The controller creates one per replica with the
    pickled deployment definition as init args."""

    def __init__(self, deployment_def, init_args, init_kwargs, user_config,
                 deployment_name: str, replica_id: str):
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        self._num_ongoing = 0
        self._num_total = 0
        if inspect.isclass(deployment_def):
            self._callable = deployment_def(*init_args, **init_kwargs)
        else:
            # Function deployment: the "instance" is the function itself.
            self._callable = deployment_def
        self._is_function = not inspect.isclass(deployment_def)
        if user_config is not None:
            self._apply_user_config(user_config)
        self._started_at = time.time()

    def _apply_user_config(self, user_config):
        recon = getattr(self._callable, "reconfigure", None)
        if recon is None:
            raise ValueError(
                f"deployment {self._deployment_name} got user_config but the "
                "class defines no reconfigure(user_config) method")
        recon(user_config)

    async def handle_request(self, method_name, args, kwargs,
                             multiplexed_model_id: str = ""):
        """Single request entry. Counts ongoing for pow-2 probes/autoscaling."""
        from ray_tpu_torch.serve.multiplex import _current_model_id
        self._num_ongoing += 1
        self._num_total += 1
        token = _current_model_id.set(multiplexed_model_id)
        try:
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, method_name or "__call__")
            out = target(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            if inspect.isgenerator(out):
                out = list(out)  # materialize streaming responses
            elif inspect.isasyncgen(out):
                out = [x async for x in out]
            return out
        finally:
            _current_model_id.reset(token)
            self._num_ongoing -= 1

    def handle_streaming_request(self, method_name, args, kwargs,
                                 multiplexed_model_id: str = ""):
        """Streaming entry: each item the user's (async) generator yields
        becomes one stream item (parity: the reference replica's generator
        path feeding the proxy, serve/_private/proxy.py:420). Declared as a
        sync generator — the worker runs it in an executor thread next to
        the replica's asyncio loop; async generators are driven through a
        private event loop in that thread."""
        import asyncio as _asyncio

        from ray_tpu_torch.serve.multiplex import _current_model_id
        self._num_ongoing += 1
        self._num_total += 1
        token = _current_model_id.set(multiplexed_model_id)
        try:
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, method_name or "__call__")
            out = target(*args, **kwargs)
            if inspect.iscoroutine(out):
                loop = _asyncio.new_event_loop()
                try:
                    out = loop.run_until_complete(out)
                finally:
                    loop.close()
            if inspect.isgenerator(out):
                yield from out
            elif inspect.isasyncgen(out):
                loop = _asyncio.new_event_loop()
                try:
                    while True:
                        try:
                            yield loop.run_until_complete(out.__anext__())
                        except StopAsyncIteration:
                            break
                finally:
                    loop.close()
            else:
                yield out
        finally:
            _current_model_id.reset(token)
            self._num_ongoing -= 1

    async def reconfigure(self, user_config):
        self._apply_user_config(user_config)

    async def get_queue_len(self) -> int:
        return self._num_ongoing

    async def get_metrics(self) -> dict:
        return {
            "replica_id": self._replica_id,
            "num_ongoing_requests": self._num_ongoing,
            "num_total_requests": self._num_total,
            "uptime_s": time.time() - self._started_at,
        }

    async def check_health(self):
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None:
            out = user_check()
            if inspect.iscoroutine(out):
                await out
        return "ok"

    async def prepare_shutdown(self, timeout_s: float):
        """Drain: wait for ongoing requests to finish (graceful shutdown)."""
        deadline = time.monotonic() + timeout_s
        while self._num_ongoing > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return self._num_ongoing == 0
