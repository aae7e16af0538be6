"""@serve.multiplexed — per-replica LRU cache of per-model state
(counterpart of `ray_tpu/serve/multiplex.py`).

Parity: reference `python/ray/serve/multiplex.py` (_ModelMultiplexWrapper):
a decorated async loader caches up to max_num_models_per_replica models,
evicting least-recently-used (calling the model's __del__/unload if any).
"""

from __future__ import annotations

import collections
import functools
import inspect


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    def wrap(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async def loader")

        caches: dict = {}  # instance id -> OrderedDict(model_id -> model)

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                instance, model_id = args
            elif len(args) == 1:
                instance, model_id = None, args[0]
            else:
                raise TypeError(
                    "@serve.multiplexed loader takes (self, model_id) or "
                    "(model_id)")
            cache = caches.setdefault(id(instance), collections.OrderedDict())
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = await (fn(instance, model_id) if instance is not None
                           else fn(model_id))
            cache[model_id] = model
            cache.move_to_end(model_id)
            while len(cache) > max_num_models_per_replica:
                _mid, evicted = cache.popitem(last=False)
                unload = getattr(evicted, "unload", None)
                if callable(unload):
                    out = unload()
                    if inspect.iscoroutine(out):
                        await out
            return model

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


import contextvars

_current_model_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the current request, as set by
    handle.options(multiplexed_model_id=...) and threaded through the
    replica's handle_request (parity: serve.get_multiplexed_model_id)."""
    return _current_model_id.get()
