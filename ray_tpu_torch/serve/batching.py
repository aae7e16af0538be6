"""@serve.batch — adaptive request batching inside a replica
(counterpart of `ray_tpu/serve/batching.py`).

Parity: reference `python/ray/serve/batching.py` (_BatchQueue + @serve.batch):
decorated async method receives a list of requests; individual callers each
get their own element of the returned list back.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import threading


class _BatchQueue:
    """One batched callable's pending calls. A replica's async actor runs
    its coroutines on several event loops (the runtime's executor shards,
    one thread each), so the queue is shared across threads: its state
    sits under a lock, each caller's future is settled on the caller's own
    loop, and a batch whose wait ran out is flushed by the call that armed
    the timer, unless a full batch took its calls first."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.queue: list = []          # [(args_tuple, future)]
        self._lock = threading.Lock()
        self._gen = 0                  # batches taken so far
        self._armed = False            # a timed flush waits for _gen
        self._timers: set = set()      # the timed flushes' tasks

    async def submit(self, instance, args, kwargs):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        batch, arm = None, None
        with self._lock:
            self.queue.append(((instance, args, kwargs), fut))
            if len(self.queue) >= self.max_batch_size:
                batch = self._take()
            elif not self._armed:
                self._armed, arm = True, self._gen
        if arm is not None:
            task = loop.create_task(self._timed_flush(arm))
            self._timers.add(task)
            task.add_done_callback(self._timers.discard)
        if batch:
            await self._run(batch)
        return await fut

    def _take(self) -> list:
        """The queued calls as one batch (the caller holds the lock)."""
        batch, self.queue = self.queue, []
        self._gen += 1
        self._armed = False
        return batch

    async def _timed_flush(self, gen: int):
        await asyncio.sleep(self.batch_wait_timeout_s)
        with self._lock:
            if gen != self._gen:
                return  # a full batch already took these calls
            batch = self._take()
        await self._run(batch)

    @staticmethod
    def _settle(fut, result=None, exc=None):
        def settle():
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        fut.get_loop().call_soon_threadsafe(settle)

    async def _run(self, batch):
        if not batch:
            return
        (instance, args0, kwargs0), _ = batch[0]
        try:
            # Each positional/keyword parameter becomes a list across the
            # batch; all calls in a batch must share the same shape.
            arg_lists = [[] for _ in args0]
            kw_lists = {k: [] for k in kwargs0}
            for (inst, args, kwargs), _fut in batch:
                if len(args) != len(arg_lists) or set(kwargs) != set(kw_lists):
                    raise TypeError(
                        "@serve.batch calls in one batch must pass the same "
                        f"parameters; got {len(args)} positional/"
                        f"{sorted(kwargs)} vs {len(arg_lists)}/"
                        f"{sorted(kw_lists)}")
                for i, a in enumerate(args):
                    arg_lists[i].append(a)
                for k, v in kwargs.items():
                    kw_lists[k].append(v)
            if instance is not None:
                out = self.fn(instance, *arg_lists, **kw_lists)
            else:
                out = self.fn(*arg_lists, **kw_lists)
            if inspect.iscoroutine(out):
                out = await out
            if not isinstance(out, list) or len(out) != len(batch):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(batch)} results, got {type(out).__name__}")
            for (_, fut), res in zip(batch, out):
                self._settle(fut, result=res)
        except Exception as e:
            for _, fut in batch:
                self._settle(fut, exc=e)


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: batch concurrent calls into one list-in/list-out call."""

    def wrap(fn):
        queues: dict = {}  # instance id -> _BatchQueue

        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")

        sig = inspect.signature(fn)
        is_method = list(sig.parameters) and list(sig.parameters)[0] == "self"

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            if is_method:
                instance, call_args = args[0], args[1:]
            else:
                instance, call_args = None, args
            q = queues.get(id(instance))
            if q is None:  # setdefault: one queue however many loops race
                q = queues.setdefault(id(instance), _BatchQueue(
                    fn, max_batch_size, batch_wait_timeout_s))
            return await q.submit(instance if is_method else None,
                                  call_args, kwargs)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
