"""ActorPool: round-robin work distribution over a fixed set of actors.

Parity: reference `python/ray/util/actor_pool.py` (map/map_unordered/
submit/get_next/get_next_unordered/has_next/push/pop_idle).
"""

from __future__ import annotations

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = []

    def submit(self, fn, value):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def _return_actor(self, actor):
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def get_next(self, timeout=None):
        if not self.has_next():
            raise StopIteration("no more results to get")
        if self._next_return_index >= self._next_task_index:
            raise ValueError("It is not allowed to call get_next() after "
                             "get_next_unordered().")
        future = self._index_to_future[self._next_return_index]
        if timeout is not None:
            # Probe first: a timeout must leave the pool untouched so the
            # caller can retry (mutating before the get would lose the result
            # and hand the still-busy actor back to the idle list).
            ready, _ = ray_tpu_torch.wait([future], timeout=timeout)
            if not ready:
                from ray_tpu_torch.core.status import GetTimeoutError
                raise GetTimeoutError(
                    f"get_next timed out after {timeout}s")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout=None):
        if not self.has_next():
            raise StopIteration("no more results to get")
        ready, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            from ray_tpu_torch.core.status import GetTimeoutError
            raise GetTimeoutError("timed out waiting for a result")
        future = ready[0]
        i, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(i, None)
        self._next_return_index = max(self._next_return_index, i + 1)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def map(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor):
        busy = {a for _, a in self._future_to_actor.values()}
        if actor in self._idle or actor in busy:
            raise ValueError("Actor already belongs to current ActorPool")
        self._return_actor(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
