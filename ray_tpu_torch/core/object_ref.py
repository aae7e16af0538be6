"""ObjectRef: a first-class future/handle for a value in the object plane.

Parity: reference `python/ray/_raylet.pyx:280` (ObjectRef) and the ownership
model of `src/ray/core_worker/reference_count.h:72` — every ref carries its
owner's address; the owner stores the value (inline in its in-process memory
store or in the node's shm store) and runs the reference count.
"""

from __future__ import annotations

from ray_tpu_torch.core.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner", "_weak")

    def __init__(self, object_id: ObjectID, owner=None, _add_ref: bool = True):
        self.id = object_id
        self.owner = owner  # worker-id bytes of the owner, None = local driver
        self._weak = not _add_ref
        if _add_ref:
            from ray_tpu_torch.core.runtime import current_runtime
            rt = current_runtime()
            if rt is not None:
                rt.refcount.add_local_ref(object_id)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def future(self):
        """concurrent.futures-style Future for this ref (asyncio interop)."""
        from ray_tpu_torch.core.runtime import get_runtime
        return get_runtime().as_future(self)

    def __await__(self):
        import asyncio
        from ray_tpu_torch.core.runtime import get_runtime
        fut = asyncio.wrap_future(get_runtime().as_future(self))
        return fut.__await__()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]})"

    def __del__(self):
        if not self._weak:
            try:
                from ray_tpu_torch.core.runtime import current_runtime
                rt = current_runtime()
                if rt is not None:
                    rt.refcount.remove_local_ref(self.id)
            except Exception:
                pass

    def __reduce__(self):
        # Crossing a process boundary: the receiver becomes a borrower; it
        # reconstructs a weak ref and resolves the value through the shm store
        # (or the inline-deps table shipped with the task). An owned ref that
        # escapes this way must never be eagerly freed by its owner again.
        try:
            from ray_tpu_torch.core.runtime import current_runtime
            rt = current_runtime()
            mark = getattr(getattr(rt, "refcount", None), "mark_escaped", None)
            if mark is not None:
                mark(self.id)
        except Exception:  # noqa: BLE001 — marking is safety, not liveness
            pass
        return (_deserialize_ref, (self.id.binary(), self.owner))


def _deserialize_ref(id_bytes: bytes, owner):
    return ObjectRef(ObjectID(id_bytes), owner, _add_ref=False)


class ObjectRefGenerator:
    """Iterator over a streaming task's yields.

    Parity: reference `python/ray/_raylet.pyx:280,295` (ObjectRefGenerator
    for `num_returns="streaming"` tasks): each `next()` blocks until the
    executing task yields its next value and returns an ObjectRef for it;
    iteration ends when the task returns (StopIteration) and re-raises the
    task's error if it failed mid-stream."""

    def __init__(self, task_id: bytes, runtime):
        self._task_id = task_id
        self._rt = runtime
        self._next_idx = 0
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        if self._closed:
            raise StopIteration
        rid = self._rt.next_stream_item(self._task_id, self._next_idx)
        if rid is None:
            self._closed = True
            raise StopIteration
        self._next_idx += 1
        return ObjectRef(ObjectID(rid), _add_ref=False)

    def completed(self) -> bool:
        return self._rt.stream_finished(self._task_id)

    def close(self):
        """Release the stream: unconsumed/future yields are discarded and
        the producing task is cancelled best-effort. Called automatically
        when the generator is garbage-collected."""
        if self._closed:
            return
        self._closed = True
        try:
            self._rt.release_stream(self._task_id)
        except Exception:  # noqa: BLE001 — cleanup must not raise
            pass

    def __del__(self):
        self.close()

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:12]})"
