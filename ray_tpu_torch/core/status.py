"""Error hierarchy for the runtime.

Parity: reference `src/ray/common/status.h` (ray::Status codes) and
`python/ray/exceptions.py`. We use Python exceptions end-to-end rather than a
status-code struct: the runtime boundary is in-process or msgpack frames, so
exceptions serialize naturally with tracebacks.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RuntimeNotInitializedError(RayTpuError):
    def __init__(self, msg="ray_tpu_torch.init() must be called before this operation"):
        super().__init__(msg)


class ObjectStoreFullError(RayTpuError):
    pass


class ObjectExistsError(RayTpuError):
    """An arena create/seal named an object id the store already holds.

    Benign on the task-replay path: a restarted head re-grants any task
    whose node_done it never saw, and the re-executing worker re-seals a
    result the FIRST attempt already sealed — that seal must be treated
    as success (at-least-once execution, exactly-once publication)."""


class ObjectLostError(RayTpuError):
    def __init__(self, object_id, msg=""):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost{': ' + msg if msg else ''}")


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (parity:
    ray.exceptions.TaskCancelledError)."""


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task; re-raised at ray_tpu_torch.get()."""

    def __init__(self, cause: BaseException | None, tb_str: str, task_desc: str = ""):
        self.cause = cause
        self.tb_str = tb_str
        self.task_desc = task_desc
        super().__init__(f"Task {task_desc} failed:\n{tb_str}")

    @classmethod
    def from_exception(cls, exc: BaseException, task_desc: str = ""):
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(exc, tb, task_desc)

    def __reduce__(self):
        import pickle
        try:
            pickle.dumps(self.cause)
            cause = self.cause
        except Exception:
            cause = None  # unpicklable cause: keep the formatted traceback only
        return (TaskError, (cause, self.tb_str, self.task_desc))


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, msg="actor died"):
        self.actor_id = actor_id
        super().__init__(msg)


class ActorUnavailableError(RayTpuError):
    """Actor is temporarily unreachable (restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class PlacementGroupError(RayTpuError):
    pass


class ResourceError(RayTpuError):
    """Infeasible resource request."""


class OutOfMemoryError(RayTpuError):
    pass


class OverloadedError(RayTpuError):
    """A serving-plane admission controller shed this request (fast, loud
    backpressure instead of queue collapse). Retry later or elsewhere."""
