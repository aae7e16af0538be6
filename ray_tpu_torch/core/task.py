"""Task specification shipped from submitter to executor.

Parity: reference `src/ray/common/task/task_spec.h` / `common.proto` TaskSpec.
Kept as a __slots__ class pickled whole — the single-node transport is pickle
frames, so a protobuf round trip would only add overhead.
"""

from __future__ import annotations


class TaskSpec:
    __slots__ = (
        "task_id",        # bytes
        "fn_id",          # bytes (sha of cloudpickled fn / class)
        "name",           # human-readable
        "payload",        # pickled (args, kwargs)
        "buffers",        # out-of-band buffers
        "inline_deps",    # {oid_bytes: (payload, buffers)} values only the owner had
        "return_ids",     # [bytes]
        "num_cpus",
        "num_gpus",
        "resources",      # {name: amount}
        "max_retries",
        "retries_left",
        "actor_id",       # bytes | None — actor task if set
        "method_name",    # str | None
        "seq_no",         # per-actor submission order
        "owner",          # worker_id bytes of submitter (None = driver)
        "scheduling_strategy",
        "dependencies",   # [oid_bytes] that must be ready before dispatch
        "runtime_env",    # {"env_vars": {...}, "working_dir": str,
                          #  "py_modules": [str]} | None
        "trace_ctx",      # W3C traceparent carrier dict | None (tracing)
        "streaming",      # True = generator task (num_returns="streaming")
        "caller_seq",     # per-(caller, actor) submission index; stamped by
                          # workers that may mix the direct agent<->agent
                          # path with the head relay, enforced at the
                          # executing node's agent (parity: the sequence
                          # numbers of actor_task_submitter.h:78)
        "idempotent",     # user-declared: safe to re-execute without a
                          # failure; opts into the one-phase steal fast path
        "payload_format",  # None/"pickle" | "proto" (language-neutral
                           # TaskArgs payload — proto_wire.decode_task_args)
        "args_ref",        # oid bytes | None — large pickle-5 arg buffers
                           # shipped through the shm arena as one ArgPack
                           # object instead of riding the socket frame
                           # (serialization.maybe_offload_args); always
                           # also listed in `dependencies` so the head
                           # gates dispatch on it and frees it after the
                           # final completion
        "spill_hops",      # int | None — agent->agent lease-spillback hops
                           # taken so far; capped by lease_spill_max_hops
                           # so a lease cannot ping-pong between loaded
                           # agents (parity: the spillback hop guard of
                           # cluster_task_manager.cc:187)
        "lease_seq",       # int | None — head-side lease grant generation,
                           # bumped on every (re)grant. Spill/return notices
                           # echo it so the head can ignore stale frames
                           # that name a PREVIOUS grant of the same task —
                           # acting on one would re-point or re-enqueue a
                           # live lease (duplicate execution / lost replay)
        "language",        # None/"python" | "cpp" — which worker runtime
                           # executes this task. cpp tasks address a native
                           # symbol by `name`, carry a language-neutral
                           # TaskArgs payload (payload_format="proto"), and
                           # are dispatched agent-side onto a C++ worker
                           # over the protobuf worker plane (no pickle on
                           # any frame the executing worker reads/writes)
        "exec_ts",         # worker-local scratch: [exec_start, args_ready,
                           # exec_done] wall stamps collected during
                           # execution, packed into ONE task event at
                           # output seal (core/task_events.py EXEC_SPANS —
                           # per-point emits churned enough allocations to
                           # move the task storm). Never meaningful on the
                           # wire: the executing worker is the last
                           # process to hold the spec.
        "job_id",          # str | None — owning tenant (core/jobs.py
                           # ledger key; None reads as the default driver
                           # job). Quota admission and weighted-DRF
                           # fair-share order key on it at the head's
                           # grant loop. Appended LAST on purpose:
                           # _from_tuple backfills missing trailing slots
                           # with None, so old journals and old peers
                           # stay readable (raytpu.proto field 22).
        "gpu_ids",         # tuple[str] | None — the GPU device ids the
                           # head assigned a num_gpus > 0 task (set at
                           # dispatch; the worker puts them in
                           # CUDA_VISIBLE_DEVICES). Appended last, as
                           # job_id, for the same backfill.
    )

    # __init__ is generated below with one STORE_ATTR per slot: the
    # setattr-per-slot loop was ~75% of TaskSpec construction cost, and a
    # spec is built on every submit (the head's hottest per-task work
    # after the lease plane went native).

    def __reduce__(self):
        return (TaskSpec._from_tuple, (tuple(getattr(self, s) for s in self.__slots__),))

    @staticmethod
    def _from_tuple(t):
        obj = TaskSpec.__new__(TaskSpec)
        for s, v in zip(TaskSpec.__slots__, t):
            object.__setattr__(obj, s, v)
        # Slots appended after `t` was pickled (old journal/peer): leave
        # them None rather than unset — __reduce__ reads every slot.
        for s in TaskSpec.__slots__[len(t):]:
            object.__setattr__(obj, s, None)
        return obj

    def describe(self) -> str:
        if self.actor_id is not None:
            return f"{self.name}.{self.method_name}"
        return self.name or "task"


def _gen_taskspec_init():
    args = ", ".join(f"{s}=None" for s in TaskSpec.__slots__)
    body = "\n".join(f"    self.{s} = {s}" for s in TaskSpec.__slots__)
    src = (f"def __init__(self, {args}):\n{body}\n"
           "    if resources is None:\n"
           "        self.resources = {}\n"
           "    if inline_deps is None:\n"
           "        self.inline_deps = {}\n")
    ns: dict = {}
    exec(src, ns)  # noqa: S102 — static template over __slots__
    return ns["__init__"]


TaskSpec.__init__ = _gen_taskspec_init()


class ActorCreationSpec:
    """Constructor spec kept by the control plane for restarts.

    Parity: `gcs_actor_manager.h:328` (GCS owns the actor lifecycle FSM and
    replays creation on restart).
    """

    __slots__ = ("actor_id", "cls_id", "cls_blob", "name", "payload", "buffers",
                 "max_restarts", "restarts_used", "max_concurrency", "is_async",
                 "num_cpus", "num_gpus", "resources", "max_task_retries",
                 "placement_group_id", "bundle_index", "runtime_env",
                 "dependencies", "methods_meta", "scheduling_strategy",
                 "job_id", "gpu_ids")

    def __init__(self, **kw):
        for s in self.__slots__:
            setattr(self, s, kw.get(s))
        if self.resources is None:
            self.resources = {}
        self.restarts_used = self.restarts_used or 0
