"""Argument/value serialization with ObjectRef capture.

Parity: reference `python/ray/_private/serialization.py` (SerializationContext):
pickle-5 for values, cloudpickle for functions/classes, and ObjectRefs found
anywhere inside a value are recorded so the submitter can (a) wait on them as
dependencies and (b) ship inline values for refs that only exist in the
owner's in-process memory store.
"""

from __future__ import annotations

import hashlib
import io
import pickle

try:
    import cloudpickle
except ImportError:  # functions and classes then pickle by reference
    cloudpickle = None

from ray_tpu_torch.core.object_ref import ObjectRef


def dumps_code(obj) -> bytes:
    """Pickle a function, class or object holding code: by value through
    cloudpickle where it is installed (closures and lambdas included),
    else by reference, which takes importable module-level ones only (the
    host's other processes import them by name)."""
    if cloudpickle is not None:
        return cloudpickle.dumps(obj)
    return pickle.dumps(obj, protocol=5)


class _CollectingPickler(cloudpickle.Pickler if cloudpickle is not None
                         else pickle.Pickler):
    """Pickles a value while recording every ObjectRef inside it.

    cloudpickle-based so closures/lambdas inside task args serialize (the
    reference routes all task payloads through cloudpickle too) — the Data
    library passes UDFs as plain arguments.
    """

    def __init__(self, file, buffer_callback=None):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self.contained_refs: list[ObjectRef] = []

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            self.contained_refs.append(obj)
            return obj.__reduce__()
        return super().reducer_override(obj)


# Hot-path constant: argless calls (actor pings, nullary tasks) skip the
# cloudpickle machinery entirely.
_EMPTY_ARGS_PAYLOAD = pickle.dumps(((), {}), protocol=5)

# Exact builtin scalars only (type(), not isinstance: a subclass may carry
# custom reduce behavior cloudpickle would honor). For these the C pickler
# and cloudpickle produce identical streams, there can be no ObjectRefs
# inside, and nothing goes out-of-band — so the per-call CloudPickler
# construction (a measured ~30% of the driver's submit cost on the nop
# storm) is pure overhead.
_SCALARS = frozenset((int, float, str, bytes, bool, type(None)))


def serialize_args(args, kwargs):
    """Returns (payload_bytes, buffers, contained_refs)."""
    if not args and not kwargs:
        return _EMPTY_ARGS_PAYLOAD, [], []
    scalars = _SCALARS
    if (all(type(a) in scalars for a in args)
            and (not kwargs
                 or all(type(v) in scalars for v in kwargs.values()))):
        return pickle.dumps((args, kwargs), protocol=5), [], []
    buffers: list[pickle.PickleBuffer] = []
    f = io.BytesIO()
    p = _CollectingPickler(f, buffer_callback=buffers.append)
    p.dump((args, kwargs))
    return f.getvalue(), [b.raw() for b in buffers], p.contained_refs


_NONE_PAYLOAD = pickle.dumps(None, protocol=5)


def serialize_value(value):
    """Returns (payload_bytes, buffers, contained_refs)."""
    if value is None:
        return _NONE_PAYLOAD, [], []
    buffers: list[pickle.PickleBuffer] = []
    f = io.BytesIO()
    p = _CollectingPickler(f, buffer_callback=buffers.append)
    p.dump(value)
    return f.getvalue(), [b.raw() for b in buffers], p.contained_refs


def deserialize(payload: bytes, buffers=()):
    return pickle.loads(payload, buffers=buffers)


class ArgPack:
    """A task's pickled (args, kwargs) stream plus its out-of-band buffers,
    stored as ONE shm object.

    __reduce_ex__ re-wraps the buffers as PickleBuffers, so put_serialized
    routes them out-of-band again: the arg bytes are copied exactly once
    (into the arena) and the executor maps them back zero-copy — the same
    treatment ray.put values get, now applied to call arguments (parity:
    the reference inlining <100KB args and shipping the rest via plasma,
    `python/ray/remote_function.py` + `core_worker` arg plumbing)."""

    __slots__ = ("payload", "buffers")

    def __init__(self, payload, *buffers):
        self.payload = payload
        self.buffers = list(buffers)

    def __reduce_ex__(self, protocol):
        return (ArgPack,
                (self.payload, *[pickle.PickleBuffer(b)
                                 for b in self.buffers]))

    def load(self):
        return deserialize(self.payload, self.buffers)


def maybe_offload_args(rt, payload, buffers):
    """Ship large pickle-5 arg buffers through the shm arena.

    Returns (args_oid | None, payload, buffers): when the out-of-band
    buffers exceed the configured threshold AND the runtime has a local
    store (head driver or worker — client-mode drivers don't), the whole
    (payload, buffers) pack is written to the arena once and the spec
    carries only a 16-byte ref; the socket frame stays small, and the
    head relay stops copying arg bytes twice. Below the threshold the
    inputs pass through untouched, keeping the small-arg latency floor."""
    if not buffers:
        return None, payload, buffers
    from ray_tpu_torch.core.config import get_config
    threshold = get_config().max_inline_arg_bytes
    if threshold <= 0:
        return None, payload, buffers
    total = sum(b.nbytes if isinstance(b, memoryview) else len(b)
                for b in buffers)
    if total < threshold:
        return None, payload, buffers
    put = getattr(rt, "put_arg_object", None)
    if put is None:
        return None, payload, buffers
    try:
        oid = put(ArgPack(payload, *buffers), total + len(payload))
    except Exception:  # noqa: BLE001 — arena pressure: fall back to inline
        return None, payload, buffers
    return oid, _EMPTY_ARGS_PAYLOAD, []


def serialize_function(fn) -> tuple[bytes, bytes]:
    """Returns (function_id, pickled). Deterministic id so workers cache."""
    blob = dumps_code(fn)
    return hashlib.sha256(blob).digest()[:16], blob


def total_nbytes(payload: bytes, buffers) -> int:
    return len(payload) + sum(len(b) for b in buffers)
