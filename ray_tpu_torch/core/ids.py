"""Unique identifiers for jobs, tasks, actors, objects, nodes, and workers.

Parity: reference `src/ray/common/id.h` (JobID/TaskID/ActorID/ObjectID/NodeID).
Unlike the reference's structured 28-byte ObjectIDs (task id + index), we use flat
random 16-byte ids plus an explicit owner field on the ref — ownership metadata
lives with the owner process (NSDI'21 ownership model), not packed into the id.
"""

from __future__ import annotations

import os
import threading

_ID_SIZE = 16


class _RandomPool:
    """Buffered CSPRNG bytes: one os.urandom syscall amortizes ~1000 ids.
    Forked children must not replay the parent's pool, so the buffer is
    keyed by pid (workers fork from the zygote)."""

    __slots__ = ("buf", "pos", "pid", "lock")

    def __init__(self):
        self.buf = b""
        self.pos = 0
        self.pid = -1
        self.lock = threading.Lock()

    def take(self, n: int) -> bytes:
        with self.lock:
            pid = os.getpid()
            if pid != self.pid or self.pos + n > len(self.buf):
                self.buf = os.urandom(max(1 << 14, n))
                self.pos = 0
                self.pid = pid
            out = self.buf[self.pos:self.pos + n]
            self.pos += n
            return out


_random_pool = _RandomPool()


def random_bytes(n: int) -> bytes:
    return _random_pool.take(n)


class BaseID:
    """A fixed-size binary id with hex repr. Immutable and hashable."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != _ID_SIZE:
            raise ValueError(f"expected {_ID_SIZE} bytes, got {len(binary)}")
        self._bytes = binary
        self._hash = hash(binary)

    @classmethod
    def from_random(cls):
        return cls(random_bytes(_ID_SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_SIZE)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    __slots__ = ()


class TaskID(BaseID):
    __slots__ = ()


class ActorID(BaseID):
    __slots__ = ()


class ObjectID(BaseID):
    __slots__ = ()


class NodeID(BaseID):
    __slots__ = ()


class WorkerID(BaseID):
    __slots__ = ()


class PlacementGroupID(BaseID):
    __slots__ = ()


_counter_lock = threading.Lock()
_counters: dict[str, int] = {}


def sequential_id(cls, namespace: bytes):
    """Deterministic per-namespace sequential ids (used for task attempt ids /
    object return ids so retries map to the same object id)."""
    with _counter_lock:
        key = (cls.__name__, namespace)
        n = _counters.get(key, 0)
        _counters[key] = n + 1
    payload = namespace[: _ID_SIZE - 4] + n.to_bytes(4, "little")
    return cls(payload.ljust(_ID_SIZE, b"\x00"))
