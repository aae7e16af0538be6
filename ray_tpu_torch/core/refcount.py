"""Owner-side reference counting.

Parity: reference `src/ray/core_worker/reference_count.h:72`. v1 scope: the
owner (driver/head) counts local ObjectRef handles and frees the object from
the directory + shm store when the count hits zero. Borrower counting across
workers is conservative: objects referenced by in-flight tasks are pinned
until the task completes (the dependency manager holds a ref for the task's
lifetime), and shm reads are protected by the store's own per-get refcount,
so a freed-while-reading race cannot corrupt a reader.
"""

from __future__ import annotations

import threading


class ReferenceCounter:
    def __init__(self, free_callback=None):
        self._counts: dict[bytes, int] = {}
        self._pins: dict[bytes, int] = {}   # task-lifetime pins
        self._deferred: set[bytes] = set()  # count hit 0 while pinned
        self._lock = threading.Lock()
        self._free_callback = free_callback

    def add_local_ref(self, object_id):
        key = object_id.binary()
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1

    def remove_local_ref(self, object_id):
        key = object_id.binary()
        free = False
        with self._lock:
            n = self._counts.get(key, 0) - 1
            if n <= 0:
                self._counts.pop(key, None)
                if key in self._pins:
                    # Free is deferred until the last pin drops; objects the
                    # owner never counted (worker-owned) are NOT freed by
                    # unpinning alone.
                    self._deferred.add(key)
                else:
                    free = True
            else:
                self._counts[key] = n
        if free and self._free_callback:
            self._free_callback(key)

    def is_pinned(self, key: bytes) -> bool:
        with self._lock:
            return key in self._pins

    def pin(self, key: bytes):
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: bytes):
        free = False
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
                if key in self._deferred:
                    self._deferred.discard(key)
                    free = True
            else:
                self._pins[key] = n
        if free and self._free_callback:
            self._free_callback(key)

    def has_refs(self, key: bytes) -> bool:
        with self._lock:
            return key in self._counts or key in self._pins
