"""Python client for the shared-memory object store.

Parity: reference `src/ray/object_manager/plasma/client.h` (create/seal/get/
release/delete) and `python/ray/_private/serialization.py` (zero-copy numpy).
Every process on a node maps the same shm file; `get` returns memoryviews that
alias store memory (zero-copy), with pickle-5 out-of-band buffers laid out
contiguously after the pickle stream so numpy/jax arrays deserialize without a
copy.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
import sys
import time

from ray_tpu_torch._native.build import load_native
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.status import (
    GetTimeoutError,
    ObjectExistsError,
    ObjectStoreFullError,
    RayTpuError,
)

OK = 0
ERR_NOTFOUND = -1
ERR_AGAIN = -2
ERR_EXISTS = -3
ERR_FULL = -4
ERR_TABLE_FULL = -5
ERR_BUSY = -6

_ALIGN = 64


def _lib():
    lib = load_native("object_store")
    if not getattr(lib, "_sigs_set", False):
        u64 = ctypes.c_uint64
        p = ctypes.c_void_p
        b = ctypes.c_char_p
        lib.store_init.argtypes = [p, u64, u64, u64]
        lib.store_validate.argtypes = [p]
        lib.store_num_shards.argtypes = [p]
        lib.store_num_shards.restype = u64
        lib.store_create.argtypes = [p, b, u64, u64, ctypes.POINTER(u64)]
        lib.store_seal.argtypes = [p, b]
        lib.store_get.argtypes = [p, b, ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u64)]
        lib.store_release.argtypes = [p, b]
        lib.store_contains.argtypes = [p, b]
        lib.store_abort.argtypes = [p, b]
        lib.store_delete.argtypes = [p, b]
        lib.store_stats.argtypes = [p] + [ctypes.POINTER(u64)] * 4
        lib.store_header_size.restype = u64
        lib.store_memcpy.argtypes = [p, p, u64, ctypes.c_int]
        lib.store_copy_adaptive.argtypes = [p, p, p, u64, ctypes.c_int]
        lib.store_list_ids.argtypes = [p, p, u64]
        lib.store_list_ids.restype = ctypes.c_int64
        lib.store_reserve.argtypes = [p, u64, ctypes.POINTER(u64)]
        lib.store_release_extent.argtypes = [p, u64, u64]
        lib.store_publish.argtypes = [p, b, u64, u64, u64]
        lib.store_num_reserves.argtypes = [p]
        lib.store_num_reserves.restype = u64
        lib.store_rsv_unused.argtypes = [p]
        lib.store_rsv_unused.restype = u64
        lib.store_reclaim_orphans.argtypes = [p]
        lib.store_reclaim_orphans.restype = ctypes.c_int64
        lib.store_reserve_config.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.store_aff_hits.argtypes = [p]
        lib.store_aff_hits.restype = u64
        lib._sigs_set = True
    return lib


# Copies above this size bypass memoryview slice assignment (CPython's buffer
# copy runs at ~half memcpy speed) for a raw memcpy; above _MT_COPY_MIN the
# native store_memcpy fans the copy out across cores.
_FAST_COPY_MIN = 256 << 10
_MT_COPY_MIN = 32 << 20
_COPY_THREADS = min(8, os.cpu_count() or 1)


def _buf_address(buf):
    """Raw pointer to a (possibly read-only) contiguous buffer, or None when
    numpy (the only stdlib-adjacent way to take the address of a read-only
    buffer) is unavailable — callers fall back to a memoryview copy."""
    try:
        import numpy as np
    except ImportError:
        return None
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


class ObjectBuffer:
    """Writable view into a created-but-unsealed object."""

    __slots__ = ("store", "object_id", "data", "meta_view", "offset", "_sealed")

    def __init__(self, store, object_id, data, meta_view, offset=0):
        self.store = store
        self.object_id = object_id
        self.data = data
        self.meta_view = meta_view
        self.offset = offset  # absolute offset of data from the mmap base
        self._sealed = False

    def seal(self):
        self.data.release()
        self.meta_view.release()
        self.store._seal(self.object_id)
        self._sealed = True

    def abort(self):
        if not self._sealed:
            self.data.release()
            self.meta_view.release()
            self.store._abort(self.object_id)


def _round_block(total: int) -> int:
    """Block footprint of an object inside a reservation extent — MUST
    mirror the allocator's align_up(max(n, MIN_BLOCK)) (object_store.cpp)
    so a published block frees back exactly what was carved."""
    return (max(total, 128) + _ALIGN - 1) & ~(_ALIGN - 1)


class _Reservation:
    """One client's private write extent: carved once under the global
    lock, bump-allocated with no shared lock at all."""

    __slots__ = ("off", "size", "used")

    def __init__(self, off: int, size: int):
        self.off = off
        self.size = size
        self.used = 0


class _ReservedBuffer(ObjectBuffer):
    """ObjectBuffer carved from a write reservation: the fill runs with
    no lock held anywhere; seal() publishes the slot (already SEALED —
    one short shard-lock critical section, the visibility point)."""

    __slots__ = ("data_size", "meta_size", "block")

    def seal(self):
        from ray_tpu_torch.core import chaos
        chaos.kill("store.publish.kill")  # SIGKILL in the crash window the
        # orphan sweep exists for: bytes filled, slot never published
        self.data.release()
        self.meta_view.release()
        rc = self.store._lib.store_publish(
            self.store._base, self.object_id.binary(), self.offset,
            self.data_size, self.meta_size)
        # Either way the chunk is no longer this buffer's: a successful
        # publish transferred it to the slot, a failed one is released
        # right here — a later abort() must not release it again.
        self._sealed = True
        if rc == ERR_EXISTS:
            self.store._release_chunk(self.offset, self.block)
            raise ObjectExistsError(
                f"object {self.object_id} already exists")
        if rc != OK:
            self.store._release_chunk(self.offset, self.block)
            raise ObjectStoreFullError(
                f"publish of {self.object_id} failed (rc={rc})")

    def abort(self):
        if not self._sealed:
            self.data.release()
            self.meta_view.release()
            self.store._release_chunk(self.offset, self.block)


class _ReleaseHandle:
    """Shared countdown: releases the store reference when every tracked
    buffer of one get_deserialized call has been dropped."""

    __slots__ = ("store", "object_id", "data", "remaining", "_lock")

    def __init__(self, store, object_id, data, remaining):
        self.store = store
        self.object_id = object_id
        self.data = data
        self.remaining = remaining
        import threading
        self._lock = threading.Lock()

    def drop_one(self):
        with self._lock:  # __del__ may run on any thread
            self.remaining -= 1
            done = self.remaining == 0
        if done:
            try:
                self.data.release()
            except BufferError:
                pass  # a raw slice escaped; mmap keeps it valid
            self.store.release(self.object_id)


# _TrackedBuffer implements the buffer protocol in pure Python via PEP 688
# (__buffer__), which the interpreter only honors from 3.12. Earlier
# Pythons cannot express "a buffer whose destruction releases the store
# ref", so out-of-band reads fall back to a copy there — correct, just not
# zero-copy.
_ZERO_COPY_READS = sys.version_info >= (3, 12)


class _ArrowKeepalive:
    """Pins one arrow-block read: handed to pyarrow as the foreign
    buffer's `base`, so the store reference (and the arena view) outlive
    every Table / column / numpy view derived from the zero-copy read.
    Same lifetime story as _TrackedBuffer, without needing PEP 688 —
    arrow reads are zero-copy on every Python version."""

    __slots__ = ("_store", "_oid", "_view")

    def __init__(self, store, object_id, view):
        self._store = store
        self._oid = object_id
        self._view = view

    def __del__(self):
        v, self._view = self._view, None
        if v is None:
            return
        try:
            v.release()
        except BufferError:
            pass
        self._store.release(self._oid)


class _TrackedBuffer:
    """PEP-688 buffer wrapper: consumers (numpy et al.) hold this object via
    the buffer protocol, so its destruction marks the buffer unused."""

    __slots__ = ("_view", "_handle")

    def __init__(self, view, handle):
        self._view = view
        self._handle = handle

    def __buffer__(self, flags):
        # Read-only: sealed objects are immutable; a writable view would let
        # np.frombuffer consumers mutate the shared arena in place.
        return memoryview(self._view).toreadonly()

    def __del__(self):
        h = self._handle
        if h is not None:
            self._handle = None
            try:
                self._view.release()
            except BufferError:
                pass
            h.drop_one()


def default_shard_count() -> int:
    """Auto shard count: power of two, floored at 8 (even on few cores,
    N processes timesharing one CPU stop blocking behind a preempted lock
    holder when their ids hash to different shards) and capped at 16 —
    beyond that the global extent lock, not shard locks, bounds scaling."""
    n = max(os.cpu_count() or 1, 8)
    p = 1
    while p * 2 <= min(n, 16):
        p *= 2
    return p


class SharedMemoryStore:
    """One node's object store; head creates, workers attach.

    `num_shards` splits the index/allocator lock (see object_store.cpp);
    0 picks a power-of-two per-core default. Attaching processes read the
    shard geometry from the arena header, so only the creator decides."""

    def __init__(self, path: str, size: int = 0, num_slots: int = 1 << 16,
                 create: bool = False, num_shards: int = 0):
        self.path = path
        self._lib = _lib()
        if create:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
            try:
                # Fewer TLB misses on GB-scale copies where the kernel
                # allows THP on shmem (no-op where shmem_enabled=never).
                self._mm.madvise(mmap.MADV_HUGEPAGE)
            except (AttributeError, OSError, ValueError):
                pass
            rc = self._lib.store_init(self._base, size, num_slots,
                                      num_shards or default_shard_count())
            if rc != OK:
                raise RayTpuError(f"store_init failed: {rc}")
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
            if self._lib.store_validate(self._base) != OK:
                raise RayTpuError(f"attached store at {path} is corrupt")
        self.size = size
        self.num_shards = int(self._lib.store_num_shards(self._base))
        # -- write-reservation plane (multi-client put bandwidth) --
        # Payloads >= reservation_min_bytes bump-allocate inside a private
        # extent of reservation_chunk_bytes (clamped to arena/16) carved
        # once under the global lock; the fill and publish take no
        # allocator lock on the per-put path. 0 chunk disables.
        import threading
        self.reservation_min_bytes = 4 << 20
        self.reservation_chunk_bytes = min(256 << 20, max(0, size // 16))
        self._rsv: _Reservation | None = None
        self._rsv_lock = threading.Lock()
        # Optional policy hook called (OUTSIDE any store lock) with the
        # byte count about to be carved from the global list — head-node
        # runtimes point it at their spill machinery so room is made per
        # REFILL, not per put.
        self.spill_hook = None

    # -- raw object interface --

    def create(self, object_id: ObjectID, data_size: int, meta: bytes = b"") -> ObjectBuffer:
        off = ctypes.c_uint64()
        rc = self._lib.store_create(self._base, object_id.binary(), data_size,
                                    len(meta), ctypes.byref(off))
        if rc == ERR_EXISTS:
            raise ObjectExistsError(f"object {object_id} already exists")
        if rc in (ERR_FULL, ERR_TABLE_FULL):
            raise ObjectStoreFullError(
                f"object store full creating {data_size} bytes (rc={rc})")
        mv = memoryview(self._mm)
        data = mv[off.value : off.value + data_size]
        meta_view = mv[off.value + data_size : off.value + data_size + len(meta)]
        if meta:
            meta_view[:] = meta
        mv.release()
        return ObjectBuffer(self, object_id, data, meta_view, off.value)

    # -- write reservations --

    def _release_chunk(self, abs_off: int, size: int):
        self._lib.store_release_extent(self._base, abs_off, size)

    def release_reservation(self):
        """Return the unused tail of this client's reservation (shutdown,
        or before a refill)."""
        from ray_tpu_torch.core import chaos
        with self._rsv_lock:
            r, self._rsv = self._rsv, None
        if r is not None and r.size > r.used:
            if chaos.site("store.reserve.abandon"):
                return  # simulate the crash window: the tail leaks until
                # the owner pid dies and the liveness sweep repairs it
            self._release_chunk(r.off + r.used, r.size - r.used)

    def reclaim_orphans(self) -> int:
        """Pid-liveness sweep over the arena's reservation records:
        extents whose owner died mid-reservation are returned to the
        global free list and `rsv_unused` is repaired. Returns bytes
        reclaimed. Cheap when nothing died — store owners (head runtime,
        node agents) call this on pressure and on a heartbeat cadence."""
        return int(self._lib.store_reclaim_orphans(self._base))

    def rsv_unused(self) -> int:
        """Reserved-but-unpublished bytes currently parked across ALL
        clients' write reservations (the counter the orphan sweep
        repairs; tests assert it returns to baseline after storms)."""
        return int(self._lib.store_rsv_unused(self._base))

    def reservation_fits(self, nbytes: int) -> bool:
        """True when a put of ~nbytes will carve from the current
        reservation without touching the global allocator (callers use
        this to skip per-put spill checks)."""
        r = self._rsv
        return r is not None and r.used + _round_block(nbytes + 512) <= r.size

    def num_reserves(self) -> int:
        return int(self._lib.store_num_reserves(self._base))

    def num_affinity_hits(self) -> int:
        """Reserves satisfied from this-pid-warm bytes (owner affinity)."""
        return int(self._lib.store_aff_hits(self._base))

    def _carve(self, block: int) -> int | None:
        with self._rsv_lock:
            r = self._rsv
            if r is not None and r.used + block <= r.size:
                off = r.off + r.used
                r.used += block
                return off
        return None

    def _reserved_create(self, object_id: ObjectID, data_size: int,
                         meta: bytes) -> "_ReservedBuffer | None":
        """Bump-carve a block for one object; refills the reservation from
        the global extent list when the current one is exhausted. Returns
        None when the arena cannot host a fresh extent (caller falls back
        to the eviction-capable create path)."""
        from ray_tpu_torch.core import chaos
        total = data_size + len(meta)
        block = _round_block(total)
        if chaos.site("store.reserve.exhaust"):
            return None  # injected arena exhaustion: caller falls back to
            # the eviction-capable create path
        off = self._carve(block)
        if off is None:
            chunk = max(self.reservation_chunk_bytes, block)
            hook = self.spill_hook
            if hook is not None:
                try:
                    hook(chunk)
                except Exception:  # noqa: BLE001 — policy hook, best effort
                    pass
            with self._rsv_lock:
                r = self._rsv
                if r is not None and r.used + block <= r.size:
                    off = r.off + r.used  # another thread refilled
                    r.used += block
                else:
                    if r is not None and r.size > r.used:
                        if chaos.site("store.reserve.abandon"):
                            pass  # crash window: old tail leaks until the
                            # liveness sweep reclaims it
                        else:
                            self._release_chunk(r.off + r.used,
                                                r.size - r.used)
                    self._rsv = None
                    out = ctypes.c_uint64()
                    rc = self._lib.store_reserve(self._base, chunk,
                                                 ctypes.byref(out))
                    if rc != OK and chunk > block:
                        chunk = block  # arena tight: take just this object
                        rc = self._lib.store_reserve(self._base, chunk,
                                                     ctypes.byref(out))
                    if rc != OK:
                        return None
                    r = _Reservation(out.value, chunk)
                    r.used = block
                    self._rsv = r
                    off = r.off
        mv = memoryview(self._mm)
        data = mv[off : off + data_size]
        meta_view = mv[off + data_size : off + total]
        if meta:
            meta_view[:] = meta
        mv.release()
        buf = _ReservedBuffer(self, object_id, data, meta_view, off)
        buf.data_size = data_size
        buf.meta_size = len(meta)
        buf.block = block
        return buf

    def _acquire_buffer(self, object_id: ObjectID, data_size: int,
                        meta: bytes = b"") -> ObjectBuffer:
        """Reservation fast path when large enough and enabled, else the
        classic create (shard lock + eviction)."""
        if (self.reservation_chunk_bytes
                and data_size + len(meta) >= self.reservation_min_bytes):
            buf = self._reserved_create(object_id, data_size, meta)
            if buf is not None:
                return buf
        return self.create(object_id, data_size, meta=meta)

    def _seal(self, object_id: ObjectID):
        self._lib.store_seal(self._base, object_id.binary())

    def _abort(self, object_id: ObjectID):
        self._lib.store_abort(self._base, object_id.binary())

    def get_raw(self, object_id: ObjectID, timeout: float | None = None):
        """Returns (data_view, meta_bytes) or None if absent after timeout.

        Takes a store reference; call release() when views are dropped.
        """
        off = ctypes.c_uint64()
        dsz = ctypes.c_uint64()
        msz = ctypes.c_uint64()
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            rc = self._lib.store_get(self._base, object_id.binary(),
                                     ctypes.byref(off), ctypes.byref(dsz),
                                     ctypes.byref(msz))
            if rc == OK:
                mv = memoryview(self._mm)
                data = mv[off.value : off.value + dsz.value]
                meta = bytes(mv[off.value + dsz.value : off.value + dsz.value + msz.value])
                mv.release()
                return data, meta
            if timeout == 0 and rc in (ERR_NOTFOUND, ERR_AGAIN):
                return None  # not-ready probe: unsealed counts as absent
            if deadline is not None and time.monotonic() > deadline:
                if rc == ERR_AGAIN:
                    raise GetTimeoutError(f"object {object_id} never sealed")
                return None
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def release(self, object_id: ObjectID):
        self._lib.store_release(self._base, object_id.binary())

    def list_object_ids(self) -> list[bytes]:
        """Ids of every sealed object in the arena (inventory for a
        restarted head's directory rebuild). The buffer grows until the
        scan fits, so concurrent sealers can't silently truncate it."""
        max_ids = int(self.stats()["num_objects"]) + 1024  # churn slack
        while True:
            out = (ctypes.c_uint8 * (16 * max_ids))()
            n = self._lib.store_list_ids(self._base, out, max_ids)
            if n < max_ids:
                raw = bytes(out[: 16 * n])
                return [raw[i:i + 16] for i in range(0, 16 * n, 16)]
            max_ids *= 2

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.store_contains(self._base, object_id.binary()))

    def probe(self, object_id: ObjectID) -> str:
        """'sealed' | 'unsealed' | 'absent' (non-blocking, no ref taken)."""
        off = ctypes.c_uint64()
        dsz = ctypes.c_uint64()
        msz = ctypes.c_uint64()
        rc = self._lib.store_get(self._base, object_id.binary(),
                                 ctypes.byref(off), ctypes.byref(dsz),
                                 ctypes.byref(msz))
        if rc == OK:
            self._lib.store_release(self._base, object_id.binary())
            return "sealed"
        return "unsealed" if rc == ERR_AGAIN else "absent"

    def delete(self, object_id: ObjectID):
        self._lib.store_delete(self._base, object_id.binary())

    def stats(self) -> dict:
        a, c, n, e = (ctypes.c_uint64() for _ in range(4))
        self._lib.store_stats(self._base, *(ctypes.byref(x) for x in (a, c, n, e)))
        return {"allocated": a.value, "capacity": c.value,
                "num_objects": n.value, "num_evictions": e.value,
                "rsv_unused": int(self._lib.store_rsv_unused(self._base))}

    # -- tagged-value interface (language-neutral arena objects) --
    #
    # Objects sealed with meta == TAGGED_META carry a tagged Value instead
    # of a pickle: data = [u32 fmt_len][fmt utf8][payload]. This is the
    # layout the C++ worker (cpp/raytpu_worker.cc) reads zero-copy for
    # shm-arena task args and writes for its returns — no pickle anywhere
    # on the cross-language path; Python readers decode it transparently
    # in get_deserialized below.

    TAGGED_META = b"rtv1"

    # Arrow blocks ride the tagged layout under this format tag:
    # payload = [u32 pad][u64 ipc_len][pad zero bytes][Arrow IPC stream],
    # pad chosen at write time so the stream starts 64-aligned in the
    # arena. The writer streams the IPC encoding DIRECTLY into the
    # acquired buffer (write reservation when large enough) — no
    # intermediate bytes object, no pickle; readers re-hydrate via
    # pa.ipc.open_stream over a zero-copy view whose lifetime pins the
    # store reference (_ArrowKeepalive).
    ARROW_FMT = "arrow"

    def put_arrow(self, object_id: ObjectID, table) -> int:
        """Seal a pyarrow.Table as a tagged arena object (ARROW_FMT).

        Two-pass IPC encode: a MockOutputStream pass sizes the stream
        without materializing it, then the real pass writes into the
        acquired arena buffer through a FixedSizeBufferWriter."""
        import pyarrow as pa
        sink = pa.MockOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as w:
            w.write_table(table)
        ipc_len = sink.size()
        fmt_b = self.ARROW_FMT.encode()
        hdr = 4 + len(fmt_b) + 12
        total = hdr + 63 + ipc_len  # worst-case alignment pad
        buf = self._acquire_buffer(object_id, total, meta=self.TAGGED_META)
        try:
            pad = (-(buf.offset + hdr)) % 64
            d = buf.data
            struct.pack_into("<I", d, 0, len(fmt_b))
            d[4:4 + len(fmt_b)] = fmt_b
            struct.pack_into("<IQ", d, 4 + len(fmt_b), pad, ipc_len)
            body = d[hdr + pad: hdr + pad + ipc_len]
            try:
                writer = pa.FixedSizeBufferWriter(pa.py_buffer(body))
                with pa.ipc.new_stream(writer, table.schema) as w:
                    w.write_table(table)
                del writer
            finally:
                try:
                    body.release()
                except BufferError:
                    pass  # pyarrow still holds the export; dies with it
            buf.seal()
        except BaseException:
            buf.abort()
            raise
        return total

    def _decode_arrow(self, object_id: ObjectID, data, off: int):
        """Re-hydrate a put_arrow object zero-copy: the returned Table's
        buffers alias the mapped arena; the store reference is dropped
        when the table (and every view derived from it) is collected."""
        import pyarrow as pa
        pad, ipc_len = struct.unpack_from("<IQ", data, off)
        start = off + 12 + pad
        addr = _buf_address(data)
        if addr is None:  # no numpy: copy out (correct, just not zero-copy)
            blob = bytes(data[start:start + ipc_len])
            data.release()
            self.release(object_id)
            return pa.ipc.open_stream(pa.BufferReader(blob)).read_all()
        keep = _ArrowKeepalive(self, object_id, data)
        fb = pa.foreign_buffer(addr + start, ipc_len, base=keep)
        return pa.ipc.open_stream(pa.BufferReader(fb)).read_all()

    def put_tagged(self, object_id: ObjectID, fmt: str, payload) -> int:
        """Seal a language-neutral tagged value (see TAGGED_META layout)."""
        fmt_b = fmt.encode()
        payload = memoryview(payload) if not isinstance(
            payload, (bytes, bytearray, memoryview)) else payload
        n = len(payload)
        total = 4 + len(fmt_b) + n
        buf = self._acquire_buffer(object_id, total, meta=self.TAGGED_META)
        try:
            d = buf.data
            struct.pack_into("<I", d, 0, len(fmt_b))
            d[4:4 + len(fmt_b)] = fmt_b
            d[4 + len(fmt_b):total] = payload
            buf.seal()
        except BaseException:
            buf.abort()
            raise
        return total

    def _decode_tagged(self, object_id: ObjectID, data):
        (fmt_len,) = struct.unpack_from("<I", data, 0)
        fmt = bytes(data[4:4 + fmt_len]).decode()
        if fmt == self.ARROW_FMT:
            # Arrow block: keeps its store reference pinned until the
            # zero-copy table dies (_decode_arrow owns the release).
            return self._decode_arrow(object_id, data, 4 + fmt_len)
        from ray_tpu_torch.core.proto_wire import decode_tagged
        try:
            value = decode_tagged(fmt, data[4 + fmt_len:])
        finally:
            data.release()
            self.release(object_id)
        return value

    # -- serialized-value interface (pickle5 + out-of-band buffers) --
    #
    # Object layout: [u32 npickle][pickle bytes][pad to 64]
    #                [u32 nbufs][u64 len]*nbufs [pad to 64][buf (64-aligned)]*

    def put_serialized(self, object_id: ObjectID, value) -> int:
        """Serialize value into the store; returns total bytes."""
        buffers: list[pickle.PickleBuffer] = []
        payload = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
        raw = [b.raw() for b in buffers]
        lens = [len(r) for r in raw]
        head = 4 + len(payload)
        head_pad = (-head) % _ALIGN
        idx = 4 + 8 * len(raw)
        idx_pad = (-idx) % _ALIGN
        total = head + head_pad + idx + idx_pad
        offsets = []
        for ln in lens:
            offsets.append(total)
            total += ln + ((-ln) % _ALIGN)
        buf = self._acquire_buffer(object_id, total)
        try:
            d = buf.data
            struct.pack_into("<I", d, 0, len(payload))
            d[4 : 4 + len(payload)] = payload
            base = head + head_pad
            struct.pack_into("<I", d, base, len(raw))
            for i, ln in enumerate(lens):
                struct.pack_into("<Q", d, base + 4 + 8 * i, ln)
            dst_base = self._base + buf.offset
            for off, r in zip(offsets, raw):
                ln = len(r)
                src = _buf_address(r) if ln >= _FAST_COPY_MIN else None
                if src is not None:
                    if ln >= _MT_COPY_MIN:
                        # Thread budget split across CONCURRENT arena
                        # copiers (shm counter): ten clients each copying
                        # 80MB already parallelize across processes.
                        self._lib.store_copy_adaptive(
                            self._base, ctypes.c_void_p(dst_base + off),
                            ctypes.c_void_p(src), ln, _COPY_THREADS)
                    else:
                        self._lib.store_memcpy(
                            ctypes.c_void_p(dst_base + off),
                            ctypes.c_void_p(src), ln, 1)
                else:
                    d[off : off + ln] = r
            buf.seal()
        except BaseException:
            buf.abort()
            raise
        return total

    def get_deserialized(self, object_id: ObjectID, timeout: float | None = None):
        """Returns (found, value). Zero-copy: out-of-band buffers alias shm.

        The store reference taken by the read is dropped when the deserialized
        value is garbage-collected: each out-of-band buffer is handed to
        pickle wrapped in a _TrackedBuffer whose destruction releases the
        shared handle (numpy/jax keep the wrapper alive via the buffer
        protocol). Values with no out-of-band buffers are fully copied by
        pickle, so the reference is dropped immediately.
        """
        res = self.get_raw(object_id, timeout)
        if res is None:
            return False, None
        data, _meta = res
        if _meta == self.TAGGED_META:
            # Language-neutral tagged object (a C++ worker's return, a
            # cross-language arg, a client-plane put): no pickle involved.
            return True, self._decode_tagged(object_id, data)
        (npickle,) = struct.unpack_from("<I", data, 0)
        payload = data[4 : 4 + npickle]
        head = 4 + npickle
        base = head + ((-head) % _ALIGN)
        (nbufs,) = struct.unpack_from("<I", data, base)
        lens = struct.unpack_from(f"<{nbufs}Q", data, base + 4) if nbufs else ()
        idx = 4 + 8 * nbufs
        off = base + idx + ((-idx) % _ALIGN)
        if nbufs == 0:
            try:
                value = pickle.loads(payload)
            finally:
                payload.release()
                data.release()
                self.release(object_id)
            return True, value
        if not _ZERO_COPY_READS:
            # Pre-3.12 fallback: copy the buffers out and drop the store
            # reference immediately (same lifetime story as the no-buffer
            # path). Zero-copy needs PEP-688 _TrackedBuffer tracking.
            bufs = []
            for ln in lens:
                bufs.append(bytes(data[off : off + ln]))
                off += ln + ((-ln) % _ALIGN)
            try:
                value = pickle.loads(payload, buffers=bufs)
            finally:
                payload.release()
                data.release()
                self.release(object_id)
            return True, value
        handle = _ReleaseHandle(self, object_id, data, nbufs)
        bufs = []
        for ln in lens:
            bufs.append(_TrackedBuffer(data[off : off + ln], handle))
            off += ln + ((-ln) % _ALIGN)
        value = pickle.loads(payload, buffers=bufs)
        payload.release()
        return True, value

    def close(self):
        # Return the reservation tail first — leaked tails survive the
        # process and strand arena space until the file is unlinked.
        try:
            self.release_reservation()
        except Exception:  # noqa: BLE001 — teardown best effort
            pass
        # Views into self._mm may still be alive (zero-copy values); the mmap
        # stays mapped until the process exits in that case.
        try:
            self._mm.close()
        except BufferError:
            pass

    def unlink(self):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def arrow_block_of(value):
    """`value` as the pyarrow.Table the arena-native arrow plane should
    carry, or None (not a Table, pyarrow never imported in this process,
    or the `data_block_arrow` knob is off). sys.modules probing keeps
    processes that never touch the data plane from importing pyarrow."""
    pa = sys.modules.get("pyarrow")
    if pa is None or not isinstance(value, pa.Table):
        return None
    try:
        from ray_tpu_torch.core.config import get_config
        if not get_config().data_block_arrow:
            return None
    except Exception:  # noqa: BLE001 — config not importable (bare tests)
        pass
    return value


def configure_store(store: SharedMemoryStore, cfg) -> None:
    """Apply the config's write-reservation knobs to a store handle.
    Called wherever a process creates/attaches its arena handle (head,
    node agent, worker) — the store module itself stays config-free."""
    try:
        store._lib.store_reserve_config(
            1 if cfg.put_extent_affinity else 0,
            1 if cfg.put_extent_pretouch else 0)
    except AttributeError:
        pass  # stale .so without the affinity plane
    mn = cfg.put_reservation_min_bytes
    if mn <= 0:
        store.reservation_chunk_bytes = 0
        return
    store.reservation_min_bytes = mn
    chunk = cfg.put_reservation_bytes or min(256 << 20, store.size // 16)
    store.reservation_chunk_bytes = max(0, chunk)


def default_store_size(config) -> int:
    explicit = config.object_store_memory_bytes
    if explicit:
        return explicit
    return min(int(_available_memory() * 0.3),
               config.object_store_auto_cap_bytes)


def _available_memory() -> int:
    """The host's available memory: MemAvailable of /proc/meminfo (what
    psutil reports, without needing psutil), 8 GiB where it is unreadable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 8 * 2**30
