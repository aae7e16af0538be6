"""ctypes bindings for the native head core (head_core.cc beside this file).

One `HeadCore` instance per head process: the C++ side owns the
node-listener frame pump (epoll + outer-frame split + accept-readiness
surfacing), the in-place `node_done_raw` parse into flat completion
records, the (task_id, lease_seq) per-node inflight ledger, and the
native `node_exec_raw` grant-frame builds into per-node double-buffered
outboxes. Python keeps all policy and performs every socket write/accept
under the same locks as the pure-Python listener. Built on demand
through the content-hash g++ cache (ray_tpu_torch/_native/build.py) — a
failed build degrades to the pure-Python listener, never to an error.
"""

from __future__ import annotations

import ctypes
import os
import struct

_u64 = ctypes.c_uint64
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
_dbl = ctypes.c_double
_u8p = ctypes.POINTER(ctypes.c_uint8)

# Frame kinds surfaced by the pump (framecore::FrameKind).
KIND_PICKLE = 0
KIND_PROTO = 1
KIND_RAW = 2
KIND_EOF = 3
KIND_ACCEPT = 4

# Completion-record out statuses (head_core.cc OutRec.status).
_STATUS = ("inline", "err", "shm")

_lib = None
_lib_err = None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        from ray_tpu_torch._native.build import load_native
        lib = load_native("head_core", sources=("head_core.cc",),
                          headers=("frame_core.h",))
    except Exception as e:  # noqa: BLE001 — degrade to pure Python
        _lib_err = e
        return None
    p = ctypes.c_void_p
    lib.hdc_new.restype = p
    lib.hdc_free.argtypes = [p]
    lib.hdc_add_fd.argtypes = [p, _i32, _u64, _i32]
    lib.hdc_del_fd.argtypes = [p, _i32]
    lib.hdc_poll.argtypes = [p, _i32]
    lib.hdc_split.argtypes = [p]
    lib.hdc_frame_count.argtypes = [p]
    lib.hdc_frame_info.argtypes = [
        p, _i32, ctypes.POINTER(_u64), ctypes.POINTER(_i32),
        ctypes.POINTER(_i32), ctypes.POINTER(_u8p), ctypes.POINTER(_u64),
        ctypes.POINTER(_u8p), ctypes.POINTER(_u64), ctypes.POINTER(_i32),
        ctypes.POINTER(_i32)]
    lib.hdc_frame_buf.argtypes = [p, _i32, _i32, ctypes.POINTER(_u8p),
                                  ctypes.POINTER(_u64)]
    lib.hdc_round_end.argtypes = [p]
    lib.hdc_node_add.argtypes = [p, _u64]
    lib.hdc_node_remove.argtypes = [p, _i32]
    lib.hdc_grant_add.argtypes = [p, _i32, ctypes.c_char_p, _i32,
                                  ctypes.c_char_p, _i32, _u64,
                                  ctypes.c_char_p, _u64, _i32,
                                  ctypes.c_char_p, _u64, _i64,
                                  ctypes.c_char_p, _i32]
    lib.hdc_grant_take.argtypes = [p, _i32, ctypes.POINTER(_u8p),
                                   ctypes.POINTER(_u64)]
    lib.hdc_grant_drop.argtypes = [p, _i32]
    lib.hdc_consume_hot.argtypes = [p]
    lib.hdc_rec_count.argtypes = [p]
    lib.hdc_rec_info.argtypes = [
        p, _i32, ctypes.POINTER(_i32), ctypes.POINTER(_i32),
        ctypes.POINTER(_u8p), ctypes.POINTER(_u64),
        ctypes.POINTER(_u8p), ctypes.POINTER(_u64), ctypes.POINTER(_i32),
        ctypes.POINTER(_i64), ctypes.POINTER(_dbl), ctypes.POINTER(_i32),
        ctypes.POINTER(_i32)]
    lib.hdc_rec_out.argtypes = [
        p, _i32, ctypes.POINTER(_u8p), ctypes.POINTER(_u64),
        ctypes.POINTER(_i32), ctypes.POINTER(_u8p), ctypes.POINTER(_u64),
        ctypes.POINTER(_i32)]
    lib.hdc_recs_take.argtypes = [p, ctypes.POINTER(_u8p),
                                  ctypes.POINTER(_u64)]
    lib.hdc_inflight_pop.argtypes = [p, ctypes.c_char_p, _i32]
    lib.hdc_inflight.argtypes = [p]
    lib.hdc_inflight.restype = _u64
    lib.hdc_stats.argtypes = [p, ctypes.POINTER(_u64), ctypes.POINTER(_u64),
                              ctypes.POINTER(_u64)]
    lib.hdc_proto_tag_count.argtypes = []
    lib.hdc_proto_tag_entry.argtypes = [_i32, ctypes.POINTER(_i32),
                                        ctypes.POINTER(ctypes.c_char_p)]
    _lib = lib
    return lib


def _view(ptr, n):
    if not n:
        return b""
    return memoryview((ctypes.c_uint8 * n).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value))


class HeadCore:
    """Python face of one native head-listener context."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"head_core build failed: {_lib_err!r}")
        self._lib = lib
        self._ctx = lib.hdc_new()
        self._next_tag = 16

    def close(self):
        if self._ctx:
            self._lib.hdc_free(self._ctx)
            self._ctx = None

    # -- pump --

    def add_fd(self, fd: int, tag: int, accept: bool = False):
        self._lib.hdc_add_fd(self._ctx, fd, tag, 2 if accept else 0)

    def del_fd(self, fd: int):
        self._lib.hdc_del_fd(self._ctx, fd)

    def alloc_tag(self) -> int:
        self._next_tag += 1
        return self._next_tag

    def poll(self, timeout_ms: int) -> int:
        return self._lib.hdc_poll(self._ctx, timeout_ms)

    def split(self) -> int:
        return self._lib.hdc_split(self._ctx)

    def consume_hot(self) -> int:
        return self._lib.hdc_consume_hot(self._ctx)

    def frames(self):
        """Yield (tag, kind, proto_tag, payload_view, bufs, whole_view) for
        every frame Python must handle. Views die at round_end()."""
        lib, ctx = self._lib, self._ctx
        n = lib.hdc_frame_count(ctx)
        tag, kind, ptag = _u64(), _i32(), _i32()
        pp, pl = _u8p(), _u64()
        wp, wl = _u8p(), _u64()
        nb, cons = _i32(), _i32()
        for i in range(n):
            if lib.hdc_frame_info(ctx, i, tag, kind, ptag, pp, pl, wp, wl,
                                  nb, cons) != 0:
                continue
            if cons.value:
                continue
            bufs = []
            for j in range(nb.value):
                bp, bl = _u8p(), _u64()
                if lib.hdc_frame_buf(ctx, i, j, bp, bl) == 0:
                    # bytes COPY, not a view: out-of-band buffers can
                    # outlive the round inside decoded messages (an
                    # inline result banked in the directory) while the
                    # native conn buffer is recycled at round_end —
                    # matching FrameBuffer, which also yields bytes.
                    bufs.append(bytes(_view(bp, bl.value)))
            yield (tag.value, kind.value, ptag.value,
                   _view(pp, pl.value), bufs, _view(wp, wl.value))

    def round_end(self):
        self._lib.hdc_round_end(self._ctx)

    # -- node ledger / grant builder --

    def node_add(self, tag: int) -> int:
        return self._lib.hdc_node_add(self._ctx, tag)

    def node_remove(self, nidx: int):
        self._lib.hdc_node_remove(self._ctx, nidx)

    def grant_add(self, nidx: int, tid: bytes, fn: bytes | None, seq: int,
                  blob: bytes | None, spec_bytes: bytes, attempt: int,
                  name: str | None):
        fn = fn or b""
        nm = (name or "").encode("utf-8", "replace")
        self._lib.hdc_grant_add(
            self._ctx, nidx, tid, len(tid), fn, len(fn), seq or 0,
            blob or b"", len(blob or b""), 0 if blob is None else 1,
            spec_bytes, len(spec_bytes), attempt or 0, nm, len(nm))

    def grant_take(self, nidx: int):
        """The staged grant batch as ONE complete node_exec_raw outer
        frame (view valid until the next take for this node)."""
        pp, pl = _u8p(), _u64()
        if self._lib.hdc_grant_take(self._ctx, nidx, pp, pl) != 0:
            return b""
        return _view(pp, pl.value) if pl.value else b""

    def grant_drop(self, nidx: int):
        self._lib.hdc_grant_drop(self._ctx, nidx)

    # -- completion ledger --

    _REC_HDR = struct.Struct("<iBBHHq4dH")
    _OUT_HDR = struct.Struct("<BBIQ")

    def completions(self):
        """Yield one (nidx, known, tid, whex, outs, tev) per natively
        consumed lease completion, where outs is the rebuilt
        [(rid, status, payload, bufs)] list `_on_node_done` consumes and
        tev the piggybacked exec record (or None). Byte fields are
        COPIES (they outlive the round inside the directory). The whole
        round drains through ONE native call (hdc_recs_take) + struct
        unpacks — per-record ctypes accessor chatter measurably hit the
        16-agent storm. Call between consume_hot() and round_end()."""
        lib, ctx = self._lib, self._ctx
        pp, pl = _u8p(), _u64()
        n = lib.hdc_recs_take(ctx, pp, pl)
        if n <= 0:
            return
        buf = bytes(_view(pp, pl.value))
        rec_hdr, out_hdr = self._REC_HDR, self._OUT_HDR
        off = 0
        for _ in range(n):
            (nidx, known, tevp, tlen, wlen, teva, t0, t1, t2, t3,
             nouts) = rec_hdr.unpack_from(buf, off)
            off += rec_hdr.size
            tid = buf[off:off + tlen]
            off += tlen
            whex = buf[off:off + wlen].decode("ascii", "replace")
            off += wlen
            outs = []
            for _j in range(nouts):
                st, pnone, rlen, plen = out_hdr.unpack_from(buf, off)
                off += out_hdr.size
                rid = buf[off:off + rlen]
                off += rlen
                if pnone:
                    payload = None
                else:
                    payload = buf[off:off + plen]
                    off += plen
                outs.append((rid, _STATUS[st], payload,
                             [] if st < 2 else None))
            tev = (teva, t0, t1, t2, t3) if tevp else None
            yield (nidx, bool(known), tid, whex, outs, tev)

    def inflight_pop(self, tid: bytes) -> int:
        return self._lib.hdc_inflight_pop(self._ctx, tid, len(tid))

    def inflight(self) -> int:
        return int(self._lib.hdc_inflight(self._ctx))

    def stats(self) -> dict:
        g, d, f = _u64(), _u64(), _u64()
        self._lib.hdc_stats(self._ctx, g, d, f)
        return {"native_grants": g.value, "native_dones": d.value,
                "native_done_frames": f.value}


def proto_tag_table() -> dict:
    """The AgentFrame oneof tags compiled into the shared sniffer
    (staticcheck cross-checks these against raytpu.proto)."""
    lib = _load()
    if lib is None:
        return {}
    out = {}
    f, name = _i32(), ctypes.c_char_p()
    for i in range(lib.hdc_proto_tag_count()):
        if lib.hdc_proto_tag_entry(i, f, name) == 0:
            out[name.value.decode()] = f.value
    return out


def available() -> bool:
    return _load() is not None
