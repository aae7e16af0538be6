"""Cross-node object transfer over per-node peer ports.

Parity: reference `src/ray/object_manager/` (object_manager.h:119 push/pull,
pull_manager.h:57) — collapsed to pull-driven whole-object transfers over
persistent peer connections.

The serving side is NATIVE by default: `ray_tpu_torch/_native/peer_server.cpp`
answers pulls straight out of the shm arena in C++ threads (no GIL on the
send path); `start_peer_server` falls back to a Python thread server
speaking the identical binary protocol if the native build is unavailable.
The pulling side receives straight into the destination arena buffer
(`recv_into` on the created object) — no intermediate blob copy.

Clients keep ONE cached persistent connection per (this process, peer
addr) — the server loop always supported reuse; the pull path now uses it
(parity: object_manager.h:119 persistent push/pull channels). A pull
checks a connection out of the cache (exclusive while in use), returns it
on clean completion, and closes-and-drops it on any error/EOF so a dead
peer cannot poison later pulls. Cache size per addr is
`objxfer_conn_cache_size` (0 restores connect-per-pull). Large bodies
land via a chunked `recv_into` loop over buffers sized by
_RECV_CHUNK with enlarged kernel socket buffers, so a 64MB activation
streams at line rate instead of paying connect + slow-start per hop.

Wire protocol (little endian):
  request:  16-byte object id
  response: u8 ok; if ok: u64 data_size, u64 meta_size, meta bytes, data

  range request (multi-stream pulls): 16-byte RANGE_MAGIC, 16-byte
  object id, u64 offset, u64 length
  response: u8 ok; if ok: u64 data_size (TOTAL), u64 meta_size,
  meta bytes, data[offset : offset+min(length, data_size-offset)]

Large objects stripe over `objxfer_streams` connections (each from the
per-addr cache): the first range request doubles as the size probe, the
remainder splits into per-connection ranges received concurrently into
disjoint slices of the created buffer. The magic rides the same 16-byte
slot as an object id (2^-128 collision: ids are random bytes).
"""

from __future__ import annotations

import socket
import struct
import threading
import time as _time

from ray_tpu_torch.core import chaos
from ray_tpu_torch.core import task_events as _task_events
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.retry import Backoff

_SIZES = struct.Struct("<QQ")

# 16-byte request discriminator for range pulls (same slot as an id).
RANGE_MAGIC = b"\xffRAYTPU_RANGE_1\xff"
_RANGE_REQ = struct.Struct("<QQ")

# recv_into slice bound: large enough to amortize syscalls, small enough
# that the kernel keeps draining the window while we copy (pipelining).
_RECV_CHUNK = 1 << 20
_SOCK_BUF = 4 << 20


# ---------------- server ----------------


class PeerServer:
    """Handle over a running peer server: `.port`, `.kind` ("native" /
    "python"), `.stop()`. Stop MUST run before the arena is unmapped —
    native threads read it raw (no BufferError safety net)."""

    def __init__(self, port: int, kind: str, stop_fn):
        self.port = port
        self.kind = kind
        self._stop = stop_fn

    def stop(self, timeout_ms: int = 2000):
        if self._stop is not None:
            stop, self._stop = self._stop, None
            try:
                stop(timeout_ms)
            except Exception:  # noqa: BLE001 — teardown best effort
                pass


def start_peer_server(store, bind_ip: str, port: int = 0) -> PeerServer:
    """Start the node's peer server bound to `store`'s arena."""
    import sys
    try:
        import ctypes

        from ray_tpu_torch._native.build import load_native
        lib = load_native("peer_server", sources=("object_store.cpp",))
        lib.peer_server_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.peer_server_start.restype = ctypes.c_int
        lib.peer_server_stop.argtypes = [ctypes.c_void_p, ctypes.c_int]
        handle = ctypes.c_void_p()
        got = lib.peer_server_start(store._base, bind_ip.encode(), port,
                                    ctypes.byref(handle))
        if got > 0:
            return PeerServer(
                got, "native",
                lambda t_ms: lib.peer_server_stop(handle, t_ms))
    except Exception as e:  # noqa: BLE001 — toolchain missing/build failed
        print(f"ray_tpu_torch: native peer server unavailable ({e!r}); "
              "falling back to the Python (GIL-bound) transfer path",
              file=sys.stderr)
    return _start_python_peer_server(store, bind_ip, port)


def _start_python_peer_server(store, bind_ip: str, port: int = 0) -> PeerServer:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((bind_ip, port))
    srv.listen(64)
    conns: set = set()
    lock = threading.Lock()

    def accept_loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with lock:
                conns.add(conn)

            def serve(conn=conn):
                try:
                    _serve_conn(store, conn)
                finally:
                    with lock:
                        conns.discard(conn)

            threading.Thread(target=serve, daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True,
                     name="rtpu-peer-srv").start()

    def stop(_t_ms):
        try:
            srv.close()
        except OSError:
            pass
        with lock:
            live = list(conns)
        for c in live:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    return PeerServer(srv.getsockname()[1], "python", stop)


def _serve_conn(store, conn: socket.socket):
    """Python fallback for one peer connection (same wire protocol)."""
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        while True:
            oid = _recv_exact(conn, 16)
            if oid is None:
                return
            want_off = 0
            want_len = None
            if oid == RANGE_MAGIC:
                req = _recv_exact(conn, 16 + _RANGE_REQ.size)
                if req is None:
                    return
                oid = req[:16]
                want_off, want_len = _RANGE_REQ.unpack(req[16:])
            res = None
            try:
                res = store.get_raw(ObjectID(oid), timeout=0)
            except Exception:  # noqa: BLE001 — absent => ok=0
                pass
            if res is None:
                # 2 = created-but-unsealed: client retries shortly (the
                # old blob path waited server-side for in-flight seals).
                state = store.probe(ObjectID(oid))
                conn.sendall(b"\x02" if state == "unsealed" else b"\x00")
                continue
            data, meta = res
            try:
                s_off = min(want_off, len(data))
                s_len = len(data) - s_off
                if want_len is not None and want_len < s_len:
                    s_len = want_len
                conn.sendall(b"\x01" + _SIZES.pack(len(data), len(meta)))
                if meta:
                    conn.sendall(meta)
                if s_len:
                    conn.sendall(data[s_off : s_off + s_len])
            finally:
                data.release()
                store.release(ObjectID(oid))
    except OSError:
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


# ---------------- client ----------------


class _ConnCache:
    """Idle persistent connections to peers, keyed by (host, port).

    `checkout` pops an idle connection (or dials a fresh one); the caller
    has exclusive use until it either `checkin`s it (clean completion) or
    closes it (any error/EOF — never return a connection in an unknown
    protocol state). At most `cap` idle connections are retained per
    addr; extras are closed on checkin."""

    def __init__(self):
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def _cap(self) -> int:
        try:
            from ray_tpu_torch.core.config import get_config
            return get_config().objxfer_conn_cache_size
        except Exception:  # noqa: BLE001 — config not importable
            return 4

    def checkout(self, addr, timeout: float):
        key = tuple(addr)
        with self._lock:
            pool = self._idle.get(key)
            if pool:
                s = pool.pop()
                s.settimeout(timeout)
                return s, True
        s = socket.create_connection(key, timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            try:
                s.setsockopt(socket.SOL_SOCKET, opt, _SOCK_BUF)
            except OSError:
                pass
        return s, False

    def checkin(self, addr, s):
        cap = self._cap()
        key = tuple(addr)
        with self._lock:
            pool = self._idle.setdefault(key, [])
            if len(pool) < cap:
                pool.append(s)
                return
        try:
            s.close()
        except OSError:
            pass

    def drop_addr(self, addr):
        """Close every idle connection to a peer (node death)."""
        with self._lock:
            pool = self._idle.pop(tuple(addr), [])
        for s in pool:
            try:
                s.close()
            except OSError:
                pass

    def clear(self):
        with self._lock:
            pools, self._idle = list(self._idle.values()), {}
        for pool in pools:
            for s in pool:
                try:
                    s.close()
                except OSError:
                    pass


_conn_cache = _ConnCache()


def _recv_exact(sock: socket.socket, n: int):
    chunks = []
    while n:
        try:
            c = sock.recv(n)
        except OSError:
            return None
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_into_exact(sock: socket.socket, view) -> bool:
    """Chunked drain straight into the destination buffer: bounded
    recv_into slices keep the kernel refilling the (enlarged) receive
    window while the previous chunk copies out — the pipelined half of
    the large-transfer path."""
    off, n = 0, len(view)
    while off < n:
        try:
            r = sock.recv_into(view[off:], min(n - off, _RECV_CHUNK))
        except OSError:
            return False
        if r == 0:
            return False
        off += r
    return True


def _create_for_write(store, oid: bytes, size: int, meta: bytes):
    """Create the destination object, handling the concurrent-pull race:
    returns the ObjectBuffer, or None when another puller already
    materialized (or is materializing) the object."""
    from ray_tpu_torch.core.status import RayTpuError
    if store.contains(ObjectID(oid)):
        return None
    try:
        return store.create(ObjectID(oid), size, meta=meta)
    except RayTpuError:
        if store.contains(ObjectID(oid)):
            return None
        res = None
        try:
            res = store.get_raw(ObjectID(oid), timeout=10.0)  # winner seals
        except Exception:  # noqa: BLE001 — winner aborted
            pass
        if res is not None:
            res[0].release()
            store.release(ObjectID(oid))
            return None
        raise


def _pull_once(store, s, oid: bytes, unsealed_wait_s: float,
               absent_wait_s: float):
    """One pull on an already-connected socket. Returns (found, clean):
    `clean` means the stream sits at a message boundary and the
    connection may be cached for reuse."""
    import time
    start = time.monotonic()
    unsealed_deadline = start + unsealed_wait_s
    absent_deadline = start + absent_wait_s
    # Status-2/absent polling rides the shared jittered policy
    # (core/retry.py) instead of the old hand-rolled constants.
    bo = Backoff(base_s=0.001, cap_s=0.05)
    while True:
        s.sendall(oid)
        ok = _recv_exact(s, 1)
        now = time.monotonic()
        if ((ok == b"\x02" and now < unsealed_deadline)
                or (ok == b"\x00" and now < absent_deadline)):
            time.sleep(min(bo.next_interval(),
                           max(0.0, (unsealed_deadline if ok == b"\x02"
                                     else absent_deadline) - now)))
            continue
        break
    if ok in (b"\x00", b"\x02"):
        return False, True  # answered, just not available
    if ok != b"\x01":
        return False, False  # EOF / protocol error
    sizes = _recv_exact(s, _SIZES.size)
    if sizes is None:
        return False, False
    data_size, meta_size = _SIZES.unpack(sizes)
    meta = b""
    if meta_size:
        meta = _recv_exact(s, meta_size)
        if meta is None:
            return False, False
    buf = _create_for_write(store, oid, data_size, meta)
    if buf is None:
        # A concurrent pull won the race; still drain OUR copy off the
        # stream so the connection stays at a message boundary.
        left = data_size
        while left:
            got = _recv_exact(s, min(left, 1 << 20))
            if got is None:
                return True, False
            left -= len(got)
        return True, True
    try:
        if not _recv_into_exact(s, buf.data):
            buf.abort()
            return False, False
        buf.seal()
    except BaseException:
        buf.abort()
        raise
    return True, True


def _recv_range_header(s, oid: bytes, unsealed_wait_s: float,
                       absent_wait_s: float, length: int):
    """Issue range request(s) for [0, length) with the same retry
    semantics as _pull_once's availability loop. Returns
    (ok_byte, data_size, meta_size, meta) — meta is None on protocol
    error (connection must be dropped)."""
    import time
    start = time.monotonic()
    unsealed_deadline = start + unsealed_wait_s
    absent_deadline = start + absent_wait_s
    bo = Backoff(base_s=0.001, cap_s=0.05)
    while True:
        s.sendall(RANGE_MAGIC + oid + _RANGE_REQ.pack(0, length))
        ok = _recv_exact(s, 1)
        now = time.monotonic()
        if ((ok == b"\x02" and now < unsealed_deadline)
                or (ok == b"\x00" and now < absent_deadline)):
            time.sleep(min(bo.next_interval(),
                           max(0.0, (unsealed_deadline if ok == b"\x02"
                                     else absent_deadline) - now)))
            continue
        break
    if ok in (b"\x00", b"\x02"):
        return ok, 0, 0, b""
    if ok != b"\x01":
        return ok, 0, 0, None
    sizes = _recv_exact(s, _SIZES.size)
    if sizes is None:
        return b"", 0, 0, None
    data_size, meta_size = _SIZES.unpack(sizes)
    meta = b""
    if meta_size:
        meta = _recv_exact(s, meta_size)
        if meta is None:
            return b"", 0, 0, None
    return b"\x01", data_size, meta_size, meta


def _range_into(s, oid: bytes, offset: int, view) -> bool:
    """Issue one range request on a connected socket and drain the slice
    straight into `view`. True only when the full range landed and the
    connection sits at a message boundary."""
    if chaos.site("objxfer.range.reset"):
        try:
            s.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        return False  # injected mid-stripe stream death
    s.sendall(RANGE_MAGIC + oid + _RANGE_REQ.pack(offset, len(view)))
    rok = _recv_exact(s, 1)
    if rok != b"\x01":
        return False
    sizes = _recv_exact(s, _SIZES.size)
    if sizes is None:
        return False
    _dsz, msz = _SIZES.unpack(sizes)
    if msz and _recv_exact(s, msz) is None:
        return False
    return _recv_into_exact(s, view)


def _pull_range_worker(store, addr, oid: bytes, view, offset: int,
                       timeout: float, result: list, idx: int):
    """One extra stream of a striped pull: checkout a connection, pull
    [offset, offset+len(view)) straight into the buffer slice."""
    ok = False
    s = None
    try:
        s, _reused = _conn_cache.checkout(addr, timeout)
        ok = _range_into(s, oid, offset, view)
    except OSError:
        pass
    finally:
        try:
            view.release()
        except BufferError:
            pass
        if s is not None:
            if ok:
                _conn_cache.checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass
    result[idx] = ok


def _pull_range_fresh(store, addr, oid: bytes, buf, pos: int, ln: int,
                      timeout: float) -> bool:
    """Recovery path: re-pull ONE failed range on a brand-new dial (the
    per-addr cache may be poisoned by whatever killed the stream). The
    fresh connection is cached on success — it is the healthiest link we
    have to this peer."""
    view = buf.data[pos : pos + ln]
    s = None
    ok = False
    try:
        try:
            s = socket.create_connection(tuple(addr), timeout=timeout)
        except OSError:
            return False
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ok = _range_into(s, oid, pos, view)
    except OSError:
        ok = False
    finally:
        try:
            view.release()
        except BufferError:
            pass
        if s is not None:
            if ok:
                _conn_cache.checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass
    return ok


# Striped-pull health per peer address: consecutive range-stream failures.
# At `objxfer_stream_fail_limit` the client degrades that peer to
# single-stream pulls until a striped pull completes clean — a peer whose
# extra connections keep dying (conntrack limits, flaky NIC, an LB in the
# path) stops paying the stripe setup tax just to fail it.
_stripe_fails: dict = {}
_stripe_lock = threading.Lock()


def _stripe_fail_limit() -> int:
    try:
        from ray_tpu_torch.core.config import get_config
        return get_config().objxfer_stream_fail_limit
    except Exception:  # noqa: BLE001 — config not importable
        return 3


def _note_stripe_result(addr, failures: int):
    key = tuple(addr)
    with _stripe_lock:
        if failures:
            _stripe_fails[key] = _stripe_fails.get(key, 0) + failures
        else:
            _stripe_fails.pop(key, None)


def _stripes_degraded(addr) -> bool:
    with _stripe_lock:
        return _stripe_fails.get(tuple(addr), 0) >= _stripe_fail_limit()


def _note_degraded_success(addr):
    """A single-stream pull in degraded mode completed clean: decay the
    failure count so striping is re-probed after `limit` clean pulls
    (degrade must not be a one-way door — the flaky middlebox may have
    been replaced)."""
    key = tuple(addr)
    with _stripe_lock:
        n = _stripe_fails.get(key, 0)
        if n > 1:
            _stripe_fails[key] = n - 1
        else:
            _stripe_fails.pop(key, None)


def _pull_striped(store, addr, s, oid: bytes, unsealed_wait_s: float,
                  absent_wait_s: float, streams: int, first_len: int,
                  timeout: float):
    """Range-protocol pull: the first request doubles as the size probe
    and carries the first `first_len` bytes; anything beyond stripes
    over `streams` connections received concurrently into disjoint
    slices of the created buffer. Same (found, clean) contract as
    _pull_once."""
    ok, data_size, _msz, meta = _recv_range_header(
        s, oid, unsealed_wait_s, absent_wait_s, first_len)
    if meta is None:
        return False, False
    if ok in (b"\x00", b"\x02"):
        return False, True  # answered, just not available
    got = min(first_len, data_size)
    primary_clean = True  # False once the primary conn's own stripe fails
    buf = _create_for_write(store, oid, data_size, meta)
    if buf is None:
        # A concurrent pull won the race; drain OUR bytes off the stream
        # so the connection stays at a message boundary.
        left = got
        while left:
            c = _recv_exact(s, min(left, 1 << 20))
            if c is None:
                return True, False
            left -= len(c)
        return True, True
    try:
        head_view = buf.data[:got]
        try:
            if not _recv_into_exact(s, head_view):
                buf.abort()
                return False, False
        finally:
            head_view.release()
        if data_size > got:
            rest = data_size - got
            n = max(1, min(streams, (rest + first_len - 1) // first_len))
            per = (rest + n - 1) // n
            threads = []
            results = [False] * n
            ranges = []
            try:
                pos = got
                for i in range(n):
                    ln = min(per, data_size - pos)
                    ranges.append((pos, ln))
                    view = buf.data[pos : pos + ln]
                    if i < n - 1:
                        t = threading.Thread(
                            target=_pull_range_worker,
                            args=(store, addr, oid, view, pos, timeout,
                                  results, i), daemon=True)
                        t.start()
                        threads.append(t)
                    else:
                        # Last stripe rides THIS connection (open, warm).
                        try:
                            try:
                                results[i] = _range_into(s, oid, pos, view)
                            except OSError:
                                results[i] = False
                        finally:
                            view.release()
                    pos += ln
            finally:
                # Writers must be off the buffer before any abort can
                # recycle its arena space.
                for t in threads:
                    t.join()
            primary_clean = results[-1]
            n_failed = results.count(False)
            if n_failed:
                # Partial failure: a single dead stream no longer aborts
                # the whole get. Re-pull ONLY the failed ranges, each on
                # a fresh dial (sequential — this is the recovery path,
                # not the fast path); give up only when a retry fails
                # too. The per-addr health counter degrades chronically
                # flaky peers to single-stream pulls.
                for i, ok_i in enumerate(results):
                    if ok_i:
                        continue
                    pos_i, ln_i = ranges[i]
                    if not _pull_range_fresh(store, addr, oid, buf,
                                             pos_i, ln_i, timeout):
                        _note_stripe_result(addr, n_failed)
                        buf.abort()
                        # primary conn is at a boundary only if ITS
                        # stripe worked
                        return False, results[-1]
            _note_stripe_result(addr, n_failed)
        buf.seal()
    except BaseException:
        buf.abort()
        raise
    return True, primary_clean


def fetch_from_peer(store, addr, oid: bytes, timeout: float = 60.0,
                    unsealed_wait_s: float = 5.0,
                    absent_wait_s: float = 0.0) -> bool:
    """Pull one object from a peer's port into `store`. Returns success.

    Connections come from the per-addr cache (one dial per peer, not per
    pull); a pull that ends off a message boundary closes its connection
    instead of returning it. A CACHED connection that fails before any
    byte of this pull arrived is retried once on a fresh dial — the peer
    may simply have restarted since the connection was cached.

    A created-but-unsealed object at the source (reply 2) is retried on the
    same connection for up to `unsealed_wait_s` — a concurrent writer there
    is about to seal it. `absent_wait_s` > 0 also polls a missing object
    (reply 0) on the SAME connection — the p2p collectives wait for a peer
    that has not published yet, and a reconnect per poll would churn
    thousands of throwaway TCP connections per op."""
    if store.contains(ObjectID(oid)):
        return True
    chaos.delay("objxfer.fetch.delay")
    tev = _task_events.ring()
    t0 = _time.time() if tev.enabled else 0.0

    def _span(found: bool):
        if tev.enabled:
            tev.emit_span("obj_pull", oid.hex()[:12], t0,
                          _time.time() - t0, ok=found,
                          peer=f"{addr[0]}:{addr[1]}")

    try:
        from ray_tpu_torch.core.config import get_config
        cfg = get_config()
        streams = cfg.objxfer_streams
        stream_min = cfg.objxfer_stream_min_bytes
    except Exception:  # noqa: BLE001 — config not importable (bare tests)
        streams, stream_min = 1, 32 << 20
    degraded = streams > 1 and _stripes_degraded(addr)
    if degraded:
        streams = 1  # chronic range-stream failures: single-stream mode
    for attempt in range(2):
        try:
            s, reused = _conn_cache.checkout(addr, timeout)
        except OSError:
            _span(False)
            return False
        if chaos.site("objxfer.pull.reset"):
            try:  # injected dead connection: the dirty-failure retry path
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        clean = False
        try:
            if streams > 1:
                found, clean = _pull_striped(
                    store, addr, s, oid, unsealed_wait_s, absent_wait_s,
                    streams, max(1 << 20, stream_min), timeout)
            else:
                found, clean = _pull_once(store, s, oid, unsealed_wait_s,
                                          absent_wait_s)
        except OSError:
            found = False
        finally:
            if clean:
                _conn_cache.checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass
        if found or clean:
            if found and degraded:
                _note_degraded_success(addr)  # decay toward re-striping
            _span(found)
            return found
        if not reused:
            _span(False)
            return False
        # dirty failure on a cached conn: retry once on a fresh dial
    _span(False)
    return False


def fetch_many_from_peer(store, addr, oids: list, timeout: float = 60.0,
                         unsealed_wait_s: float = 5.0) -> dict:
    """Pull many objects from ONE peer over one checked-out connection —
    request/response per object with no per-object dial, checkout, or
    head round trip (the vectored half of the exchange reduce fetch;
    pieces are small, so single-stream pulls are the right shape).
    Returns {oid: found}. A dirty failure mid-batch falls back to
    per-object fetch_from_peer (fresh dial, stripe-capable) for the
    remainder, so one dead connection degrades, never loses objects."""
    out: dict = {}
    todo: list = []
    for oid in oids:
        if store.contains(ObjectID(oid)):
            out[oid] = True
        else:
            todo.append(oid)
    if not todo:
        return out
    chaos.delay("objxfer.fetch.delay")
    tev = _task_events.ring()
    t0 = _time.time() if tev.enabled else 0.0
    s = None
    clean = True
    try:
        s, _reused = _conn_cache.checkout(addr, timeout)
    except OSError:
        s = None
    if s is not None:
        if chaos.site("objxfer.pull.reset"):
            try:  # injected dead connection: the per-object fallback path
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            for oid in todo:
                try:
                    found, clean = _pull_once(store, s, oid,
                                              unsealed_wait_s, 0.0)
                except OSError:
                    found, clean = False, False
                out[oid] = found
                if not clean:
                    break
        finally:
            if clean:
                _conn_cache.checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass
    for oid in todo:
        if not out.get(oid):
            out[oid] = fetch_from_peer(store, addr, oid, timeout,
                                       unsealed_wait_s)
    if tev.enabled:
        tev.emit_span("obj_pull_many", f"{len(todo)} objs", t0,
                      _time.time() - t0,
                      ok=all(out.get(o) for o in todo),
                      peer=f"{addr[0]}:{addr[1]}")
    return out


# ---------------- blob helpers (spill restore, tests) ----------------


def write_blob(store, oid: bytes, blob, meta: bytes = b"") -> None:
    """Store one raw serialized object blob (idempotent). `meta` carries
    the tagged-object meta for arrow/tensor/cross-language layouts — a
    spill restore that dropped it would re-seal the bytes as the default
    pickle layout."""
    buf = _create_for_write(store, oid, len(blob), meta)
    if buf is None:
        return
    try:
        buf.data[:] = blob
        buf.seal()
    except BaseException:
        buf.abort()
        raise
