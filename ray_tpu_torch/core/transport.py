"""Framed message transport over unix sockets.

Parity: reference `src/ray/rpc/` (GrpcServer/GrpcClient) — but single-node IPC
here is a length-prefixed pickle frame over a socketpair, which is the latency
floor for Python peers; the multi-node path (ray_tpu_torch.core.cluster) layers the
same frames over TCP. Fault-injection hooks (`testing_rpc_failure`,
`testing_delay_us` config, parity `src/ray/rpc/rpc_chaos.h:23`) live here so
every message path is chaos-testable.

The agent<->agent ctrl plane (peer_exec/peer_done direct actor calls, and
the lease-spillback frames `lease_spill` / the head-bound `lease_spilled`
delta) rides these same frames over per-agent-pair TCP channels dialed
with `dial()` below; chaos specs key on those op names like any other.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import random
import socket
import struct
import threading
import time

from ray_tpu_torch.core import chaos

_HDR = struct.Struct("<Q")


class ChaosInjector:
    """Drops or delays messages by op name, per config flags."""

    def __init__(self, failure_spec: str = "", delay_spec: str = ""):
        self._fail: dict[str, int] = {}
        self._delay: dict[str, tuple[float, float]] = {}
        for part in filter(None, failure_spec.split(",")):
            meth, n = part.split("=")
            self._fail[meth] = int(n)
        for part in filter(None, delay_spec.split(",")):
            meth, rng = part.split("=")
            lo, hi = rng.split(":")
            self._delay[meth] = (float(lo) / 1e6, float(hi) / 1e6)

    def maybe_drop(self, op: str) -> bool:
        left = self._fail.get(op)
        if left:
            self._fail[op] = left - 1
            return True
        return False

    def maybe_delay(self, op: str):
        rng = self._delay.get(op)
        if rng:
            time.sleep(random.uniform(*rng))


_chaos: ChaosInjector | None = None


def _decode_proto(payload: bytes):
    try:
        from ray_tpu_torch.core import proto_wire
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            "peer sent a protobuf control frame but this process has no "
            "usable protobuf runtime") from e
    return proto_wire.from_wire(payload)


_proto_ops = None  # the ops proto_wire frames; empty without protobuf


def _is_proto_op(op) -> bool:
    # Lazy import: keep transport importable before the runtime package
    # wiring is complete (workers import this very early). Looked up once:
    # without a protobuf runtime every frame is pickle-framed.
    global _proto_ops
    if _proto_ops is None:
        try:
            from ray_tpu_torch.core.proto_wire import _PROTO_OPS
        except ImportError:  # protobuf runtime missing
            _PROTO_OPS = frozenset()
        _proto_ops = _PROTO_OPS
    return op in _proto_ops


def get_chaos() -> ChaosInjector:
    global _chaos
    if _chaos is None:
        from ray_tpu_torch.core.config import get_config
        cfg = get_config()
        _chaos = ChaosInjector(cfg.testing_rpc_failure, cfg.testing_delay_us)
    return _chaos


# Frame: <Q payload_len><I nbufs>[<Q buf_len>...]<payload><buffers...>
# Out-of-band pickle-5 buffers (numpy arrays, memoryviews from the shm
# store) travel unpickled — no copy into the pickle stream on send.
# The nbufs MSB marks a PROTOBUF payload (an AgentFrame from
# ray_tpu_torch/protocol/raytpu.proto): language-neutral control messages ride
# the schema; pickle remains only for Python object payloads.
_NBUF = struct.Struct("<I")
_BLEN = struct.Struct("<Q")
_PROTO_FLAG = 0x80000000


def _load_buf(b):
    return b if isinstance(b, memoryview) else memoryview(b)


def enable_nodelay(sock: socket.socket):
    """Nagle-off for TCP control links: frames are already write-combined
    at the sender (send_many/sendmsg below), so Nagle only adds delayed-ACK
    stalls to small control frames. No-op for unix sockets."""
    try:
        if sock.family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, ValueError):
        pass


def dial(addr, timeout: float | None = None) -> socket.socket:
    """Connect a control channel to `addr` (host, port) with Nagle off —
    the one way every ctrl-plane dial (agent<->agent peer channels, the
    lease-spillback hop) should open a TCP link. Raises OSError on
    failure; callers own their fallback policy. The default timeout is
    the `peer_dial_timeout_s` config knob."""
    if timeout is None:
        try:
            from ray_tpu_torch.core.config import get_config
            timeout = get_config().peer_dial_timeout_s
        except Exception:  # noqa: BLE001 — config not importable
            timeout = 5.0
    if chaos.site("transport.dial.fail"):
        raise OSError("chaos: transport.dial.fail")
    sock = socket.create_connection(tuple(addr), timeout=timeout)
    enable_nodelay(sock)
    return sock


# Linux UIO_MAXIOV; sendmsg with more iovecs fails with EMSGSIZE.
_IOV_MAX = 1024


def sendmsg_all(sock: socket.socket, parts: list):
    """Vectored sendall: ship a frame batch (headers, payloads, raw
    buffers) in as few syscalls as the iovec limit allows, WITHOUT copying
    large buffers into a joined blob. Advances across partial writes."""
    bufs = []
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.nbytes:
            bufs.append(mv.cast("B") if mv.format != "B" or mv.ndim != 1
                        else mv)
    i = 0
    while i < len(bufs):
        try:
            n = sock.sendmsg(bufs[i:i + _IOV_MAX])
        except InterruptedError:
            continue
        while i < len(bufs) and n >= bufs[i].nbytes:
            n -= bufs[i].nbytes
            i += 1
        if n:
            bufs[i] = bufs[i][n:]


class _MsgPickler(pickle.Pickler):
    """Routes bare memoryviews (task-arg/result buffers riding inside specs)
    out-of-band instead of failing — pickle refuses raw memoryviews."""

    def reducer_override(self, obj):
        if isinstance(obj, memoryview):
            return (_load_buf, (pickle.PickleBuffer(obj),))
        return NotImplemented


def _carries_raw_buffers(msg) -> bool:
    """Cheap probe for bare memoryviews in the known message shapes (specs
    with out-of-band buffers, 'done' result tuples) — those need the custom
    pickler, and attempting the fast path first would serialize the payload
    twice."""
    if type(msg) is not tuple:
        return False
    for x in msg:
        if isinstance(x, memoryview):
            return True
        bufs = getattr(x, "buffers", None)  # TaskSpec / ActorCreationSpec
        if bufs or getattr(x, "inline_deps", None):
            return True
        if type(x) is list:
            # 'done' outs: [(rid, status, payload, bufs)]; 'obj' pushes
            # carry the buffer list itself: ('obj', oid, status, payload,
            # [memoryview, ...]); 'batch' frames nest ('exec', spec) tuples
            # whose specs hold out-of-band buffers.
            for e in x:
                if isinstance(e, memoryview):
                    return True
                if type(e) is tuple:
                    for v in e:
                        if isinstance(v, (memoryview, list)) and v:
                            return True
                        if (getattr(v, "buffers", None)
                                or getattr(v, "inline_deps", None)):
                            return True
        elif type(x) is tuple:
            # ('stream_item', task_id, (rid, status, payload, bufs)) — the
            # entry tuple is a direct element of msg; missing it here means
            # every large streaming yield pickles twice (fast path raises
            # TypeError on the memoryview, then re-serializes).
            for v in x:
                if isinstance(v, memoryview) or (
                        type(v) is list and v and
                        any(isinstance(b, memoryview) for b in v)):
                    return True
    return False


def _encode(msg) -> list:
    import io
    pbufs: list[pickle.PickleBuffer] = []
    if not _carries_raw_buffers(msg):
        try:
            # C pickler fast path; raises TypeError on bare memoryviews the
            # probe missed — only the custom pickler routes those out-of-band.
            payload = pickle.dumps(msg, protocol=5,
                                   buffer_callback=pbufs.append)
            raws = [b.raw() for b in pbufs]
            parts = [_HDR.pack(len(payload)), _NBUF.pack(len(raws))]
            parts += [_BLEN.pack(r.nbytes) for r in raws]
            parts.append(payload)
            parts += raws
            return parts
        except (TypeError, AttributeError, pickle.PicklingError):
            pbufs = []
    f = io.BytesIO()
    _MsgPickler(f, protocol=5, buffer_callback=pbufs.append).dump(msg)
    payload = f.getvalue()
    raws = [b.raw() for b in pbufs]
    parts = [_HDR.pack(len(payload)), _NBUF.pack(len(raws))]
    parts += [_BLEN.pack(r.nbytes) for r in raws]
    parts.append(payload)
    parts += raws
    return parts


def encode_frame(msg) -> bytes:
    """One complete outer frame as a self-contained byte string — for
    fan-out control messages (the head's cluster-view broadcast) that
    are pickled ONCE and sendall'd to N destinations raw. Out-of-band
    buffers are joined in-band (control messages carry none worth
    zero-copying)."""
    return b"".join(bytes(p) if not isinstance(p, bytes) else p
                    for p in _encode(msg))


def encode_payload(obj) -> bytes:
    """Pickle one object to a SELF-CONTAINED byte string (out-of-band
    buffers serialized in-band): the raw-spec payload of the native
    scheduling plane's node_exec_raw / exec_raw frames, where the spec
    bytes must survive opaque relays through the C++ ledger."""
    try:
        return pickle.dumps(obj, protocol=5)
    except (TypeError, AttributeError, pickle.PicklingError):
        import io
        f = io.BytesIO()
        _MsgPickler(f, protocol=5).dump(obj)
        return f.getvalue()


def _chaos_trunc_send(sock: socket.socket, blob,
                      lock: threading.Lock | None):
    """transport.send.trunc fired: ship HALF the frame, then tear the
    connection — the receiver sees a torn frame followed by EOF, exactly
    the wire state a sender SIGKILLed mid-sendall leaves behind."""
    ctx = lock if lock is not None else _NULL_CTX
    with ctx:
        try:
            sock.sendall(bytes(blob[: max(1, len(blob) // 2)]))
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    raise ConnectionResetError("chaos: transport.send.trunc")


def send_msg(sock: socket.socket, msg, lock: threading.Lock | None = None):
    op = msg[0] if isinstance(msg, tuple) and msg else ""
    injector = get_chaos()
    injector.maybe_delay(op)
    if injector.maybe_drop(op):
        return
    trunc = False
    if chaos._armed is not None:
        chaos.delay("transport.send.delay")
        if chaos.site("transport.send.drop"):
            return
        trunc = chaos.site("transport.send.trunc")
    if op and _is_proto_op(op):
        from ray_tpu_torch.core import proto_wire
        payload = proto_wire.to_wire(msg)
        if payload is not None:
            head = (_HDR.pack(len(payload))
                    + _NBUF.pack(_PROTO_FLAG) + payload)
            if trunc:
                _chaos_trunc_send(sock, head, lock)
            if lock:
                with lock:
                    sock.sendall(head)
            else:
                sock.sendall(head)
            return
    parts = _encode(msg)
    # Header/lengths coalesce into one small blob; raw buffers ride the
    # same vectored sendmsg as-is — one syscall for the whole frame, no
    # second copy of large tensors.
    head = b"".join(p for p in parts if isinstance(p, bytes))
    bufs = [p for p in parts if not isinstance(p, bytes)]
    if trunc:
        _chaos_trunc_send(sock, head, lock)
    if lock:
        with lock:
            if bufs:
                sendmsg_all(sock, [head, *bufs])
            else:
                sock.sendall(head)
    else:
        if bufs:
            sendmsg_all(sock, [head, *bufs])
        else:
            sock.sendall(head)


def send_many(sock: socket.socket, msgs: list,
              lock: threading.Lock | None = None):
    """Send several frames in as few syscalls as possible: consecutive
    headers/payloads and small buffers join into one blob, large raw
    buffers ride the same vectored sendmsg uncopied, and the whole batch
    flushes as one writev-style call per _BATCH_CAP bytes. Frame order and
    per-frame chaos hooks match N send_msg calls exactly."""
    out: list = []     # pending iovec: joined small blobs + raw buffers
    small: list = []   # run of small parts awaiting a join
    pending = 0

    def pack_small():
        if small:
            out.append(small[0] if len(small) == 1 else b"".join(small))
            small.clear()

    def flush():
        nonlocal pending
        pack_small()
        if out:
            if len(out) == 1 and isinstance(out[0], bytes):
                sock.sendall(out[0])
            else:
                sendmsg_all(sock, out)
            out.clear()
            pending = 0

    injector = get_chaos()
    ctx = lock if lock is not None else _NULL_CTX
    with ctx:
        for msg in msgs:
            op = msg[0] if isinstance(msg, tuple) and msg else ""
            injector.maybe_delay(op)
            if injector.maybe_drop(op):
                continue
            if chaos._armed is not None:
                chaos.delay("transport.send.delay")
                if chaos.site("transport.send.drop"):
                    continue
            if op and _is_proto_op(op):
                from ray_tpu_torch.core import proto_wire
                payload = proto_wire.to_wire(msg)
                if payload is not None:
                    small.append(_HDR.pack(len(payload))
                                 + _NBUF.pack(_PROTO_FLAG) + payload)
                    pending += len(payload)
                    if pending >= _BATCH_CAP:
                        flush()
                    continue
            for p in _encode(msg):
                n = len(p) if isinstance(p, bytes) else p.nbytes
                if isinstance(p, bytes) or n < (64 << 10):
                    small.append(p if isinstance(p, bytes) else bytes(p))
                    pending += n
                else:
                    # Large buffer: its own iovec entry, never copied.
                    pack_small()
                    out.append(p)
                    pending += n
                if pending >= _BATCH_CAP:
                    flush()
        flush()


# Flush threshold for send_many batches: large enough to amortize syscalls
# under fan-out bursts, small enough to keep peak pinned-buffer residency
# bounded while frames stream out.
_BATCH_CAP = 1 << 20
_NULL_CTX = contextlib.nullcontext()


def recv_msg(sock: socket.socket):
    """Blocking receive of one frame; returns None on clean EOF."""
    if chaos._armed is not None:
        chaos.delay("transport.recv.delay")
        if chaos.site("transport.recv.reset"):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return None  # the EOF contract: caller runs its death path
    hdr = _recv_exact(sock, _HDR.size + _NBUF.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack_from(hdr, 0)
    (nbufs,) = _NBUF.unpack_from(hdr, _HDR.size)
    if nbufs & _PROTO_FLAG:
        payload = _recv_exact(sock, n)
        if payload is None:
            return None
        return _decode_proto(payload)
    blens = []
    if nbufs:
        lens = _recv_exact(sock, _BLEN.size * nbufs)
        if lens is None:
            return None
        blens = [_BLEN.unpack_from(lens, i * _BLEN.size)[0]
                 for i in range(nbufs)]
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    bufs = []
    for bl in blens:
        b = _recv_exact(sock, bl)
        if b is None:
            return None
        bufs.append(b)
    return pickle.loads(payload, buffers=bufs)


def _recv_exact(sock: socket.socket, n: int):
    chunks = []
    while n:
        try:
            chunk = sock.recv(n)
        except (ConnectionResetError, OSError):
            return None
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class FrameBuffer:
    """Incremental frame decoder for the driver's selector loop."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes):
        self._buf.extend(data)

    def frames(self):
        out = []
        while True:
            pre = _HDR.size + _NBUF.size
            if len(self._buf) < pre:
                break
            (n,) = _HDR.unpack_from(self._buf, 0)
            (nbufs,) = _NBUF.unpack_from(self._buf, _HDR.size)
            if nbufs & _PROTO_FLAG:
                if len(self._buf) < pre + n:
                    break
                payload = bytes(self._buf[pre:pre + n])
                del self._buf[:pre + n]
                out.append(_decode_proto(payload))
                continue
            lens_end = pre + _BLEN.size * nbufs
            if len(self._buf) < lens_end:
                break
            blens = [_BLEN.unpack_from(self._buf, pre + i * _BLEN.size)[0]
                     for i in range(nbufs)]
            total = lens_end + n + sum(blens)
            if len(self._buf) < total:
                break
            payload = bytes(self._buf[lens_end:lens_end + n])
            bufs = []
            off = lens_end + n
            for bl in blens:
                bufs.append(bytes(self._buf[off:off + bl]))
                off += bl
            del self._buf[:total]
            out.append(pickle.loads(payload, buffers=bufs))
        return out


def make_socketpair():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    return a, b


def socket_from_fd(fd: int) -> socket.socket:
    return socket.socket(socket.AF_UNIX, socket.SOCK_STREAM, fileno=fd)


def free_tcp_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
