"""Mutable shared-memory channels (seqlock + per-reader acks), the data
plane under compiled graphs (counterpart of
`ray_tpu/experimental/channel.py`, with torch leaves where the JAX
package's are jax leaves).

Parity: reference experimental mutable plasma objects + shm channels
(`src/ray/core_worker/experimental_mutable_object_manager.h:44`,
`python/ray/experimental/channel/shared_memory_channel.py`). One writer,
a fixed set of readers; a version seqlock (odd = write in progress) makes
reads lock-free, and per-reader ack slots give the writer backpressure (it
blocks until every reader consumed the previous value, the flow control
of the reference's mutable-object WriteAcquire waiting on ReadRelease).
Same-node only (the region is a /dev/shm mmap); cross-node edges belong to
the object plane.

Layout: [u64 version][u64 payload_len][u64 n_readers][u64 ack x 8][payload]
Each ack slot is written by exactly one reader (its last-read version), so
there are no cross-process read-modify-write races.

Two payload encodings share the seqlock:

- `Channel`: pickle the whole value (control values, small objects).
- `TensorChannel`: the tensor plane (the role NCCL channels play under
  the reference's compiled graphs, `torch_tensor_nccl_channel.py`,
  rebuilt over host shm): array leaves of the value (numpy arrays, torch
  tensors on the CPU or a card) are staged straight into the shm region
  under a fixed binary descriptor (dtype, kind, shape). Tensor bytes
  never pass through pickle; only the pytree skeleton rides a sidecar
  pickle frame. A CUDA leaf is staged with one device-to-host copy into
  its region and rebuilt with one host-to-device copy onto the reader's
  card, synchronized before the ack; a process that sees no card refuses
  it. torch leaves come back as fresh tensors; numpy leaves as read-only
  views that alias the channel (the ack deferred until `release()`, the
  reference's ReadAcquire/ReadRelease). dtypes numpy lacks (bfloat16,
  the fp8 types) cross as a same-width integer view under their torch
  name, bit-exact. A same-process registry lets co-located
  writer/reader pairs hand over the live value with no host round trip,
  guarded by a copy-on-write epoch in the frame header. For cross-node
  hops the same frame seals into the shm arena as a plain object
  (`put_tensor_object`) and the remote side pulls it over `objxfer`
  (`get_tensor_object`).
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import sys
import threading
import time
import uuid
import warnings

from ray_tpu_torch.core import task_events as _task_events

# Process-global emission ring: TensorChannel write / read-acquire spans
# land in the task-event pipeline (one flag check when it is off).
_TEV = _task_events.ring()

MAX_READERS = 8
_HDR = struct.Struct(f"<QQQ{MAX_READERS}Q")

_CLOSE = b"\x00__ray_tpu_channel_closed__"


class ChannelClosedError(RuntimeError):
    pass


class Channel:
    """One writer, n_readers consumers. The writer constructs with
    create=True; each reader opens a cursor with its assigned reader_idx."""

    def __init__(self, path: str | None = None, capacity: int = 1 << 20,
                 create: bool = False, n_readers: int = 1,
                 reader_idx: int = 0):
        if n_readers > MAX_READERS:
            raise ValueError(f"at most {MAX_READERS} readers per channel")
        shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
        self.path = path or os.path.join(
            shm_dir, f"raytpu-torch-chan_{uuid.uuid4().hex[:16]}")
        self.capacity = capacity
        self.reader_idx = reader_idx
        total = _HDR.size + capacity
        if create:
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR | os.O_EXCL,
                         0o600)
            os.ftruncate(fd, total)
        else:
            fd = os.open(self.path, os.O_RDWR)
            total = os.fstat(fd).st_size
            self.capacity = total - _HDR.size
        try:
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        if create:
            struct.pack_into("<Q", self._mm, 16, n_readers)
        self._last_version = 0

    def _hdr(self):
        vals = _HDR.unpack_from(self._mm, 0)
        return vals[0], vals[1], vals[2], vals[3:3 + MAX_READERS]

    # -- writer side --

    def _begin_write(self, length: int, timeout: float | None) -> int:
        """Win backpressure and mark the seqlock odd (write in progress).
        Returns the pre-write version; the caller stages the payload into
        the region after the header and then calls `_commit_write`."""
        if length > self.capacity:
            raise ValueError(
                f"value of {length} bytes exceeds channel capacity "
                f"{self.capacity}")
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 5e-5
        while True:  # backpressure: all readers must have consumed
            version, _, n_readers, acks = self._hdr()
            if version == 0 or all(a >= version
                                   for a in acks[:n_readers]):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"channel write blocked on slow readers ({self.path})")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)
        struct.pack_into("<Q", self._mm, 0, version + 1)  # odd: writing
        return version

    def _commit_write(self, version: int, length: int):
        struct.pack_into("<QQ", self._mm, 0, version + 2, length)

    def write(self, value, timeout: float | None = 60.0):
        self.write_bytes(pickle.dumps(value, protocol=5), timeout)

    def write_bytes(self, payload: bytes, timeout: float | None = 60.0):
        version = self._begin_write(len(payload), timeout)
        self._mm[_HDR.size:_HDR.size + len(payload)] = payload
        self._commit_write(version, len(payload))

    def close_writer(self, timeout: float | None = 10.0):
        """Signal EOF to readers. If a slow reader never acks within the
        timeout, FORCE the sentinel in (skipping backpressure): it may
        clobber the reader's last unread value, but a dropped EOF would
        leave exec loops busy-polling a dead channel forever."""
        try:
            self.write_bytes(_CLOSE, timeout)
            return
        except TimeoutError:
            pass
        except (ValueError, OSError):
            return
        try:
            version, _ = struct.unpack_from("<QQ", self._mm, 0)
            struct.pack_into("<Q", self._mm, 0, version + 1)
            self._mm[_HDR.size:_HDR.size + len(_CLOSE)] = _CLOSE
            struct.pack_into("<QQ", self._mm, 0, version + 2, len(_CLOSE))
        except (ValueError, OSError):
            pass

    # -- reader side --

    def _poll_version(self, timeout: float | None):
        """Block until a version newer than the cursor is committed;
        returns (version, length) without acking."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 5e-5
        while True:
            version, length, _n, _acks = self._hdr()
            if version > self._last_version and version % 2 == 0:
                return version, length
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel read timed out ({self.path})")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def _ack(self, version: int):
        self._last_version = version
        struct.pack_into("<Q", self._mm, 24 + 8 * self.reader_idx, version)

    def _stable(self, version: int) -> bool:
        v2, = struct.unpack_from("<Q", self._mm, 0)
        return v2 == version

    def read(self, timeout: float | None = 60.0):
        """Block until a version newer than this cursor's last read; ack it
        so the writer may proceed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            version, length = self._poll_version(remaining)
            payload = bytes(self._mm[_HDR.size:_HDR.size + length])
            if self._stable(version):  # seqlock: no concurrent write seen
                self._ack(version)
                if payload == _CLOSE:
                    raise ChannelClosedError(self.path)
                return pickle.loads(payload)
            time.sleep(5e-5)

    # -- lifecycle --

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            pass

    def unlink(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __reduce__(self):
        return (Channel, (self.path, self.capacity, False, 1,
                          self.reader_idx))


# ====================================================================
# Tensor channel: numpy and torch hops for compiled graphs
# ====================================================================

# Frame layout (inside the seqlock payload region):
#   [_TC_HDR: magic, flags, epoch, writer_pid, n_leaves, meta_len]
#   [_TC_LEAF x n_leaves: dtype16, kind, ndim, dims[6], offset, nbytes]
#   [meta pickle bytes]                    (skeleton; NO tensor bytes)
#   [leaf payloads, 64-aligned offsets relative to the payload start]
#
# flags bit 0 (INPROC): leaf payloads and table are ABSENT: the whole
# value lives in the writer-process registry; only a reader in the
# writer's process may consume the frame (it receives the live object
# reference).

_TC_MAGIC = 0x31435452  # "RTC1"
_TC_HDR = struct.Struct("<IIQQII")
_TC_LEAF = struct.Struct("<16sBB6qQQ")
_TC_INPROC = 1
_TC_ALIGN = 64
_TC_MAX_DIMS = 6

_KIND_NP = 0
_KIND_TORCH = 1        # a torch tensor on the CPU
_KIND_TORCH_CUDA = 2   # a torch tensor on a card

# Copies above this go through the native multi-threaded memcpy when the
# object-store native build is loadable (same thresholds as object_store).
_FAST_COPY_MIN = 256 << 10
_MT_COPY_MIN = 32 << 20


class _TensorRef:
    """Sidecar-pickle placeholder for an extracted tensor leaf. `spec` is
    kept for the frame's layout (a sharding spec in the JAX package's
    frames); torch leaves carry None."""

    __slots__ = ("index", "spec")

    def __init__(self, index: int, spec=None):
        self.index = index
        self.spec = spec

    def __reduce__(self):
        return (_TensorRef, (self.index, self.spec))


class _InprocRegistry:
    """Process-local (path -> (version, epoch, value)) table backing the
    same-process fast path. Only the LATEST committed value is retained
    per channel, so the registry cannot grow beyond live channels."""

    def __init__(self):
        self._values: dict[str, tuple[int, int, object]] = {}
        self._lock = threading.Lock()

    def publish(self, path: str, version: int, epoch: int, value):
        with self._lock:
            self._values[path] = (version, epoch, value)

    def lookup(self, path: str, version: int, epoch: int):
        """Returns (hit, value). The copy-on-write epoch guard: a stale or
        force-overwritten entry (epoch/version mismatch) is a MISS, never
        the wrong value."""
        with self._lock:
            ent = self._values.get(path)
        if ent is None or ent[0] != version or ent[1] != epoch:
            return False, None
        return True, ent[2]

    def drop(self, path: str):
        with self._lock:
            self._values.pop(path, None)


_INPROC = _InprocRegistry()


def _is_torch(v) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _leaf_kind(v):
    """_KIND_NP / _KIND_TORCH / _KIND_TORCH_CUDA for array leaves the
    tensor plane carries natively; None for everything else (rides the
    sidecar pickle)."""
    import numpy as np
    if isinstance(v, np.ndarray):
        return None if v.dtype.hasobject else _KIND_NP
    if _is_torch(v):
        if v.device.type == "cuda":
            return _KIND_TORCH_CUDA
        if v.device.type == "cpu" and not (v.is_sparse or v.is_quantized):
            return _KIND_TORCH
    return None


def torch_dtype_name(t) -> str:
    """A tensor's dtype as the name its frame descriptor carries."""
    return str(t.dtype).rsplit(".", 1)[-1]


def _int_view_dtype(itemsize: int) -> str:
    return {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}[itemsize]


def torch_host_array(t):
    """A numpy view of a contiguous CPU tensor's bytes: its own dtype, or
    for a dtype numpy lacks (bfloat16, the fp8 types) the same-width
    integer, as tensor frames and the collective library carry it."""
    import torch
    t = t.detach()
    try:
        return t.numpy()
    except TypeError:
        return t.view(getattr(torch, _int_view_dtype(t.element_size()))
                      ).numpy()


class _Leaf:
    """A leaf staged on the binary plane: its descriptor and its source (a
    C-contiguous host ndarray, or a contiguous CUDA tensor)."""

    __slots__ = ("kind", "dtype", "shape", "nbytes", "src")

    def __init__(self, kind, dtype, shape, nbytes, src):
        self.kind, self.dtype, self.shape = kind, dtype, tuple(shape)
        self.nbytes, self.src = nbytes, src


def _stage_leaf(v, kind) -> _Leaf:
    """The leaf's descriptor and host source. A numpy leaf is made
    C-contiguous; a CPU tensor is viewed as numpy; a CUDA tensor stays on
    its card until `copy_fn` moves it, once, into the frame region."""
    import numpy as np
    if kind == _KIND_NP:
        arr = v if v.flags.c_contiguous else np.ascontiguousarray(v)
        return _Leaf(kind, arr.dtype.name, arr.shape, arr.nbytes, arr)
    t = v.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    src = t if kind == _KIND_TORCH_CUDA else torch_host_array(t)
    return _Leaf(kind, torch_dtype_name(t), t.shape, nbytes, src)


def _extract(value, leaves, threshold):
    """Recursively split container skeletons (dict/list/tuple) from array
    leaves. numpy leaves >= threshold bytes and every torch leaf, <= 6-D,
    move to the binary plane (a torch tensor's own pickle is heavier than
    a descriptor); everything else stays in the sidecar pickle."""
    kind = _leaf_kind(value)
    if kind is not None:
        ndim = value.ndim if kind == _KIND_NP else value.dim()
        nbytes = (value.nbytes if kind == _KIND_NP
                  else value.numel() * value.element_size())
        if ((kind != _KIND_NP or nbytes >= threshold)
                and ndim <= _TC_MAX_DIMS):
            leaves.append(_stage_leaf(value, kind))
            return _TensorRef(len(leaves) - 1, None)
        return value
    if isinstance(value, dict):
        return {k: _extract(v, leaves, threshold)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        t = [_extract(v, leaves, threshold) for v in value]
        return t if isinstance(value, list) else tuple(t)
    return value


def _inline_threshold() -> int:
    try:
        from ray_tpu_torch.core.config import get_config
        return get_config().tensor_channel_inline_bytes
    except Exception:  # noqa: BLE001 — config not importable (bare tests)
        return 4096


def _copy_cuda_leaf(buf, abs_off: int, leaf: _Leaf):
    """The one device-to-host copy of a CUDA leaf, straight into the frame
    region `buf[abs_off:]` (returns when the bytes have landed)."""
    import torch
    dst = torch.frombuffer(buf, dtype=torch.uint8, count=leaf.nbytes,
                           offset=abs_off)
    dst.copy_(leaf.src.reshape(-1).view(torch.uint8))


class _FramePlan:
    """One encoded-frame layout: header + leaf table + meta + payloads.

    `inproc=True` plans carry NO leaf table, meta, or payloads: the value
    is handed over through the process registry, so the host
    representation is never materialized at all."""

    __slots__ = ("meta", "leaves", "offsets", "total", "flags")

    def __init__(self, value, threshold: int, inproc: bool):
        if inproc:
            self.meta, self.leaves, self.offsets = b"", [], []
            self.flags = _TC_INPROC
            self.total = _TC_HDR.size
            return
        leaves: list = []
        skeleton = _extract(value, leaves, threshold)
        self.meta = pickle.dumps(skeleton, protocol=5)
        self.leaves = leaves
        self.flags = 0
        head = _TC_HDR.size + _TC_LEAF.size * len(leaves) + len(self.meta)
        off = head + ((-head) % _TC_ALIGN)
        self.offsets = []
        for leaf in leaves:
            self.offsets.append(off)
            off += leaf.nbytes + ((-leaf.nbytes) % _TC_ALIGN)
        self.total = off if leaves else head

    def encode_into(self, buf, base: int, epoch: int, copy_fn):
        """Write the frame into `buf` at byte offset `base`. `buf` must
        support struct.pack_into (mmap or writable memoryview);
        `copy_fn(off, leaf)` stages one leaf payload at frame-relative
        offset `off` (the fast-memcpy hook; a CUDA leaf's D2H copy)."""
        _TC_HDR.pack_into(buf, base, _TC_MAGIC, self.flags, epoch,
                          os.getpid(), len(self.leaves), len(self.meta))
        pos = base + _TC_HDR.size
        for off, leaf in zip(self.offsets, self.leaves):
            dims = list(leaf.shape) + [0] * (_TC_MAX_DIMS - len(leaf.shape))
            _TC_LEAF.pack_into(buf, pos, leaf.dtype.encode()[:16], leaf.kind,
                               len(leaf.shape), *dims, off, leaf.nbytes)
            pos += _TC_LEAF.size
        if self.meta:
            struct.pack_into(f"<{len(self.meta)}s", buf, pos, self.meta)
        for off, leaf in zip(self.offsets, self.leaves):
            if leaf.nbytes:
                copy_fn(off, leaf)


def frame_regions(buf, base: int = 0) -> dict:
    """Parse a tensor frame's layout WITHOUT materializing values: the
    no-pickle plane's test hook (a tensor frame must be provably
    pickle-free outside the declared meta region)."""
    magic, flags, epoch, pid, n_leaves, meta_len = _TC_HDR.unpack_from(
        buf, base)
    if magic != _TC_MAGIC:
        raise ValueError("not a tensor frame")
    leaves = []
    pos = base + _TC_HDR.size
    for _ in range(n_leaves):
        raw_dtype, kind, ndim, *rest = _TC_LEAF.unpack_from(buf, pos)
        dims, off, nbytes = rest[:_TC_MAX_DIMS], rest[-2], rest[-1]
        leaves.append({"dtype": raw_dtype.rstrip(b"\0").decode(),
                       "kind": kind, "shape": tuple(dims[:ndim]),
                       "offset": off, "nbytes": nbytes})
        pos += _TC_LEAF.size
    return {"flags": flags, "epoch": epoch, "writer_pid": pid,
            "meta_offset": pos - base, "meta_len": meta_len,
            "leaves": leaves}


def torch_dtype(name: str):
    """The torch dtype a frame descriptor names."""
    import torch
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"tensor frame names torch dtype {name!r}, which "
                         f"this torch ({torch.__version__}) lacks")
    return dt


def _host_dtype(kind: int, name: str):
    """The numpy dtype a leaf's bytes are viewed as on the host: its own,
    or for a torch dtype torch cannot share with numpy (bfloat16, the fp8
    types) the same-width integer."""
    import numpy as np
    if kind == _KIND_NP:
        return np.dtype(name)
    import torch
    dt = torch_dtype(name)
    try:
        return torch.empty(0, dtype=dt).numpy().dtype
    except TypeError:
        return np.dtype(_int_view_dtype(dt.itemsize))


def _reader_device(device, what: str):
    """The card a CUDA leaf lands on: `device`, else this process's
    current one. A process that sees no card refuses the leaf."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"tensor channel leaf {what} is a CUDA tensor, and this process "
            f"(pid {os.getpid()}) sees no card: reserve one (num_gpus) for "
            f"the reader")
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"tensor channel leaf {what} is a CUDA tensor; "
                         f"device={device} is no card")
    return device


def _torch_leaf(arr, kind: int, name: str, index: int, device):
    """A fresh torch tensor of a leaf's host bytes `arr` (a read-only view
    of the frame): a CPU copy, or one host-to-device copy onto the
    reader's card."""
    import torch
    dt = torch_dtype(name)
    with warnings.catch_warnings():
        # a read-only view of the frame: only ever copied from
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(arr)
    if kind == _KIND_TORCH:
        return host.clone().view(dt)
    dev = _reader_device(device, f"#{index} ({name}{list(arr.shape)})")
    out = torch.empty(arr.shape, dtype=dt, device=dev)
    out.reshape(-1).view(torch.uint8).copy_(host.reshape(-1).view(
        torch.uint8))
    return out


def _decode_frame(buf, base: int, *, copy_np: bool, device=None):
    """Rebuild the value from a tensor frame at `buf[base:]`.

    numpy leaves alias `buf` as read-only views when copy_np=False (the
    caller owns the release discipline); torch leaves are fresh tensors:
    a CPU copy, or a host-to-device copy onto the reader's card that is
    synchronized before this returns, so the source region may be reused
    the moment the caller acks. Returns (value, borrowed)."""
    import numpy as np
    info = frame_regions(buf, base)
    meta_off = base + info["meta_offset"]
    skeleton = pickle.loads(bytes(memoryview(buf)[
        meta_off:meta_off + info["meta_len"]]))
    arrays = []
    for leaf in info["leaves"]:
        view = np.frombuffer(buf, dtype=np.uint8, count=leaf["nbytes"],
                             offset=base + leaf["offset"])
        arr = view.view(_host_dtype(leaf["kind"], leaf["dtype"])).reshape(
            leaf["shape"])
        arr.flags.writeable = False
        arrays.append((leaf["kind"], leaf["dtype"], arr))

    cuda_devs: set = set()

    def resolve(node):
        if isinstance(node, _TensorRef):
            kind, name, arr = arrays[node.index]
            if kind == _KIND_NP:
                return arr.copy() if copy_np else arr
            out = _torch_leaf(arr, kind, name, node.index, device)
            if kind == _KIND_TORCH_CUDA:
                cuda_devs.add(out.device)
            return out
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [resolve(v) for v in node]
            return t if isinstance(node, list) else tuple(t)
        return node

    value = resolve(skeleton)
    if cuda_devs:
        import torch
        # the writer may overwrite the source the moment we ack, so the
        # host-to-device copies must have landed first
        for dev in cuda_devs:
            torch.cuda.synchronize(dev)
    borrowed = (not copy_np) and any(k == _KIND_NP for k, _, _ in arrays)
    return value, borrowed


class TensorChannel(Channel):
    """Seqlock channel whose payload is the tensor frame above.

    Writer: `write(value)` stages array leaves straight into the shm
    region (one memcpy, multi-threaded native memcpy for >= 32 MB leaves;
    one device-to-host copy for a CUDA leaf) and publishes the live value
    in the process-local registry for same-process readers.

    Reader: `read()` returns the value. torch leaves arrive as fresh
    tensors (safe to hold; CUDA ones on `device`, default this process's
    current card); numpy leaves arrive as READ-ONLY views aliasing the
    channel, the ack deferred until `release()` (or the next read or
    close), which is when the writer may overwrite. Pass copy=True to
    materialize numpy leaves and ack immediately.

    `inproc=True` (writer side) skips the host representation entirely:
    the frame carries only the 32-byte header, and readers MUST be in the
    writer's process (they receive the live object reference: zero
    copies; do not mutate handed-over leaves in place). The copy-on-write
    epoch in the header guards the hand-off: a reader never resolves a
    registry value from a different write than the version its seqlock
    read committed."""

    def __init__(self, path: str | None = None, capacity: int = 1 << 20,
                 create: bool = False, n_readers: int = 1,
                 reader_idx: int = 0, inproc: bool = False):
        super().__init__(path, capacity, create=create,
                         n_readers=n_readers, reader_idx=reader_idx)
        self.inproc = inproc
        self._epoch = 0
        self._pending_ack: int | None = None
        self._native = None  # lazily probed (lib, mm_base_addr) | (None, 0)

    # -- native fast copy --

    def _native_copy(self):
        if self._native is None:
            try:
                import ctypes
                from ray_tpu_torch.core.object_store import _lib
                lib = _lib()
                base = ctypes.addressof(
                    ctypes.c_char.from_buffer(self._mm))
                self._native = (lib, base)
            except Exception:  # noqa: BLE001 — no toolchain: plain copies
                self._native = (None, 0)
        return self._native

    def _copy_leaf(self, off: int, leaf: _Leaf):
        import numpy as np
        abs_off = _HDR.size + off
        if leaf.kind == _KIND_TORCH_CUDA:
            _copy_cuda_leaf(self._mm, abs_off, leaf)
            return
        n = leaf.nbytes
        lib = None
        if n >= _FAST_COPY_MIN:
            lib, base = self._native_copy()
        if lib is not None:
            import ctypes
            threads = (min(8, os.cpu_count() or 1)
                       if n >= _MT_COPY_MIN else 1)
            lib.store_memcpy(ctypes.c_void_p(base + abs_off),
                             ctypes.c_void_p(leaf.src.ctypes.data), n,
                             threads)
        else:
            memoryview(self._mm)[abs_off:abs_off + n] = \
                leaf.src.reshape(-1).view(np.uint8)

    # -- writer side --

    def write(self, value, timeout: float | None = 60.0):
        t0 = time.time() if _TEV.enabled else 0.0
        plan = _FramePlan(value, _inline_threshold(), self.inproc)
        version = self._begin_write(plan.total, timeout)
        self._epoch += 1
        plan.encode_into(self._mm, _HDR.size, self._epoch, self._copy_leaf)
        # Publish BEFORE commit: once a reader can observe the version,
        # the registry entry for it already exists.
        _INPROC.publish(self.path, version + 2, self._epoch, value)
        self._commit_write(version, plan.total)
        if _TEV.enabled:
            _TEV.emit_span("chan_write", os.path.basename(self.path), t0,
                           time.time() - t0, bytes=plan.total)

    # -- reader side --

    def release(self):
        """Ack a borrowed read (numpy views handed out by the last
        `read(copy=False)`); the writer may then overwrite the region.
        Views obtained from that read MUST NOT be used afterwards."""
        if self._pending_ack is not None:
            v, self._pending_ack = self._pending_ack, None
            self._ack(v)

    def read(self, timeout: float | None = 60.0, *, copy: bool = False,
             device=None):
        self.release()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            version, length = self._poll_version(remaining)
            t0 = time.time() if _TEV.enabled else 0.0
            result = self._try_decode(version, length, copy, device)
            if result is not None:
                if _TEV.enabled:
                    # Read-ACQUIRE cost only (decode + the host-to-device
                    # copies of the committed frame), not the writer wait.
                    _TEV.emit_span("chan_read",
                                   os.path.basename(self.path), t0,
                                   time.time() - t0, bytes=length)
                return result[0]
            time.sleep(5e-5)

    def _try_decode(self, version, length, copy, device):
        """One seqlock-guarded decode attempt; None = torn read, retry."""
        if length == len(_CLOSE) and \
                self._mm[_HDR.size:_HDR.size + length] == _CLOSE:
            if not self._stable(version):
                return None
            self._ack(version)
            raise ChannelClosedError(self.path)
        try:
            info = frame_regions(self._mm, _HDR.size)
        except (ValueError, struct.error):
            if self._stable(version):
                raise
            return None  # torn header mid-overwrite
        if info["writer_pid"] == os.getpid():
            # Same-process fast path: hand over the live reference. The
            # epoch guard rejects a registry slot replaced by a newer
            # (or forced) write after this version was committed.
            hit, value = _INPROC.lookup(self.path, version, info["epoch"])
            if hit:
                if not self._stable(version):
                    return None
                self._ack(version)
                return (value,)
        if info["flags"] & _TC_INPROC:
            if not self._stable(version):
                return None  # mid-overwrite: stale header, retry
            raise RuntimeError(
                f"in-proc tensor channel {self.path} read from pid "
                f"{os.getpid()} (writer pid {info['writer_pid']}): "
                "create the channel with inproc=False for cross-process "
                "readers")
        try:
            value, borrowed = _decode_frame(self._mm, _HDR.size,
                                            copy_np=copy, device=device)
        except Exception:  # noqa: BLE001 — garbage from a torn frame
            if self._stable(version):
                raise
            return None
        if not self._stable(version):
            return None
        if borrowed:
            # numpy views alias the channel: hold the ack until release()
            # so the writer cannot overwrite under the reader.
            self._last_version = version
            self._pending_ack = version
        else:
            self._ack(version)
        return (value,)

    # -- lifecycle --

    def close(self):
        self.release()
        if self._epoch:  # this cursor was the writer
            _INPROC.drop(self.path)
        super().close()

    def __reduce__(self):
        return (TensorChannel, (self.path, self.capacity, False, 1,
                                self.reader_idx, self.inproc))


# -------------------- object-plane (cross-node) hops --------------------


def put_tensor_object(store, value, object_id=None):
    """Seal `value` as ONE shm-arena object in tensor-frame encoding and
    return its ObjectID. The cross-node half of the tensor plane: a remote
    reader pulls the sealed object over `objxfer.fetch_from_peer` into its
    own arena and rebuilds with `get_tensor_object`; the leaf bytes cross
    the wire once, with no pickle on either side's tensor leaves."""
    from ray_tpu_torch.core.ids import ObjectID
    if object_id is None:
        object_id = ObjectID.from_random()
    plan = _FramePlan(value, _inline_threshold(), inproc=False)
    buf = store._acquire_buffer(object_id, plan.total, meta=b"tensor_frame")
    try:
        import ctypes

        def copy_fn(off, leaf):
            n = leaf.nbytes
            if leaf.kind == _KIND_TORCH_CUDA:
                _copy_cuda_leaf(buf.data, off, leaf)
                return
            if n >= _FAST_COPY_MIN:
                dst = ctypes.c_void_p(store._base + buf.offset + off)
                src = ctypes.c_void_p(leaf.src.ctypes.data)
                if n >= _MT_COPY_MIN:
                    # Thread budget shared with every concurrent arena
                    # copier (shm counter), see store_copy_adaptive.
                    store._lib.store_copy_adaptive(
                        store._base, dst, src, n,
                        min(8, os.cpu_count() or 1))
                    return
                store._lib.store_memcpy(dst, src, n, 1)
            else:
                import numpy as np
                buf.data[off:off + n] = leaf.src.reshape(-1).view(np.uint8)

        plan.encode_into(buf.data, 0, 1, copy_fn)
        buf.seal()
    except BaseException:
        buf.abort()
        raise
    return object_id


def get_tensor_object(store, object_id, timeout: float | None = None,
                      device=None):
    """Rebuild a `put_tensor_object` value from the local arena. torch
    leaves are fresh tensors (CUDA ones copied onto `device`); numpy
    leaves are copied out so the store reference can be released
    immediately."""
    res = store.get_raw(object_id, timeout)
    if res is None:
        raise KeyError(f"tensor object {object_id} not found")
    data, _meta = res
    try:
        value, _ = _decode_frame(data, 0, copy_np=True, device=device)
    finally:
        try:
            data.release()
        except BufferError:
            pass  # a transient frombuffer view; dies with this frame
        store.release(object_id)
    return value
