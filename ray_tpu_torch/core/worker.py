"""Worker process: executes tasks and hosts actors.

Parity: reference `python/ray/_private/workers/default_worker.py` +
`src/ray/core_worker/` execution side (`transport/task_receiver.h`,
`actor_scheduling_queue.h`, async-actor fibers `transport/fiber.h`) and the
task-execution callback `python/ray/_raylet.pyx:1727 execute_task`.

One socket to the head multiplexes: inbound task dispatch, and outbound
API calls (nested task submission, object waits) + results. A receiver
thread routes frames; execution happens on the main executor thread, a
thread pool (threaded actors), or an asyncio loop (async actors).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import inspect
import os
import pickle
import socket
import sys
import threading
import time
import traceback

from ray_tpu_torch.core import chaos, serialization, task_events
from ray_tpu_torch.core.config import Config, set_config, get_config
from ray_tpu_torch.core.ids import ObjectID, WorkerID
from ray_tpu_torch.core.object_store import SharedMemoryStore, arrow_block_of
from ray_tpu_torch.core.status import TaskError
from ray_tpu_torch.core.task import TaskSpec
from ray_tpu_torch.core.transport import FrameBuffer, send_msg, socket_from_fd

# Process-global task-event ring (core/task_events.py): emission sites
# guard on `.enabled` (one attribute check when the pipeline is off).
_TEV = task_events.ring()


class _LRUCache:
    """Bounded oid->value cache. A long-lived worker sees millions of inline
    values; on miss the value is re-fetched from the head (directory/shm), so
    eviction is always safe."""

    def __init__(self, cap: int = 4096):
        import collections
        self._d = collections.OrderedDict()
        self._cap = cap
        self._lock = threading.Lock()

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def __getitem__(self, key):
        with self._lock:
            val = self._d[key]
            self._d.move_to_end(key)
            return val

    def __setitem__(self, key, val):
        with self._lock:
            self._d[key] = val
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def get(self, key, default=None):
        with self._lock:
            if key not in self._d:
                return default
            self._d.move_to_end(key)
            return self._d[key]


class _WorkerRefCounter:
    """Worker-side counting for objects THIS worker owns (its own put()s);
    borrowed refs stay uncounted — the head pins those for the lifetime of
    tasks that reference them (runtime.submit_task).

    An owned ref that gets serialized (into a return value, a task arg, a
    nested put) has "escaped" to an unknown borrower and is never freed from
    here; the overwhelmingly common temporary — put, use locally, drop —
    frees eagerly instead of leaking into the shared arena until eviction."""

    def __init__(self, free_fn, escape_fn=None):
        self._owned: dict[bytes, int] = {}
        self._escaped: set[bytes] = set()
        self._lock = threading.Lock()
        self._free_fn = free_fn
        self._escape_fn = escape_fn  # first escape of an owned key

    def register_owned(self, object_id):
        """Call BEFORE constructing the first (strong) ObjectRef: the ref's
        own add_local_ref provides the initial count."""
        with self._lock:
            self._owned[object_id.binary()] = 0

    def add_local_ref(self, object_id):
        key = object_id.binary()
        with self._lock:
            if key in self._owned:
                self._owned[key] += 1

    def remove_local_ref(self, object_id):
        key = object_id.binary()
        free = False
        with self._lock:
            if key not in self._owned:
                return
            self._owned[key] -= 1
            if self._owned[key] <= 0:
                del self._owned[key]
                free = key not in self._escaped
                self._escaped.discard(key)
        if free:
            try:
                self._free_fn(key)
            except Exception:  # noqa: BLE001 — freeing is best effort
                pass

    def mark_escaped(self, object_id):
        key = object_id.binary()
        fire = False
        with self._lock:
            if key in self._owned and key not in self._escaped:
                self._escaped.add(key)
                fire = self._escape_fn is not None
        if fire:
            try:
                self._escape_fn(key)
            except Exception:  # noqa: BLE001 — escape hook is safety net
                pass

    def is_owned(self, key: bytes) -> bool:
        with self._lock:
            return key in self._owned


class _WorkerPeer:
    """One worker<->worker unix-socket channel of the head-node peer
    plane (parity role: the reference's direct worker-to-worker gRPC
    actor transport, actor_task_submitter.h:78 — here between pooled
    workers of the head node, where there is no agent to route through).

    The initiating side sends ("wexec", spec) frames and receives
    ("wdone", ...) replies; the accepting side is the executor. Failures
    signal as channel EOF (calls fall back through the head). Frames on
    one channel are FIFO, which carries per-caller call order."""

    def __init__(self, rt: "WorkerRuntime", sock, initiated: bool):
        self.rt = rt
        self.sock = sock
        self.send_lock = threading.Lock()
        self.alive = True
        self.initiated = initiated
        self.path: str | None = None       # dial target (initiator only)
        self.inflight: dict[bytes, TaskSpec] = {}  # initiator bookkeeping

    def send(self, msg):
        send_msg(self.sock, msg, self.send_lock)

    def start(self):
        threading.Thread(target=self._read_loop, daemon=True,
                         name="rtpu-wpeer").start()

    def _read_loop(self):
        fb = FrameBuffer()
        while True:
            try:
                data = self.sock.recv(1 << 20)
            except OSError:
                data = b""
            if not data:
                self.alive = False
                try:
                    self.sock.close()
                except OSError:
                    pass
                self.rt._on_wpeer_eof(self)
                return
            fb.feed(data)
            for msg in fb.frames():
                try:
                    self.rt._on_wpeer_frame(self, msg)
                except Exception:  # noqa: BLE001 — keep the channel alive
                    traceback.print_exc()


class WorkerRuntime:
    """Per-worker client runtime; the worker-side half of the core API."""

    def __init__(self, sock, worker_id: WorkerID, store_path: str):
        self.sock = sock
        self.send_lock = threading.Lock()
        self._send_q: collections.deque = collections.deque()
        self._send_cv = threading.Condition()
        self._last_send = 0.0
        self._send_exc: OSError | None = None
        self._sender_started = False
        # In-flight channel claims (inline senders + the sender thread
        # each hold one while writing): a COUNTER, not a bool — an inline
        # send finishing while the sender thread still owns a batch must
        # not mark the channel free (that would let a later frame
        # inline-send ahead of the queued batch).
        self._sending = 0
        self.worker_id = worker_id
        self.store_path = store_path
        self._store: SharedMemoryStore | None = None
        self.functions: dict[bytes, object] = {}
        self.object_cache = _LRUCache()
        self.object_errors: dict[bytes, object] = {}
        self._pending_waits: dict[bytes, list[threading.Event]] = {}
        self._wait_lock = threading.Lock()
        self.task_queue: "queue.Queue" = None  # set in main
        self.cancelled_tasks: set = set()  # dropped before execution
        # Stolen back; skip silently. A COUNTER, not a set: the same task
        # can be stolen, re-dispatched, pipelined back onto this very
        # worker, and stolen again — each acked drop corresponds to exactly
        # one stale queued exec copy that must be skipped, and a set would
        # absorb the second mark and let the stale copy run (duplicate).
        self.dropped_tasks: dict = {}      # task_id -> pending skip count
        # Two-phase steal: ids whose execution has begun. The receiver
        # thread consults this under steal_lock to decide a drop_task's ack
        # (begun -> drop_ack False, the head aborts the steal).
        self.begun_tasks: set = set()
        self.steal_lock = threading.Lock()
        # pubsub subscriber registry (pubsub_msg pushes dispatch here)
        self._pubsub_cbs: dict[tuple, list] = {}
        self._pubsub_lock = threading.Lock()
        self.actor_instance = None
        self.actor_id: bytes | None = None
        self.shutdown = threading.Event()
        self.current_task = None
        self.refcount = _WorkerRefCounter(
            self._on_owned_free, escape_fn=self._on_owned_escape)
        # ---- worker<->worker peer plane (head-node pooled workers) ----
        # Direct actor calls between workers of the head node ride unix
        # sockets: 2 frame hops instead of 4 (caller->head->executor->
        # head->caller), with the head entirely out of the data path.
        # The agent plane's counterpart is node_agent._PeerConn.
        self._peer_path: str | None = None   # our UDS listener (executor)
        self._peer_srv: socket.socket | None = None
        self._peer_conns: dict[str, "_WorkerPeer"] = {}  # path -> conn
        self._peer_lock = threading.Lock()
        # Executor side: task_id -> _WorkerPeer the exec arrived on.
        self.direct_routes: dict[bytes, "_WorkerPeer"] = {}
        # Caller side: inline results of direct calls, pinned while the
        # ref lives (the 4096-LRU object_cache would silently evict them
        # and a re-fetch from the head — which never saw the call — would
        # hang). rid -> value.
        self._direct_values: dict[bytes, object] = {}
        # rid -> bool(escaped before arrival): set at submit, consumed at
        # wdone/wfail.
        self._direct_pending: dict[bytes, bool] = {}
        self._direct_lock = threading.Lock()
        # Diagnostics: direct (peer-plane) calls this worker shipped —
        # tests pair this against the head's actor_head_dispatches to
        # assert storms stay off the head/agent relay.
        self.direct_calls_sent = 0
        # Executor-side per-(caller, actor) submission-order gate: peer
        # frames race head-relayed frames exactly like the agent plane.
        from ray_tpu_torch.core.order_gate import OrderGate
        self.order_gate = OrderGate()
        # Actor location cache for the direct agent<->agent call path
        # (parity: the resolved actor address inside
        # actor_task_submitter.h:78); poisoned by "actor_moved" pushes.
        self.actor_locations: dict[bytes, tuple] = {}
        self.on_agent_node = os.environ.get("RAY_TPU_TORCH_IS_HEAD_NODE") == "0"
        # Per-target-actor submission counter: stamped on every actor call
        # this worker submits (direct OR head path) so the executing agent
        # can restore per-caller order across the two transports.
        self._actor_seq_lock = threading.Lock()
        import collections as _collections
        self._actor_call_seq: "_collections.OrderedDict[bytes, int]" = (
            _collections.OrderedDict())
        self._req_lock = threading.Lock()
        self._req_seq = 0
        self._req_futures: dict[int, "concurrent.futures.Future"] = {}
        # Caller-side pins for direct actor calls that carry locally-owned
        # object deps (and for offloaded arg packs): rid -> [remaining,
        # [oid, ...]]. The head never sees a peer-plane call, so ITS
        # submit-time dep pinning can't protect these — the caller holds a
        # local ref on each dep until every return of the call resolves.
        self._dep_pins: dict[bytes, list] = {}
        self._dep_pin_lock = threading.Lock()
        # Task-event / metric flush pacing (task_events_flush_ms): the
        # ring drains onto the write-combined reply channel, so a flush
        # rides the same coalesced sendmsg as the done frame it follows.
        self._tev_last_flush = 0.0
        self._tev_flush_s = get_config().task_events_flush_ms / 1000.0

    def flush_task_events(self, force: bool = False):
        """Ship the ring + dirty metric registry to the head (via the
        agent relay on agent nodes). Rate-limited; piggybacks on the
        sender-thread batching, so a flush right after a reply rides the
        same coalesced write as the done frame before it."""
        pending = _TEV.enabled and (_TEV.events or _TEV.dropped)
        now = time.monotonic()
        due = force or (now - self._tev_last_flush) >= self._tev_flush_s
        if not due:
            return
        self._tev_last_flush = now
        try:
            if pending:
                batch, dropped = _TEV.drain()
                if batch or dropped:
                    self.send(("task_events", batch, dropped))
            from ray_tpu_torch.util import metrics as _metrics
            snap = _metrics.registry_delta()
            if snap:
                self.send(("metrics_update", snap))
        except OSError:
            pass  # head/agent gone; the worker is on its way out

    # -- pubsub (subscriber side; parity: pubsub/subscriber.h:73) --

    def pubsub_subscribe(self, channel: str, key: str, callback):
        with self._pubsub_lock:
            self._pubsub_cbs.setdefault((channel, key), []).append(callback)
        self.send(("subscribe", channel, key))

    def pubsub_unsubscribe(self, channel: str, key: str, callback):
        last = False
        with self._pubsub_lock:
            cbs = self._pubsub_cbs.get((channel, key))
            if cbs is not None:
                try:
                    cbs.remove(callback)
                except ValueError:
                    pass
                if not cbs:
                    self._pubsub_cbs.pop((channel, key), None)
                    last = True
        if last:
            self.send(("unsubscribe", channel, key))

    def pubsub_publish(self, channel: str, key: str, message):
        self.send(("publish", channel, key, message))

    # -- object plane --

    @property
    def store(self) -> SharedMemoryStore:
        if self._store is None:
            from ray_tpu_torch.core.object_store import configure_store
            st = SharedMemoryStore(self.store_path)
            configure_store(st, get_config())
            if os.environ.get("RAY_TPU_TORCH_IS_HEAD_NODE") == "1":
                # Reservation refills ask the head for room once per
                # extent (the old path probed stats + requested spill on
                # every large put). Agent arenas rely on LRU eviction.
                def _spill_refill_hook(need: int, _st=st):
                    stats = _st.stats()
                    cap = stats["capacity"] or 1
                    limit = get_config().object_spill_threshold * cap
                    if stats["allocated"] + need > limit:
                        self.request(
                            "spill",
                            int(stats["allocated"] + need - limit)
                            + (4 << 20))

                st.spill_hook = _spill_refill_hook
            self._store = st
        return self._store

    def put(self, value):
        from ray_tpu_torch.core.object_ref import ObjectRef
        oid = ObjectID.from_random()
        _put_with_spill(self, oid, value,
                        int(getattr(value, "nbytes", 0) or (1 << 20)))
        self.send(("put_notify", oid.binary()))
        self.refcount.register_owned(oid)
        return ObjectRef(oid, owner=self.worker_id.binary())

    def put_arg_object(self, value, nbytes) -> bytes:
        """Store one offloaded-args pack (serialization.maybe_offload_args)
        owned by this worker: the submitter releases the local ref when the
        call's returns resolve (pin_call_deps), and the head additionally
        frees it after the final completion of head-routed tasks."""
        oid = ObjectID.from_random()
        _put_with_spill(self, oid, value, nbytes)
        self.refcount.register_owned(oid)
        self.refcount.add_local_ref(oid)
        self.send(("put_notify", oid.binary()))
        return oid.binary()

    def get(self, refs, timeout=None):
        from ray_tpu_torch.core.object_ref import ObjectRef
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        out = [self._get_one(r, timeout) for r in refs]
        return out[0] if single else out

    def _get_one(self, ref, timeout=None):
        oid = ref.id.binary()
        _MISS = object()
        cached = self.object_cache.get(oid, _MISS)
        if cached is not _MISS:
            return self._raise_if_error(cached)
        if oid in self._direct_values:  # pinned direct-call result that
            return self._raise_if_error(  # fell out of the LRU cache
                self._direct_values[oid])
        found, value = self.store.get_deserialized(ref.id, timeout=0)
        if found:
            self._maybe_cache_scalar(oid, value)
            return value
        # Ask the owner; block until the push arrives.
        ev = threading.Event()
        with self._wait_lock:
            self._pending_waits.setdefault(oid, []).append(ev)
        # Close the check-then-subscribe window: a peer-plane wdone that
        # landed between the cache probes above and the registration just
        # now signalled NOBODY — and unlike head-path objects, wait_obj
        # cannot recover it (the head never saw a direct call). Re-probe
        # now that any later arrival is guaranteed to set `ev`.
        if oid in self.object_cache or oid in self._direct_values:
            with self._wait_lock:
                lst = self._pending_waits.get(oid)
                if lst is not None:
                    try:
                        lst.remove(ev)
                    except ValueError:
                        pass
                    if not lst:
                        self._pending_waits.pop(oid, None)
        else:
            self.send(("wait_obj", oid))
            if not ev.wait(timeout):
                from ray_tpu_torch.core.status import GetTimeoutError
                raise GetTimeoutError(f"get() timed out on {ref}")
        cached = self.object_cache.get(oid, _MISS)
        if cached is not _MISS:
            return self._raise_if_error(cached)
        if oid in self._direct_values:
            return self._raise_if_error(self._direct_values[oid])
        found, value = self.store.get_deserialized(ref.id, timeout=5.0)
        if found:
            self._maybe_cache_scalar(oid, value)
            return value
        from ray_tpu_torch.core.status import ObjectLostError
        raise ObjectLostError(ref.id)

    _SCALAR_TYPES = (int, float, bool, bytes, str, type(None))

    def _maybe_cache_scalar(self, oid: bytes, value):
        """Cache tiny immutable scalars read from the arena: an actor
        hammered with the same small ref arg (fan-out bursts passing one
        put() handle) re-reads it per call otherwise — a shard-lock +
        unpickle round trip for a value that can never change. Larger or
        composite values stay uncached so the LRU can't pin arena-aliasing
        buffers alive."""
        if type(value) in self._SCALAR_TYPES and sys.getsizeof(value) < 4096:
            self.object_cache[oid] = value

    @staticmethod
    def _raise_if_error(value):
        if isinstance(value, TaskError):
            raise value.cause if value.cause is not None else value
        if isinstance(value, Exception):
            raise value
        return value

    def prefetch_refs(self, refs):
        """Vectored dependency fetch: subscribe to every locally-missing
        ref in ONE wait_objs frame so the head materializes them
        concurrently (and groups same-source pulls into one batched
        objxfer round). Best-effort warm-up — anything still missing
        afterward falls back to _get_one's own per-ref wait/timeout."""
        if len(refs) < 2:
            return
        min_refs = get_config().vectored_arg_fetch_min
        if min_refs <= 0 or len(refs) < min_refs:
            return
        missing: list = []
        events: list = []
        seen: set = set()
        for r in refs:
            oid = r.id.binary()
            if (oid in seen or oid in self.object_cache
                    or oid in self._direct_values
                    or self.store.contains(r.id)):
                continue
            seen.add(oid)
            ev = threading.Event()
            with self._wait_lock:
                self._pending_waits.setdefault(oid, []).append(ev)
            missing.append(oid)
            events.append(ev)
        if len(missing) < min_refs:
            # Below the vectored floor: drop the subscriptions — the
            # per-ref path will re-subscribe with its own timeout story.
            with self._wait_lock:
                for oid, ev in zip(missing, events):
                    lst = self._pending_waits.get(oid)
                    if lst is not None:
                        try:
                            lst.remove(ev)
                        except ValueError:
                            pass
                        if not lst:
                            self._pending_waits.pop(oid, None)
            return
        try:
            self.send(("wait_objs", missing))
        except OSError:
            return
        deadline = time.monotonic() + 60.0
        for ev in events:
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                break  # per-arg resolve owns the error/timeout story

    def wait(self, refs, num_returns=1, timeout=None):
        import time as _t
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        deadline = None if timeout is None else _t.monotonic() + timeout
        subscribed: dict[bytes, threading.Event] = {}

        def is_ready(r) -> bool:
            oid = r.id.binary()
            if (oid in self.object_cache or oid in self._direct_values
                    or self.store.contains(r.id)):
                return True
            ev = subscribed.get(oid)
            if ev is not None and ev.is_set():
                return True
            if ev is None:  # subscribe exactly once per ref
                ev = threading.Event()
                subscribed[oid] = ev
                with self._wait_lock:
                    self._pending_waits.setdefault(oid, []).append(ev)
                self.send(("wait_obj", oid))
            return False

        while True:
            ready = [r for r in refs if is_ready(r)]
            if len(ready) >= num_returns:
                break
            if deadline is not None and _t.monotonic() > deadline:
                break
            _t.sleep(0.002)
        ready_set = {r.id.binary() for r in ready[:num_returns]}
        ready = [r for r in refs if r.id.binary() in ready_set]
        not_ready = [r for r in refs if r.id.binary() not in ready_set]
        return ready, not_ready

    # -- task submission from inside a worker --

    def submit(self, spec: TaskSpec):
        self.send(("submit", spec))

    def send(self, msg):
        """Send one frame, write-combining under load. A lone frame on an
        idle channel sends inline (sync-call latency unchanged); frames
        arriving while a send syscall is in flight queue behind it and the
        sender thread coalesces them into one write — a task fanning out
        actor calls or puts stops paying one syscall+wakeup per call.
        Order is exactly send-call order, so every head-side invariant
        that held under inline sends still holds.

        Burst detection: a SEQUENTIAL fan-out loop (submit, submit, ...)
        never finds the channel busy — each inline sendall completes, and
        worse, wakes the head per frame (on a shared core that preemption
        doubles the cost). When the previous send was <150us ago, hand the
        frame to the sender thread instead: while its send_many syscall is
        in flight the loop keeps queueing, so bursts collapse into a few
        large writes."""
        burst = False
        now = time.monotonic()
        if now - self._last_send < 150e-6:
            burst = True
        self._last_send = now
        with self._send_cv:
            if self._send_exc is not None:
                raise self._send_exc
            if self._send_q or self._sending or burst:
                if not self._sender_started:
                    self._sender_started = True
                    threading.Thread(target=self._sender_loop, daemon=True,
                                     name="rtpu-sender").start()
                self._send_q.append(msg)
                self._send_cv.notify()
                return
            self._sending += 1  # claim the channel for an inline send
        try:
            send_msg(self.sock, msg, self.send_lock)
        finally:
            with self._send_cv:
                self._sending -= 1
                self._send_cv.notify_all()

    def _sender_loop(self):
        from ray_tpu_torch.core.transport import send_many
        while True:
            with self._send_cv:
                while not self._send_q:
                    self._send_cv.notify_all()  # wake flush_sends waiters
                    self._send_cv.wait()
                batch = list(self._send_q)
                self._send_q.clear()
                self._sending += 1
            try:
                send_many(self.sock, batch, self.send_lock)
            except OSError as e:
                with self._send_cv:
                    self._send_exc = e
                    self._send_q.clear()
                    self._sending -= 1
                    self._send_cv.notify_all()
                return
            with self._send_cv:
                self._sending -= 1
                self._send_cv.notify_all()

    def flush_sends(self, timeout: float = 2.0):
        """Drain the send queue (used before os._exit so the last frames —
        replies, actor_err — reach the head)."""
        deadline = time.monotonic() + timeout
        with self._send_cv:
            while ((self._send_q or self._sending)
                   and self._send_exc is None):
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._send_cv.wait(left)
        # An in-flight sendall holds send_lock past the flag flip; taking
        # the lock once guarantees the final write hit the socket before
        # the caller os._exits.
        with self.send_lock:
            pass

    def next_actor_call_seq(self, actor_id: bytes) -> int:
        with self._actor_seq_lock:
            n = self._actor_call_seq.get(actor_id, 0)
            self._actor_call_seq[actor_id] = n + 1
            self._actor_call_seq.move_to_end(actor_id)
            if len(self._actor_call_seq) > 4096:
                # Bounded, LRU: evicting an idle counter restarts that
                # pair at 0, which the executing agent treats as an
                # immediate replay slot — order degrades gracefully.
                self._actor_call_seq.popitem(last=False)
            return n

    # -- caller-side dep pinning (direct calls + offloaded arg packs) --

    def deps_ready_local(self, refs) -> bool:
        """True when every ref dep is owned by THIS worker and already
        sealed in the local arena — the precondition for taking the direct
        actor-call path with args: the executor resolves them instantly
        (no head-of-line blocking in its queue) and pin_call_deps below
        replaces the head's submit-time borrow pin."""
        for r in refs:
            if not self.refcount.is_owned(r.id.binary()):
                return False
            if not self.store.contains(r.id):
                return False
        return True

    def pin_call_deps(self, spec, add_oids=(), held_oids=()):
        """Hold a local ref on each oid until every return of this call
        resolves (wdone on the peer plane, or the head's obj push on a
        fallback/get). `add_oids` take a fresh count here (direct-call
        user deps); `held_oids` were already counted by the caller
        (offloaded arg packs — put_arg_object's ref transfers in). A call
        whose results are never observed keeps its pins for the worker's
        lifetime — bounded by the caller's own working set, same as
        holding the arg refs in a local."""
        oids = list(add_oids) + list(held_oids)
        if not oids:
            return
        from ray_tpu_torch.core.ids import ObjectID as _OID
        for oid in add_oids:
            self.refcount.add_local_ref(_OID(oid))
        if not spec.return_ids:
            for oid in oids:  # fire-and-forget: nothing will resolve
                self.refcount.remove_local_ref(_OID(oid))
            return
        pin = [len(spec.return_ids), oids]
        with self._dep_pin_lock:
            for rid in spec.return_ids:
                self._dep_pins[rid] = pin

    def _release_dep_pin(self, rid: bytes):
        with self._dep_pin_lock:
            pin = self._dep_pins.pop(rid, None)
            if pin is None:
                return
            pin[0] -= 1
            done = pin[0] <= 0
        if done:
            from ray_tpu_torch.core.ids import ObjectID as _OID
            for oid in pin[1]:
                self.refcount.remove_local_ref(_OID(oid))

    _HEAD_HOSTED = ("head", b"")  # negative-cache sentinel

    def resolve_actor_location(self, actor_id: bytes):
        """(node_id, worker_id) of a live remote actor, or None. Cached —
        including the negative result (head-hosted/unstable actors must not
        pay a resolution round-trip on EVERY call); a stale entry of either
        kind is dropped by the agent's actor_moved push."""
        loc = self.actor_locations.get(actor_id)
        if loc is not None:
            return None if loc == self._HEAD_HOSTED else loc
        try:
            loc = self.request("actor_location", actor_id, timeout=10.0)
        except Exception:  # noqa: BLE001 — resolution is an optimization
            return None
        self.actor_locations[actor_id] = (tuple(loc) if loc is not None
                                          else self._HEAD_HOSTED)
        return tuple(loc) if loc is not None else None

    # -- worker<->worker peer plane (head-node direct actor calls) --

    def start_peer_listener(self) -> str | None:
        """Bind this worker's UDS exec listener (executor half of the
        peer plane). The path rides the "ready" frame so the head can
        hand it to callers resolving this worker's actor — on head nodes
        AND agent nodes (same-node actor->actor calls skip the agent
        relay both ways; the agent learns of results asynchronously via
        put_notify/task-event frames only)."""
        if not get_config().worker_direct_calls:
            return None
        path = f"{self.store_path}_w{self.worker_id.hex()[:12]}.sock"
        try:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(path)
            srv.listen(64)
        except OSError:
            return None
        self._peer_srv = srv
        self._peer_path = path

        def accept_loop():
            while not self.shutdown.is_set():
                try:
                    s, _ = srv.accept()
                except OSError:
                    return
                _WorkerPeer(self, s, initiated=False).start()

        threading.Thread(target=accept_loop, daemon=True,
                         name="rtpu-wpeer-accept").start()
        return path

    def send_direct_worker(self, path: str, spec) -> bool:
        """Ship an actor call straight to the hosting worker's UDS.
        False = couldn't (caller falls back to the head path)."""
        try:
            with self._peer_lock:
                conn = self._peer_conns.get(path)
            if conn is None or not conn.alive:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    s.connect(path)
                except OSError:
                    # The dial failed before any owner existed: close
                    # here or the fd leaks on every stale-path retry.
                    s.close()
                    raise
                fresh = _WorkerPeer(self, s, initiated=True)
                fresh.path = path
                with self._peer_lock:
                    live = self._peer_conns.get(path)
                    if live is not None and live.alive:
                        try:
                            s.close()
                        except OSError:
                            pass
                        conn = live
                    else:
                        self._peer_conns[path] = fresh
                        conn = fresh
                if conn is fresh:
                    conn.start()
        except OSError:
            return False
        # The caller owns a direct call's results (the head never sees
        # the call, so nobody else can): register BEFORE the ObjectRefs
        # are constructed so their local refcounts take.
        with self._direct_lock:
            for rid in spec.return_ids:
                self.refcount.register_owned(ObjectID(rid))
                self._direct_pending[rid] = False
        conn.inflight[spec.task_id] = spec
        if chaos.site("worker.direct_call.reset"):
            try:  # injected channel death under an outgoing call: the
                # send below fails and EOF replay races it — exactly one
                # of the two owns the fallback token
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            conn.send(("wexec", spec))
        except OSError:
            # The inflight entry is the fallback TOKEN: exactly one of
            # this path and _on_wpeer_eof's replay pops it (dict.pop is
            # atomic under the GIL), so a send failing concurrently with
            # channel EOF can never submit the call twice.
            if conn.inflight.pop(spec.task_id, None) is None:
                return True  # EOF handler owns the fallback already
            with self._direct_lock:
                for rid in spec.return_ids:
                    self._direct_pending.pop(rid, None)
            return False
        self.direct_calls_sent += 1
        return True

    def _on_wpeer_frame(self, conn: "_WorkerPeer", msg):
        op = msg[0]
        if op == "wexec":
            spec: TaskSpec = msg[1]
            self.direct_routes[spec.task_id] = conn
            self.order_gate.submit(
                spec, lambda s=spec: self.task_queue.put(s))
        elif op == "wdone":
            for task_id, outs in msg[1]:
                conn.inflight.pop(task_id, None)
                self._apply_direct_done(outs)

    def _on_wpeer_eof(self, conn: "_WorkerPeer"):
        if conn.initiated:
            with self._peer_lock:
                if self._peer_conns.get(conn.path) is conn:
                    self._peer_conns.pop(conn.path, None)
            # Poison location-cache entries that point at the dead path.
            for aid, loc in list(self.actor_locations.items()):
                if (isinstance(loc, tuple) and len(loc) > 1
                        and loc[0] == "uds" and loc[1] == conn.path):
                    self.actor_locations.pop(aid, None)
            # In-flight calls MAY have executed (the frame was sent):
            # only retry-permitted calls replay, the rest fail cleanly.
            # The pop is the fallback token shared with the sender's
            # OSError path — whoever pops the entry owns the fallback.
            for task_id, spec in list(conn.inflight.items()):
                if conn.inflight.pop(task_id, None) is not None:
                    self._direct_fallback(spec, maybe_executed=True)
        else:
            # The calling worker died: its results are moot — drop the
            # routes so replies fall through to the discard path.
            for task_id, c in list(self.direct_routes.items()):
                if c is conn:
                    self.direct_routes.pop(task_id, None)

    def _apply_direct_done(self, outs):
        """Caller side of a wdone: resolve futures like head obj pushes.
        Inline values are pinned while their ref lives (see
        _direct_values); escaped-while-pending refs materialize now."""
        for rid, status, payload, bufs in outs:
            if status in ("inline", "err"):
                value = serialization.deserialize(payload, bufs)
                self.object_cache[rid] = value
                escaped = None
                with self._direct_lock:
                    escaped = self._direct_pending.pop(rid, None)
                    if escaped is not None and (
                            escaped or self.refcount.is_owned(rid)):
                        self._direct_values[rid] = value
                if escaped:
                    self._materialize_direct(rid, value)
            else:  # shm: already in the shared arena + head notified
                with self._direct_lock:
                    self._direct_pending.pop(rid, None)
            if self._dep_pins:
                self._release_dep_pin(rid)
            with self._wait_lock:
                for ev in self._pending_waits.pop(rid, []):
                    ev.set()

    def _direct_fallback(self, spec, maybe_executed: bool):
        """A direct call's channel failed. Retry-permitted calls replay
        through the head (which parks/fails them against the actor's
        fate); a possibly-executed non-retryable call must only have its
        returns failed — replaying could double-execute."""
        with self._direct_lock:
            for rid in spec.return_ids:
                self._direct_pending.pop(rid, None)
        retryable = (spec.retries_left or 0) > 0
        try:
            if maybe_executed and not retryable:
                self.send(("direct_fail", spec))
            else:
                if maybe_executed:
                    # The replay consumes retry budget (same contract as
                    # the agent plane's _direct_fallback): a maybe-
                    # executed call must not replay for free forever.
                    spec.retries_left -= 1
                self.send(("direct_actor_head", spec))
        except OSError:
            pass

    def _materialize_direct(self, rid: bytes, value):
        """An owned direct-call result escaped this process: store it
        under its exact id and tell the head, so borrowers anywhere can
        resolve it (mirrors put() visibility)."""
        nbytes = int(getattr(value, "nbytes", 0) or (1 << 20))
        try:
            _put_with_spill(self, ObjectID(rid), value, nbytes)
            self.send(("put_notify", rid))
        except Exception:  # noqa: BLE001 — borrower get() will surface it
            traceback.print_exc()

    def _on_owned_free(self, key: bytes):
        with self._direct_lock:
            self._direct_values.pop(key, None)
            self._direct_pending.pop(key, None)
        self.send(("free_put", key))

    def _on_owned_escape(self, key: bytes):
        with self._direct_lock:
            if key in self._direct_values:
                value = self._direct_values[key]
            elif key in self._direct_pending:
                # Escaped before the result arrived: flag so
                # _apply_direct_done materializes on arrival.
                self._direct_pending[key] = True
                return
            else:
                return  # a plain put() escaping; head already knows it
        self._materialize_direct(key, value)

    # -- streaming (ObjectRefGenerator consumed from a worker) --

    def next_stream_item(self, task_id: bytes, idx: int,
                         timeout: float | None = None):
        """Blocks until yield #idx of a streaming task exists; None = the
        stream closed first. The head parks the request off-thread."""
        return self.request("stream_next", (task_id, idx, timeout),
                            timeout=None if timeout is None else timeout + 10)

    def stream_finished(self, task_id: bytes) -> bool:
        return self.request("stream_finished", task_id)

    def release_stream(self, task_id: bytes):
        try:
            self.request("stream_release", task_id)
        except Exception:  # noqa: BLE001 — release is best effort
            pass

    def request(self, what, arg=None, timeout=30.0):
        """Synchronous control-plane query to the head."""
        fut = concurrent.futures.Future()
        with self._req_lock:
            self._req_seq += 1
            req_id = self._req_seq
            self._req_futures[req_id] = fut
        self.send(("request", req_id, what, arg))
        result = fut.result(timeout)
        if isinstance(result, Exception):
            raise result
        return result

    # -- frame routing --

    def handle_push(self, msg):
        op = msg[0]
        if op == "obj":
            _, oid, status, payload, bufs = msg
            if status == "inline":
                self.object_cache[oid] = serialization.deserialize(payload, bufs)
            elif status == "err":
                self.object_cache[oid] = serialization.deserialize(payload, bufs)
            # "shm": value readable from the store
            if self._dep_pins:
                self._release_dep_pin(oid)
            with self._wait_lock:
                for ev in self._pending_waits.pop(oid, []):
                    ev.set()
        elif op == "reg_fn":
            _, fn_id, blob = msg
            self.functions[fn_id] = pickle.loads(blob)
        elif op == "resp":
            _, req_id, result = msg
            with self._req_lock:
                fut = self._req_futures.pop(req_id, None)
            if fut is not None:
                fut.set_result(result)
        elif op == "actor_moved":
            self.actor_locations.pop(msg[1], None)
        elif op == "pubsub_msg":
            _, channel, key, message = msg
            with self._pubsub_lock:
                cbs = list(self._pubsub_cbs.get((channel, key), ()))
            for cb in cbs:
                try:
                    cb(message)
                except Exception:  # noqa: BLE001 — keep dispatching
                    import traceback
                    traceback.print_exc()
        else:
            raise RuntimeError(f"worker: unknown push {op}")


def _put_with_spill(rt: "WorkerRuntime", oid: ObjectID, value, nbytes: int):
    """Store a value with the spill-before-pressure policy: arena LRU
    eviction silently destroys owned objects, so a head-node worker asks
    the head to make room BEFORE crossing the spill threshold (and retries
    once on full). On other nodes the head could not help — the request is
    skipped and the agent arena's eviction is the pressure valve."""
    from ray_tpu_torch.core.status import ObjectExistsError, ObjectStoreFullError
    on_head = os.environ.get("RAY_TPU_TORCH_IS_HEAD_NODE") == "1"
    if on_head and not rt.store.reservation_fits(nbytes):
        stats = rt.store.stats()
        cap = stats["capacity"] or 1
        limit = get_config().object_spill_threshold * cap
        if stats["allocated"] + nbytes > limit:
            rt.request("spill",
                       int(stats["allocated"] + nbytes - limit) + (4 << 20))
    table = arrow_block_of(value)
    try:
        if table is not None:
            rt.store.put_arrow(oid, table)
        else:
            rt.store.put_serialized(oid, value)
    except ObjectExistsError:
        # Replayed task: a restarted head re-grants any lease whose
        # node_done it never saw, so a PRIOR attempt may have sealed this
        # exact result already. The publication is done — report success
        # (at-least-once execution, exactly-once publication).
        return
    except ObjectStoreFullError:
        if not on_head:
            raise
        rt.request("spill", int(nbytes * 1.5) + (1 << 20))
        try:
            if table is not None:
                rt.store.put_arrow(oid, table)
            else:
                rt.store.put_serialized(oid, value)
        except ObjectExistsError:
            return


GLOBAL: WorkerRuntime | None = None


def _resolve_arg(rt: WorkerRuntime, obj):
    from ray_tpu_torch.core.object_ref import ObjectRef
    if isinstance(obj, ObjectRef):
        return rt._get_one(obj, timeout=60.0)
    return obj


def _resolve_args(rt: WorkerRuntime, args, kwargs):
    """Resolve a task's (args, kwargs), prefetching ref args as ONE
    vectored batch first — a reduce task's N exchange pieces pull
    concurrently (same-source groups over one objxfer round) instead of
    N serial get rounds."""
    from ray_tpu_torch.core.object_ref import ObjectRef
    refs = [a for a in args if isinstance(a, ObjectRef)]
    refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    if len(refs) >= 2:
        rt.prefetch_refs(refs)
    return ([_resolve_arg(rt, a) for a in args],
            {k: _resolve_arg(rt, v) for k, v in kwargs.items()})


def _spec_args(rt: WorkerRuntime, spec: TaskSpec):
    """Decode a spec's (args, kwargs), wherever they live: an offloaded
    shm ArgPack (args_ref), a language-neutral proto payload, or the
    inline pickle frame."""
    aref = getattr(spec, "args_ref", None)
    if aref is not None:
        found, pack = rt.store.get_deserialized(ObjectID(aref), timeout=0)
        if not found:
            # Cross-node call: the pack lives in the submitter's arena;
            # resolve through the normal object plane (head directory ->
            # peer pull), same as any ObjectRef argument.
            from ray_tpu_torch.core.object_ref import ObjectRef
            pack = rt._get_one(ObjectRef(ObjectID(aref)), timeout=60.0)
        return pack.load()
    return serialization.deserialize(spec.payload, spec.buffers)


class _RuntimeEnv:
    """Apply a per-task/actor runtime_env (parity: the runtime-env agent
    materializing env_vars / working_dir / py_modules,
    `_private/runtime_env/agent/runtime_env_agent.py:167`).
    env_vars are node-independent; working_dir/py_modules are applied as
    LOCAL paths and assume a shared filesystem across nodes (no packaging/
    upload yet — a missing path fails the task with FileNotFoundError,
    conda/container isolation out of scope). Context-manager use restores
    state for tasks; actors enter() permanently."""

    def __init__(self, renv: dict | None):
        self.renv = renv or {}
        self._saved_env: dict[str, str | None] = {}
        self._saved_cwd = None
        self._added_paths: list[str] = []

    def __enter__(self):
        import sys as _sys
        try:
            for k, v in (self.renv.get("env_vars") or {}).items():
                self._saved_env[k] = os.environ.get(k)
                os.environ[k] = str(v)
            wd = self.renv.get("working_dir")
            if wd:
                self._saved_cwd = os.getcwd()
                os.chdir(wd)
                if wd not in _sys.path:
                    _sys.path.insert(0, wd)
                    self._added_paths.append(wd)
            for p in self.renv.get("py_modules") or []:
                if p not in _sys.path:
                    _sys.path.insert(0, p)
                    self._added_paths.append(p)
        except BaseException:
            # __exit__ is not called when __enter__ raises: roll back here
            # or the pooled worker keeps half-applied env forever.
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc):
        import sys as _sys
        for k, old in self._saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        if self._saved_cwd is not None:
            os.chdir(self._saved_cwd)
        for p in self._added_paths:
            try:
                _sys.path.remove(p)
            except ValueError:
                pass
        return False


_SYNC_EXEC_LOOP = threading.local()


def _run_coroutine_sync(coro):
    """Drive a coroutine returned by a SYNC-executed function to
    completion. Keeps one loop per executor thread (matching the old
    implicit-get_event_loop() behavior, where loop-bound state survived
    across calls) without the deprecated implicit-loop API that warns on
    3.12+."""
    loop = getattr(_SYNC_EXEC_LOOP, "loop", None)
    if loop is None or loop.is_closed():
        loop = asyncio.new_event_loop()
        _SYNC_EXEC_LOOP.loop = loop
    return loop.run_until_complete(coro)


def _execute(rt: WorkerRuntime, spec: TaskSpec, fn):
    """Runs one task; returns ('ok'|'err', value_or_TaskError)."""
    for oid, (payload, bufs) in spec.inline_deps.items():
        rt.object_cache[oid] = serialization.deserialize(payload, bufs)
    renv_spec = getattr(spec, "runtime_env", None)
    tev = _TEV.enabled
    if tev:
        # Sub-span POINTS are stamped as bare floats and packed into ONE
        # event at seal time (_reply_result) — per-point emits measurably
        # moved the task storm via allocation/GC churn alone.
        spec.exec_ts = [time.time(), 0.0, 0.0]
    try:
        args, kwargs = _spec_args(rt, spec)
        args, kwargs = _resolve_args(rt, args, kwargs)
        if tev:
            spec.exec_ts[1] = time.time()  # args deserialized/resolved
        rt.current_task = spec  # describe() formatted lazily on demand
        # Read by util.placement_group.get_current_placement_group(); lives
        # on the runtime object because this module is __main__ in workers.
        # Actor methods carry no per-task strategy — fall back to the
        # strategy the actor itself was created with.
        rt.current_scheduling_strategy = (
            spec.scheduling_strategy
            or getattr(rt, "actor_scheduling_strategy", None))
        ctx = (contextlib.nullcontext() if renv_spec is None
               else _RuntimeEnv(renv_spec))
        from ray_tpu_torch.util import tracing as _tracing
        span = (_tracing.execute_span(spec.describe(),
                                      getattr(spec, "trace_ctx", None))
                if _tracing._enabled else contextlib.nullcontext())
        with ctx, span:
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = _run_coroutine_sync(result)
        return "ok", result
    except BaseException as e:  # noqa: BLE001 — errors cross the wire
        return "err", TaskError.from_exception(e, spec.describe())
    finally:
        if tev and spec.exec_ts is not None:
            spec.exec_ts[2] = time.time()
        rt.current_scheduling_strategy = getattr(
            rt, "actor_scheduling_strategy", None)


def _execute_streaming(rt: WorkerRuntime, spec: TaskSpec, fn):
    """Run a generator task: one "stream_item" per yield, then a normal
    empty "done" (which closes the stream and re-idles this worker).
    Parity: reference streaming generator execution (_raylet.pyx
    execute_task's streaming path)."""
    cfg = get_config()

    def entry_for(value, status="inline-or-shm"):
        rid = os.urandom(16)
        if status != "err":
            table = arrow_block_of(value)
            if (table is not None
                    and table.nbytes > cfg.max_inline_object_bytes):
                _put_with_spill(rt, ObjectID(rid), table, table.nbytes)
                return (rid, "shm", None, None)
        payload, bufs, _ = serialization.serialize_value(value)
        if status == "err":
            return (rid, "err", payload, bufs)
        nbytes = serialization.total_nbytes(payload, bufs)
        if nbytes <= cfg.max_inline_object_bytes:
            return (rid, "inline", payload, bufs)
        _put_with_spill(rt, ObjectID(rid), value, nbytes)
        return (rid, "shm", None, None)

    renv_spec = getattr(spec, "runtime_env", None)
    if _TEV.enabled:
        task_events.emit_task(spec, "EXEC_START")
    try:
        for oid, (payload, bufs) in spec.inline_deps.items():
            rt.object_cache[oid] = serialization.deserialize(payload, bufs)
        args, kwargs = _spec_args(rt, spec)
        args, kwargs = _resolve_args(rt, args, kwargs)
        rt.current_task = spec
        rt.current_scheduling_strategy = (
            spec.scheduling_strategy
            or getattr(rt, "actor_scheduling_strategy", None))
        from ray_tpu_torch.util import tracing as _tracing
        ctx = (contextlib.nullcontext() if renv_spec is None
               else _RuntimeEnv(renv_spec))
        span = (_tracing.execute_span(spec.describe(),
                                      getattr(spec, "trace_ctx", None))
                if _tracing._enabled else contextlib.nullcontext())
        with ctx, span:
            gen = fn(*args, **kwargs)
            if inspect.isasyncgen(gen):
                raise TypeError(
                    "async-generator streaming methods are not supported; "
                    "use a sync generator (yield from an asyncio loop via "
                    "run_until_complete if needed)")
            for value in gen:
                rt.send(("stream_item", spec.task_id, entry_for(value)))
    except BaseException as e:  # noqa: BLE001 — errors ride the stream
        err = TaskError.from_exception(e, spec.describe())
        try:
            rt.send(("stream_item", spec.task_id, entry_for(err, "err")))
        except OSError:
            pass
    finally:
        if _TEV.enabled:
            task_events.emit_task(spec, "EXEC_DONE")
        rt.current_scheduling_strategy = getattr(
            rt, "actor_scheduling_strategy", None)
    rt.send(("done", spec.task_id, spec.actor_id, []))
    rt.flush_task_events()


def _reply_cancelled(rt: WorkerRuntime, spec: TaskSpec):
    from ray_tpu_torch.core.status import TaskCancelledError
    _reply_result(rt, spec, "err", TaskError.from_exception(
        TaskCancelledError(f"task {spec.describe()} was cancelled"),
        spec.describe()))


def _reply_result(rt: WorkerRuntime, spec: TaskSpec, status, result,
                  batcher: "_ReplyBatcher | None" = None):
    """Report task results. With `batcher`, the reply rides the coalescing
    flusher (one "done_batch" frame per burst of pipelined actor calls)
    instead of its own frame."""
    cfg = get_config()
    n_returns = len(spec.return_ids)
    if status == "ok" and n_returns > 1:
        results = list(result) if isinstance(result, (tuple, list)) else [result]
        if len(results) != n_returns:
            status = "err"
            result = TaskError.from_exception(
                ValueError(f"task returned {len(results)} values, expected {n_returns}"),
                spec.describe())
    if status == "err":
        payload, bufs, _ = serialization.serialize_value(result)
        outs = [(rid, "err", payload, bufs) for rid in spec.return_ids]
    else:
        values = results if n_returns > 1 else [result]
        outs = []
        for rid, value in zip(spec.return_ids, values):
            table = arrow_block_of(value)
            if (table is not None
                    and table.nbytes > cfg.max_inline_object_bytes):
                # Arrow block return: streamed straight into the arena in
                # the tagged IPC layout — no pickle of the block bytes.
                _put_with_spill(rt, ObjectID(rid), table, table.nbytes)
                outs.append((rid, "shm", None, None))
                continue
            payload, bufs, _ = serialization.serialize_value(value)
            nbytes = serialization.total_nbytes(payload, bufs)
            if nbytes <= cfg.max_inline_object_bytes:
                outs.append((rid, "inline", payload, bufs))
            else:
                _put_with_spill(rt, ObjectID(rid), value, nbytes)
                outs.append((rid, "shm", None, None))
    tev = None
    if _TEV.enabled and spec.exec_ts is not None:
        # Packed exec record: (attempt, exec_start, args_ready,
        # exec_done, seal). It PIGGYBACKS ON THE DONE FRAME itself (the
        # ultimate already-sent frame) — the head unpacks it into an
        # EXEC_SPANS pipeline event, so the reply hot path adds three
        # clock reads and one tuple, with no extra frames, ring traffic
        # or flush work (a separate event-ring hop here measurably moved
        # the 1-CPU task storm).
        es, ar, ed = spec.exec_ts
        tev = (max(0, (spec.max_retries or 0)
                   - (spec.retries_left or 0)), es, ar, ed, time.time())
    route = (rt.direct_routes.pop(spec.task_id, None)
             if rt.direct_routes else None)
    if route is not None:
        # Direct-call reply: straight back on the caller's channel — the
        # head/agent never saw this task, so its exec record ships
        # through the event ring instead of a done frame (flushed on the
        # piggybacked cadence).
        if tev is not None:
            _TEV.emit(spec.task_id, tev[0], "EXEC_SPANS", None,
                      tev[1:4], ts=tev[4])
            tev = None
        # Big results went into the node's SHARED arena; notify the head
        # of the location so borrowers beyond the caller can still
        # resolve them (async on agent nodes: the frame rides the relay).
        for entry in outs:
            if entry[1] == "shm":
                rt.send(("put_notify", entry[0]))
        if batcher is not None:
            # A burst of pipelined direct calls coalesces into ONE wdone
            # frame per caller channel (the flusher groups by route).
            batcher.add(spec.task_id, spec.actor_id, outs, route=route)
            return
        if route.alive:
            try:
                route.send(("wdone", [(spec.task_id, outs)]))
                return
            except OSError:
                pass
        # Channel broke under the reply (the caller may well be alive —
        # only its conn died): fall through to a plain head "done". The
        # head banks the outs in its directory and the caller's wait_obj
        # resolves them, so a reply is never silently lost.
    if batcher is not None:
        batcher.add(spec.task_id, spec.actor_id, outs, tev)
        return
    rt.send(("done", spec.task_id, spec.actor_id, outs) if tev is None
            else ("done", spec.task_id, spec.actor_id, outs, tev))
    # Piggyback: a due task-event/metric flush rides the sender batching
    # right behind the done frame (one coalesced write, no extra wakeup).
    rt.flush_task_events()


class _ReplyBatcher:
    """Coalesces actor completion frames with a BOUNDED delay.

    A burst of pipelined fast calls flushes as one "done_batch" (head
    path) or one "wdone" per caller channel (direct worker-peer path); a
    result never waits on the NEXT call's execution (the flusher thread
    sends it within `max_delay` regardless) and flushes immediately when
    the task queue is drained — so get(timeout)/wait progress semantics
    hold even when a slow call sits behind a fast one."""

    def __init__(self, rt: WorkerRuntime, max_delay: float = 0.001,
                 max_batch: int = 64):
        self.rt = rt
        self.max_delay = max_delay
        self.max_batch = max_batch
        self._cv = threading.Condition()
        self._batch: list = []          # head-path entries
        self._routed: list = []         # (route, task_id, actor_id, outs)
        self._urgent = False
        threading.Thread(target=self._loop, daemon=True,
                         name="rtpu-reply-flush").start()

    def add(self, task_id, actor_id, outs, tev=None, route=None):
        with self._cv:
            if route is not None:
                self._routed.append((route, task_id, actor_id, outs))
            else:
                self._batch.append((task_id, actor_id, outs) if tev is None
                                   else (task_id, actor_id, outs, tev))
            if (len(self._batch) + len(self._routed) >= self.max_batch
                    or self.rt.task_queue.empty()):
                self._urgent = True
            self._cv.notify()

    def flush_now(self):
        """Synchronous drain — used at shutdown, where waking the daemon
        flusher would race os._exit. Entries are popped under the lock, so
        a concurrent flusher pass and this call each send disjoint sets."""
        with self._cv:
            batch = self._batch
            routed = self._routed
            self._batch = []
            self._routed = []
            self._urgent = False
        try:
            self._send(batch, routed)
        except OSError:
            pass

    def _send(self, batch: list, routed: list):
        for route, pairs, entries in self._group_routes(routed):
            sent = False
            if route.alive:
                try:
                    route.send(("wdone", pairs))
                    sent = True
                except OSError:
                    pass
            if not sent:
                # Caller channel died under the reply: bank each result
                # at the head instead (its directory resolves the
                # caller's wait_obj) — a reply is never silently lost.
                batch = batch + [(tid, aid, outs)
                                 for (tid, aid, outs) in entries]
        if len(batch) == 1:
            self.rt.send(("done",) + tuple(batch[0]))
        elif batch:
            self.rt.send(("done_batch", batch))

    @staticmethod
    def _group_routes(routed: list):
        if not routed:
            return ()
        groups: dict = {}
        for route, task_id, actor_id, outs in routed:
            g = groups.get(id(route))
            if g is None:
                g = groups[id(route)] = (route, [], [])
            g[1].append((task_id, outs))
            g[2].append((task_id, actor_id, outs))
        return groups.values()

    def _loop(self):
        while True:
            with self._cv:
                while not (self._batch or self._routed):
                    self._urgent = False
                    self._cv.notify_all()
                    self._cv.wait()
                if not self._urgent:
                    # Let a burst accumulate, but never longer than
                    # max_delay past the first pending reply.
                    self._cv.wait(self.max_delay)
                batch = self._batch
                routed = self._routed
                self._batch = []
                self._routed = []
                self._urgent = False
            try:
                self._send(batch, routed)
            except OSError:
                return  # head gone; the worker is about to exit anyway


async def _execute_async(rt, spec, fn):
    from ray_tpu_torch.core.object_ref import ObjectRef
    for oid, (payload, bufs) in spec.inline_deps.items():
        rt.object_cache[oid] = serialization.deserialize(payload, bufs)
    if _TEV.enabled:
        spec.exec_ts = [time.time(), 0.0, 0.0]
    try:
        loop = asyncio.get_running_loop()
        aref = getattr(spec, "args_ref", None)
        payload = spec.payload
        if (aref is None and not spec.buffers
                and getattr(spec, "payload_format", None) != "proto"
                and (payload is None or len(payload) <= 65536)):
            # Fast path (the async ping storm): tiny inline args decode
            # right on the loop — an executor round trip per call costs
            # far more than the unpickle (this hop, plus one per arg and
            # one for the reply, was the bulk of the old per-actor
            # asyncio funnel's 8x gap vs sync actors).
            args, kwargs = serialization.deserialize(payload, spec.buffers)
        else:
            # Off-thread: an offloaded arg pack may need a cross-node
            # fetch.
            args, kwargs = await loop.run_in_executor(
                None, _spec_args, rt, spec)
        if any(type(a) is ObjectRef for a in args):
            # Only ref args can block (store probe / head round trip).
            args = [await loop.run_in_executor(None, _resolve_arg, rt, a)
                    if type(a) is ObjectRef else a for a in args]
        if kwargs:
            kwargs = {k: (await loop.run_in_executor(
                              None, _resolve_arg, rt, v)
                          if type(v) is ObjectRef else v)
                      for k, v in kwargs.items()}
        if _TEV.enabled and spec.exec_ts is not None:
            spec.exec_ts[1] = time.time()
        result = fn(*args, **kwargs)
        if inspect.iscoroutine(result):
            result = await result
        return "ok", result
    except BaseException as e:  # noqa: BLE001
        return "err", TaskError.from_exception(e, spec.describe())
    finally:
        if _TEV.enabled and spec.exec_ts is not None:
            spec.exec_ts[2] = time.time()


class _AsyncShard:
    """One event-loop thread of the sharded async-actor executor."""

    __slots__ = ("idx", "dq", "loop", "wake", "sem", "inflight", "thread")

    def __init__(self, idx: int):
        self.idx = idx
        self.dq: collections.deque = collections.deque()
        self.loop = None
        self.wake = None
        self.sem = None
        self.inflight = 0
        self.thread = None


class _AsyncActorExecutor:
    """Sharded, work-stealing asyncio executor for async actors.

    Replaces the single per-actor asyncio funnel: N threads each run
    their own event loop; the worker's main thread dispatches specs to
    the least-loaded shard's deque, and a shard that drains its own
    queue steals from the busiest sibling (deque ops are atomic under
    the GIL, so steals need no locks). Replies coalesce through the
    shared _ReplyBatcher — direct-path results flush as ONE wdone frame
    per caller channel per burst.

    Concurrency semantics: max_concurrency splits across shards (each
    shard bounds its slice with an asyncio.Semaphore). With >1 shard,
    coroutines of one actor run on several OS threads — the GIL keeps
    attribute access atomic, but methods that mutate instance state
    across awaits and assumed loop-serialized interleaving should set
    async_actor_executor_shards=1."""

    def __init__(self, rt: WorkerRuntime, n_shards: int,
                 max_concurrency: int, batcher: "_ReplyBatcher"):
        self.rt = rt
        self.batcher = batcher
        self.stopping = False
        per = max(1, max_concurrency // n_shards)
        # Append as they boot: a shard's loop may probe `shards` (steal)
        # before its siblings exist.
        self.shards: list[_AsyncShard] = []
        for i in range(n_shards):
            self.shards.append(self._start_shard(i, per))

    def _start_shard(self, idx: int, per: int) -> _AsyncShard:
        sh = _AsyncShard(idx)
        ready = threading.Event()

        def run():
            asyncio.run(self._shard_main(sh, per, ready))

        sh.thread = threading.Thread(target=run, daemon=True,
                                     name=f"rtpu-async-{idx}")
        sh.thread.start()
        ready.wait()
        return sh

    def _steal(self, me: _AsyncShard):
        busiest, depth = None, 0
        for sh in self.shards:
            if sh is not me and len(sh.dq) > depth:
                busiest, depth = sh, len(sh.dq)
        if busiest is None:
            return None
        try:
            return busiest.dq.pop()  # newest end: cheapest cache handoff
        except IndexError:
            return None

    async def _shard_main(self, sh: _AsyncShard, per: int,
                          ready: threading.Event):
        sh.loop = asyncio.get_running_loop()
        sh.wake = asyncio.Event()
        sh.sem = asyncio.Semaphore(per)
        ready.set()
        rt = self.rt
        while True:
            try:
                item = sh.dq.popleft()
            except IndexError:
                item = self._steal(sh)
            if item is None:
                if self.stopping:
                    break
                sh.wake.clear()
                # Re-check after clear: a dispatcher append + set that
                # landed between the steal miss and the clear is caught
                # by this probe instead of sleeping until the next wake.
                if not sh.dq:
                    await sh.wake.wait()
                continue
            spec, fn, streaming = item
            if streaming:
                # Sync-generator streaming works on async actors too: the
                # generator runs on an executor thread (async generators
                # are rejected inside _execute_streaming).
                sh.loop.run_in_executor(None, _execute_streaming,
                                        rt, spec, fn)
                continue
            sh.inflight += 1
            sh.loop.create_task(self._run_one(sh, spec, fn))
        while sh.inflight:  # graceful drain before the loop closes
            await asyncio.sleep(0.005)

    async def _run_one(self, sh: _AsyncShard, spec, fn):
        rt = self.rt
        try:
            async with sh.sem:
                status, result = await _execute_async(rt, spec, fn)
            if status == "ok" and (
                    result is None or type(result) in (bool, int, float)
                    or (type(result) in (str, bytes) and len(result) < 8192)):
                # Small scalar reply: serialize + batch right on the loop
                # (one more executor hop would dominate a ping()).
                _reply_result(rt, spec, status, result,
                              batcher=self.batcher)
            else:
                await sh.loop.run_in_executor(
                    None, _reply_result, rt, spec, status, result,
                    self.batcher)
        except Exception:  # noqa: BLE001 — a reply failure must not
            traceback.print_exc()  # kill the shard loop
        finally:
            sh.inflight -= 1

    def run(self):
        """Dispatcher — runs on the worker's main thread (the old per-
        task queue-get executor hop is gone: the blocking get happens
        here, off every event loop)."""
        rt = self.rt
        shards = self.shards
        while not rt.shutdown.is_set():
            spec = rt.task_queue.get()
            if spec is None:
                break
            if spec.task_id in rt.cancelled_tasks:
                rt.cancelled_tasks.discard(spec.task_id)
                _reply_cancelled(rt, spec)
                continue
            fn = _actor_method(rt, spec)
            target = shards[0]
            if len(shards) > 1:
                load = len(target.dq) + target.inflight
                for sh in shards[1:]:
                    ln = len(sh.dq) + sh.inflight
                    if ln < load:
                        target, load = sh, ln
            target.dq.append(
                (spec, fn, bool(getattr(spec, "streaming", False))))
            try:
                target.loop.call_soon_threadsafe(target.wake.set)
            except RuntimeError:
                # Target loop died (crash on its thread): any live
                # sibling can steal the queued item once woken.
                for sh in shards:
                    try:
                        sh.loop.call_soon_threadsafe(sh.wake.set)
                        break
                    except RuntimeError:
                        continue
        self.stopping = True
        for sh in shards:
            try:
                sh.loop.call_soon_threadsafe(sh.wake.set)
            except RuntimeError:
                pass  # loop already closed
        for sh in shards:
            sh.thread.join(timeout=5.0)


def _run_actor_async(rt: WorkerRuntime, max_concurrency: int,
                     batcher: "_ReplyBatcher | None" = None):
    """Sharded asyncio executor for async actors (parity: fiber.h async
    actors, distributed over async_actor_executor_shards event loops)."""
    cfg = get_config()
    conc = max_concurrency or cfg.async_actor_default_max_concurrency
    n = cfg.async_actor_executor_shards
    if n <= 0:
        n = max(1, min(4, (os.cpu_count() or 1) // 2))
    n = max(1, min(n, conc))
    if batcher is None:
        batcher = _ReplyBatcher(rt)
    _AsyncActorExecutor(rt, n, conc, batcher).run()
    batcher.flush_now()


def _ensure_gpu_visibility(num_gpus, gpu_ids) -> None:
    """Point this worker's CUDA at the GPUs its task or actor reserved.

    Pooled workers boot with CUDA_VISIBLE_DEVICES="" (accelerator
    visibility, parity: the reference's per-worker CUDA_VISIBLE_DEVICES
    assignment); a task or actor with num_gpus > 0 sets the device ids the
    head assigned it (`gpu_ids`) before its first CUDA call, and one with
    num_gpus = 0 sees no device. CUDA reads the variable once, when a
    process first initializes it, so a worker whose CUDA is already up
    keeps the devices it has: another set raises instead of running on the
    wrong card (a pipelined task of the same key holds the same ids)."""
    if num_gpus and not gpu_ids:
        return  # the ids of the reservation this worker already runs under
    want = ",".join(gpu_ids) if num_gpus else ""
    if os.environ.get("CUDA_VISIBLE_DEVICES") == want:
        return
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        if num_gpus:
            raise RuntimeError(
                f"this worker's CUDA runs on CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}; a task "
                f"reserving devices {want!r} cannot switch it")
        return
    os.environ["CUDA_VISIBLE_DEVICES"] = want


def _actor_method(rt: WorkerRuntime, spec: TaskSpec):
    if spec.method_name == "__run_with_instance__":
        # Escape hatch used by compiled graphs (ray_tpu_torch.dag): the first task
        # argument is a pickled fn(instance, *rest) executed against the
        # live actor instance (parity: the injected do_exec_tasks loop,
        # reference dag/compiled_dag_node.py:193).
        def run(fn, *args, **kwargs):
            return fn(rt.actor_instance, *args, **kwargs)
        return run
    method = getattr(rt.actor_instance, spec.method_name)
    return method


def main():
    if sys.argv[1] == "--zygote":
        return zygote_main(sys.argv[2], int(sys.argv[3]))
    _worker_main(sys.argv[1], WorkerID.from_hex(sys.argv[2]), int(sys.argv[3]))


def _die_with_parent():
    """PR_SET_PDEATHSIG: the kernel SIGKILLs this process when its parent
    dies. Belt-and-braces over the socket-EOF exit path — a SIGKILLed
    head/agent/zygote must never leave orphaned workers stealing the box
    (r4's bench starved behind exactly such a leak)."""
    if sys.platform != "linux":
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, 9, 0, 0, 0)  # PR_SET_PDEATHSIG, SIGKILL
    except Exception:  # noqa: BLE001 — hardening only
        pass


def zygote_main(store_path: str, ctrl_fd: int):
    """Forkserver: pays the interpreter+torch import cost once, then forks
    a ready-to-run worker in milliseconds per head request.

    Parity note: the reference amortizes worker startup with prestarted idle
    workers (`src/ray/raylet/worker_pool.h:228` prestart + idle cache); on this
    runtime a fork zygote additionally makes cold spawns (actor bursts, pool
    replenish after OOM kills) cheap. Protocol: head sends one JSON line plus
    one SCM_RIGHTS fd per spawn; zygote replies with the child pid.
    """
    import array
    import json
    import signal
    import socket as socket_mod
    import struct

    _die_with_parent()
    # Import torch, never initialize CUDA: a CUDA context does not survive
    # a fork, and each child sets its own CUDA_VISIBLE_DEVICES first (so
    # nothing here may call torch.cuda, is_available() included: it
    # initializes the driver).
    try:
        import torch  # noqa: F401
    except ImportError:
        pass
    if Config.from_env().gc_freeze_init:
        # Freeze the warmed torch universe BEFORE forking: children skip
        # re-scanning ~1M immortal objects on every full collection, and
        # the frozen pages stay COW-shared across the whole pool (gc
        # headers are never dirtied by gen-2 passes).
        import gc
        gc.freeze()

    # Live children (pid stays a zombie — unrecyclable — until we reap it
    # here, so a "kill" request can never hit a recycled pid).
    live: set[int] = set()

    def _reap(_sig=None, _frame=None):
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            live.discard(pid)

    signal.signal(signal.SIGCHLD, _reap)
    ctrl = socket_from_fd(ctrl_fd)
    # staticcheck: ok fd-use-unguarded — process-lifetime socket: the
    # zygote exits with its ctrl channel; any failure here kills it.
    ctrl.sendall(b"RDY0")
    fdsize = array.array("i").itemsize
    while True:
        fds = array.array("i")
        try:
            msg, ancdata, _flags, _addr = ctrl.recvmsg(
                4096, socket_mod.CMSG_LEN(fdsize))
        except OSError:
            os._exit(0)
        if not msg:
            os._exit(0)
        for level, ctype, data in ancdata:
            if level == socket_mod.SOL_SOCKET and ctype == socket_mod.SCM_RIGHTS:
                fds.frombytes(data[: len(data) - (len(data) % fdsize)])
        req = json.loads(msg)
        if "kill" in req:
            pid = req["kill"]
            if pid in live:
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            ctrl.sendall(struct.pack("<I", 0))
            continue
        fd = fds[0]
        # Block SIGCHLD so a fast-exiting child can't be reaped before it is
        # in `live` (which would leave a stale pid eligible for os.kill).
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGCHLD})
        pid = os.fork()
        if pid == 0:
            signal.signal(signal.SIGCHLD, signal.SIG_DFL)
            signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGCHLD})
            ctrl.close()
            logf = os.open(req["log"], os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
            os.dup2(logf, 1)
            os.dup2(logf, 2)
            os.close(logf)
            try:
                _worker_main(store_path, WorkerID.from_hex(req["worker_id"]), fd)
            except BaseException:  # noqa: BLE001 — log then die nonzero;
                traceback.print_exc()  # os._exit skips the excepthook
                os._exit(1)
            os._exit(0)
        live.add(pid)
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGCHLD})
        os.close(fd)
        ctrl.sendall(struct.pack("<I", pid))


def _worker_main(store_path: str, worker_id: WorkerID, fd: int):
    _die_with_parent()
    set_config(Config.from_env())
    if get_config().gc_gen0_threshold > 0:
        # Same rationale as the head runtime: don't run a gc pass (plus
        # jax's gc callback) every ~70 control messages.
        import gc
        gc.set_threshold(get_config().gc_gen0_threshold)  # gens 1-2 as-is
    venv_site = os.environ.get("RAY_TPU_TORCH_VENV_SITE")
    if venv_site:
        # Env-pool worker: the pip env's packages shadow the host env for
        # every task this worker runs (parity: pip runtime_env activation).
        sys.path.insert(0, venv_site)
    if get_config().gc_freeze_init:
        import gc
        gc.freeze()  # covers zygote-less spawns and anything the fork
        # itself allocated; a second freeze after the zygote's is a no-op
    sock = socket_from_fd(fd)

    from ray_tpu_torch.util import tracing as _tracing
    _tracing.maybe_setup_from_env()
    task_events.configure(get_config())

    import queue
    rt = WorkerRuntime(sock, worker_id, store_path)
    rt.task_queue = queue.Queue()
    global GLOBAL
    GLOBAL = rt
    # Route the public API inside this process to the worker runtime.
    from ray_tpu_torch.core import runtime as runtime_mod
    runtime_mod.set_worker_runtime(rt)

    # Pooled workers listen for direct peer calls (head-node AND agent-
    # node); the path rides the ready frame so the head can hand it to
    # same-node callers resolving this worker's actor.
    peer_path = rt.start_peer_listener()
    rt.send(("ready", worker_id.binary(), os.getpid(),
             os.environ.get("RAY_TPU_TORCH_ENV_KEY") or None, peer_path))

    def _gate_maintenance():
        # The order gate needs a pump for gap timeouts (the agent's
        # select loop plays this role on agent nodes).
        n = 0
        while not rt.shutdown.is_set():
            time.sleep(1.0)
            n += 1
            if rt.order_gate.buffered:
                rt.order_gate.flush_expired()
            if n % 60 == 0:
                rt.order_gate.sweep()

    if not rt.on_agent_node or peer_path is not None:
        # A worker with a peer listener owns the order gate for its
        # actor (peer frames race agent/head-relayed ones); a gate needs
        # a pump for gap timeouts. Agent-node workers WITHOUT a listener
        # never feed their gate (the agent's gate orders their frames).
        threading.Thread(target=_gate_maintenance, daemon=True,
                         name="rtpu-gate").start()

    if _TEV.enabled:
        # Cadence floor for the event/metric flush: the reply-path
        # piggyback covers busy workers; this covers the tail batch an
        # idle worker would otherwise hold forever.
        def _tev_floor():
            period = max(0.05,
                         get_config().task_events_flush_ms / 1000.0)
            while not rt.shutdown.is_set():
                time.sleep(period)
                try:
                    rt.flush_task_events()
                except Exception:  # noqa: BLE001 — flusher must survive
                    pass

        threading.Thread(target=_tev_floor, daemon=True,
                         name="rtpu-tev-flush").start()

    actor_cfg = {}
    executor_threads: list[threading.Thread] = []

    def receiver():
        # Buffered framing: one big recv drains many queued messages (the
        # head pipelines actor calls), halving syscalls vs per-frame reads.
        fb = FrameBuffer()
        pending = []
        while True:
            if not pending:
                try:
                    data = sock.recv(1 << 20)
                except OSError:
                    data = b""
                if not data:
                    rt.shutdown.set()
                    rt.task_queue.put(None)
                    os._exit(0)
                fb.feed(data)
                pending = fb.frames()
                if not pending:
                    continue
            msg = pending.pop(0)
            op = msg[0]
            if op == "batch":
                # One head-side sendall carrying several dispatch frames
                # (pipelined same-key tasks); unpack in order.
                pending[0:0] = msg[1]
                continue
            if op == "exec_raw":
                # Native lease plane (cpp/agent_core.cc dispatch): the
                # spec rides as raw pickle bytes, decoded HERE — the one
                # process that executes it. Only dep-free plain tasks
                # lease, so there is no actor ordering to gate.
                rt.task_queue.put(pickle.loads(msg[1]))
                continue
            if op == "exec":
                spec = msg[1]
                if (spec.actor_id is not None
                        and getattr(spec, "caller_seq", None) is not None
                        and (not rt.on_agent_node
                             or rt._peer_path is not None)):
                    # Head/agent-relayed frames race the worker peer
                    # plane for the same (caller, actor): restore
                    # submission order. Only workers that OWN a peer
                    # listener gate — the gate must be the single
                    # ordering point, so the agent delivers their frames
                    # ungated (and forwards seq_skips here). A listener-
                    # less agent-node worker's frames were already
                    # ordered by its agent's gate, and gating twice
                    # would stall every skip-released slot until the
                    # gap timeout.
                    rt.order_gate.submit(
                        spec, lambda s=spec: rt.task_queue.put(s))
                else:
                    rt.task_queue.put(spec)
            elif op == "seq_skip":
                rt.order_gate.skip(msg[1], msg[2], msg[3])
            elif op == "create_actor":
                actor_cfg["spec"] = msg[1]
                rt.task_queue.put(("__create_actor__", msg[1]))
            elif op == "cancel_task":
                # Best-effort: the executor drops the task if it has not
                # started yet (parity: CancelTask on the receiving worker).
                # Bounded — a cancel that lost the race to an already-
                # started call would otherwise leak its entry forever.
                if len(rt.cancelled_tasks) > 1024:
                    rt.cancelled_tasks.pop()
                rt.cancelled_tasks.add(msg[1])
            elif op == "drop_task":
                # Steal phase one from the scheduler. Under steal_lock
                # against the executor: if the task has begun, refuse the
                # drop (ack False — the head aborts the steal and this
                # execution stands); else mark it dropped so the executor
                # skips it WITHOUT a cancelled reply — a reply would poison
                # the re-dispatched task's return objects.
                with rt.steal_lock:
                    began = msg[1] in rt.begun_tasks
                    if not began:
                        if len(rt.dropped_tasks) > 1024:
                            rt.dropped_tasks.popitem()
                        rt.dropped_tasks[msg[1]] = (
                            rt.dropped_tasks.get(msg[1], 0) + 1)
                try:
                    rt.send(("drop_ack", msg[1], not began))
                except OSError:
                    pass
            elif op == "profile":
                # On-demand stack sampling (parity: dashboard reporter's
                # py-spy endpoint); runs on a side thread so the executor
                # keeps working while being observed.
                def _prof(token=msg[1], duration=msg[2], hz=msg[3]):
                    from ray_tpu_torch.util.profiling import sample_stacks
                    try:
                        report = sample_stacks(duration, hz)
                    except Exception as e:  # noqa: BLE001
                        report = {"error": str(e)}
                    try:
                        rt.send(("profile_result", token, report))
                    except OSError:
                        pass

                threading.Thread(target=_prof, daemon=True).start()
            elif op == "shutdown":
                rt.shutdown.set()
                rt.task_queue.put(None)
            else:
                rt.handle_push(msg)

    threading.Thread(target=receiver, daemon=True, name="rtpu-recv").start()

    def create_actor(cspec):
        try:
            _ensure_gpu_visibility(cspec.num_gpus, cspec.gpu_ids)
            cls = rt.functions[cspec.cls_id]
            args, kwargs = serialization.deserialize(cspec.payload, cspec.buffers)
            args, kwargs = _resolve_args(rt, args, kwargs)
            # Set before __init__ so get_current_placement_group() works
            # inside the constructor too.
            rt.actor_scheduling_strategy = cspec.scheduling_strategy
            # Actors keep their runtime_env for life (no __exit__).
            _RuntimeEnv(getattr(cspec, "runtime_env", None)).__enter__()
            rt.actor_instance = cls(*args, **kwargs)
            rt.actor_id = cspec.actor_id
            rt.send(("actor_ready", cspec.actor_id))
            return cspec
        except BaseException as e:  # noqa: BLE001
            err = TaskError.from_exception(e, f"{cspec.name}.__init__")
            payload, bufs, _ = serialization.serialize_value(err)
            rt.send(("actor_err", cspec.actor_id, payload, bufs))
            return None

    # Main executor loop. Plain workers and sync actors execute inline;
    # threaded actors fan out to a pool; async actors switch to asyncio.
    # Sync actor replies coalesce through the bounded-delay _ReplyBatcher.
    pool: concurrent.futures.ThreadPoolExecutor | None = None
    batcher = _ReplyBatcher(rt)
    while not rt.shutdown.is_set():
        item = rt.task_queue.get()
        if item is None:
            batcher.flush_now()
            break
        if isinstance(item, tuple) and item[0] == "__create_actor__":
            cspec = create_actor(item[1])
            if cspec is None:
                continue
            if cspec.is_async:
                _run_actor_async(rt, cspec.max_concurrency, batcher)
                break
            if cspec.max_concurrency and cspec.max_concurrency > 1:
                pool = concurrent.futures.ThreadPoolExecutor(cspec.max_concurrency)
            continue
        spec: TaskSpec = item
        with rt.steal_lock:
            n_drops = rt.dropped_tasks.get(spec.task_id, 0)
            if n_drops:
                if n_drops == 1:
                    del rt.dropped_tasks[spec.task_id]
                else:
                    rt.dropped_tasks[spec.task_id] = n_drops - 1
                dropped = True
            else:
                # Atomic with the drop check: once marked begun, a
                # drop_task will be refused (ack False) instead of racing
                # this execution.
                dropped = False
                if len(rt.begun_tasks) > 4096:
                    rt.begun_tasks.pop()
                rt.begun_tasks.add(spec.task_id)
        if dropped:
            continue
        if spec.task_id in rt.cancelled_tasks:
            rt.cancelled_tasks.discard(spec.task_id)
            _reply_cancelled(rt, spec)
            continue
        chaos.kill("worker.exec.kill")  # SIGKILL with the task accepted
        # but un-replied: the head's worker-death replay owns recovery
        if spec.actor_id is None:
            _ensure_gpu_visibility(spec.num_gpus, spec.gpu_ids)
        if spec.actor_id is not None:
            fn = _actor_method(rt, spec)
        else:
            fn = rt.functions.get(spec.fn_id)
            if fn is None:
                err = TaskError.from_exception(
                    RuntimeError(f"function {spec.fn_id.hex()} not registered"),
                    spec.describe())
                _reply_result(rt, spec, "err", err)
                continue
        if getattr(spec, "streaming", False):
            _execute_streaming(rt, spec, fn)
            continue
        if pool is not None and spec.actor_id is not None:
            def run(sp=spec, f=fn):
                status, result = _execute(rt, sp, f)
                _reply_result(rt, sp, status, result)
            pool.submit(run)
        else:
            status, result = _execute(rt, spec, fn)
            # Plain tasks reply directly: the scheduler leases one task at
            # a time and waits for the done to re-idle this worker.
            _reply_result(rt, spec, status, result,
                          batcher=batcher if spec.actor_id is not None
                          else None)

    batcher.flush_now()
    rt.flush_task_events(force=True)  # last events/metrics out the door
    rt.flush_sends()  # the sender thread must drain before os._exit
    if rt._store is not None:
        # Graceful exits return the write-reservation tail; a SIGKILLed
        # worker strands at most one extent until the arena is unlinked.
        rt._store.close()
    os._exit(0)


if __name__ == "__main__":
    main()
