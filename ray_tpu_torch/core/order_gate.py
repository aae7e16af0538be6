"""Per-(caller, actor) submission-order gate for actor-call executors.

Parity: the sequence-number enforcement of the reference's direct actor
transport (`src/ray/core_worker/transport/actor_task_submitter.h:78`,
ordered delivery with out-of-order buffering, and the post-resolution
ordering of `dependency_resolver.h` — a dep-gated call's slot is
skip-released so later calls don't stall behind it).

Used by TWO executors that each receive actor execs over racing
transports and must restore the caller's submission order:

- the node agent (direct agent<->agent channel racing the head relay),
- head-node pooled workers (the worker<->worker peer plane racing the
  head's exec dispatch).

A sequence gap that never fills — a call that failed before reaching
this executor — resyncs after GAP_TIMEOUT so one lost call can't wedge
the actor. A brand-new key (actor just placed/restarted here) adopts the
lowest arriving seq after the much shorter FRESH_TIMEOUT, since the
caller's counter survives actor migrations. Release order is protected
by a per-key single drainer: a concurrent arrival can never overtake a
released-but-not-yet-delivered earlier frame.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback


class OrderGate:
    GAP_TIMEOUT = 5.0    # s to wait for a missing mid-stream seq
    # A brand-new key can't tell "actor migrated here mid-stream" (lowest
    # in-flight seq is the caller's live counter, adopt it) from "the
    # caller's first-ever calls raced and the head relay is behind" (seq
    # 0 is coming, wait for it). 2s covers any realistic head-relay lag.
    FRESH_TIMEOUT = 2.0
    KEY_TTL = 600.0      # s of inactivity before a key is swept

    def __init__(self):
        # key -> [next_seq, buf {seq: (deliver, on_drop, target,
        #         deadline)}, out deque, draining flag, last_used,
        #         delivered_any, skip-released slots]
        self._order: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self.buffered = 0  # frames parked waiting for a gap (for pacing)

    def submit(self, spec, deliver, on_drop=None, target=None):
        """Deliver an actor exec in per-(caller, actor) submission order.

        `deliver()` performs the actual dispatch; `on_drop()` fails the
        call back to its origin if `target` dies while the frame is
        buffered (None = the sender replays it itself). Specs without a
        caller_seq/owner bypass the gate entirely (single-transport
        callers need no reordering).
        """
        seq = getattr(spec, "caller_seq", None)
        if seq is None or spec.owner is None or spec.actor_id is None:
            deliver()
            return
        key = (spec.owner, spec.actor_id)
        now = time.monotonic()
        with self._lock:
            st = self._key_locked(key, now)
            if seq > st[0]:
                timeout = (self.GAP_TIMEOUT if st[5]
                           else self.FRESH_TIMEOUT)
                if seq not in st[1]:  # dup = retry of a buffered frame;
                    self.buffered += 1  # keep one count
                st[1][seq] = (deliver, on_drop, target, now + timeout)
                self._advance_locked(st)  # skips may gate the way
            else:
                st[2].append(deliver)
                st[5] = True
                if seq == st[0]:
                    st[0] += 1
                    self._advance_locked(st)
                # seq < st[0]: a slot consumed earlier — a head-path
                # retry after a fallback, or a dep-gated call the head
                # skip-released (it orders at dep-resolution time) —
                # deliver in queue order.
        self._drain(st)

    def skip(self, owner: bytes, actor_id: bytes, seq: int):
        """Sender notice: slot `seq` parked on pending deps and will
        arrive later (delivered at dep-resolution time, reference
        semantics); release its successors now."""
        with self._lock:
            st = self._key_locked((owner, actor_id), time.monotonic())
            if seq < st[0]:
                return
            st[6].add(seq)
            if len(st[6]) > 4096:  # lost-call hygiene: skips are tiny
                st[6] = {s for s in st[6] if s >= st[0]}
            self._advance_locked(st)
        self._drain(st)

    def _key_locked(self, key, now):
        st = self._order.get(key)
        if st is None:
            st = self._order[key] = [0, {}, collections.deque(),
                                    False, now, False, set()]
        st[4] = now
        return st

    def _advance_locked(self, st):
        """Release every consecutive buffered or skip-released slot from
        st[0]; on progress, extend the remaining buffered deadlines — a
        slow-but-advancing relay is not a gap."""
        progressed = False
        while True:
            if st[0] in st[1]:
                d, _f, _t, _dl = st[1].pop(st[0])
                self.buffered -= 1
                st[2].append(d)
                st[0] += 1
                progressed = True
            elif st[0] in st[6]:
                st[6].discard(st[0])
                st[0] += 1
                progressed = True
            else:
                break
        if progressed:
            st[5] = True
            if st[1]:
                ddl = time.monotonic() + self.GAP_TIMEOUT
                for s, e in list(st[1].items()):
                    st[1][s] = (e[0], e[1], e[2], ddl)

    def _drain(self, st):
        """Single-drainer: deliver the key's released frames in order."""
        with self._lock:
            if st[3] or not st[2]:
                return
            st[3] = True
        while True:
            with self._lock:
                if not st[2]:
                    st[3] = False
                    return
                d = st[2].popleft()
            try:
                d()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def flush_expired(self):
        """A buffered seq waited past its deadline: the missing call died
        en route (e.g. failed at the head) or predates this key (actor
        migrated here mid-stream). Resync to the lowest buffered seq."""
        now = time.monotonic()
        drain = []
        with self._lock:
            for st in self._order.values():
                buf = st[1]
                if not buf or min(e[3] for e in buf.values()) > now:
                    continue
                st[0] = min(buf)
                st[6] = {s for s in st[6] if s > st[0]}
                self._advance_locked(st)
                drain.append(st)
        for st in drain:
            self._drain(st)

    def drop_for_target(self, target):
        """`target` died: flush its buffered execs to their drop handlers
        (direct calls fall back through the head; head-path calls are
        simply dropped — the head replays them on worker death). Keys
        survive the death: a restart continues the caller's counter
        seamlessly; elsewhere, a fresh key adopts the live counter after
        FRESH_TIMEOUT."""
        dropped = []
        with self._lock:
            for key, st in list(self._order.items()):
                for seq, entry in list(st[1].items()):
                    if entry[2] == target:
                        del st[1][seq]
                        self.buffered -= 1
                        dropped.append(entry[1])
        for on_drop in dropped:
            if on_drop is not None:
                try:
                    on_drop()
                except Exception:  # noqa: BLE001
                    traceback.print_exc()

    def sweep(self):
        """TTL sweep of idle keys (callers and actors come and go; the
        gate must not grow without bound)."""
        cutoff = time.monotonic() - self.KEY_TTL
        with self._lock:
            for key, st in list(self._order.items()):
                if st[4] < cutoff and not st[1] and not st[2]:
                    del self._order[key]
