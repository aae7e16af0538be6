"""Task-event pipeline: per-process emission ring + head-side storage.

Parity: reference `src/ray/core_worker/task_event_buffer.h:225` (every
process buffers task state-transition events in a bounded, drop-oldest
buffer and flushes them in batches) and
`src/ray/gcs/gcs_server/gcs_task_manager.h:94` (`GcsTaskManagerStorage`:
the head merges per-attempt events into a bounded store with per-job
eviction and drop accounting), powering `ray.timeline()`
(`python/ray/_private/state.py:965` Chrome-trace export) and
`ray summary tasks`.

Three halves live here:

* **Emit** — `ring()` is the process-global `TaskEventRing`. Emission
  sites on the hot paths (head submit/lease/dispatch, agent spill hops
  and worker choice, worker exec sub-spans, TensorChannel and objxfer
  transfers) guard on `ring().enabled` and append one small tuple; the
  ring is a drop-oldest deque with a dropped-events counter, so a stalled
  flusher can never grow memory or block an emitter.
* **Ship** — owners of a transport drain the ring with `drain()` and ship
  `("task_events", batch, dropped)` frames piggybacked on traffic they
  already send (workers: the write-combined reply channel; agents: the
  select-round head batch + heartbeats). No new connections, no new
  wakeups.
* **Consume** — the head's `TaskEventStorage` merges batches per
  (task_id, attempt), serves `timeline()` / `summary_tasks()` /
  `list_task_events()` / the dashboard, and derives per-stage latency
  histograms at scrape time.

Event wire tuple (pickle-framed, like every control message):
    (task_id: bytes|None, attempt: int, state: str, ts: float,
     name: (base, method)|str|None, data: dict|None)
A `state == "SPAN"` entry is a resource span (TensorChannel write/read,
objxfer pull): task_id is None, `name` is the label and `data` carries
{"kind", "dur", ...}.
"""

from __future__ import annotations

import collections
import threading
import time

# ---------------- emission ring (every process) ----------------

#: Worker-side execution sub-states, in order. EXEC_START..ARGS_READY is
#: the deserialize-args sub-span, ..EXEC_DONE the user function,
#: ..OUTPUTS_SEALED serialize/seal of the outputs.
EXEC_STATES = ("EXEC_START", "ARGS_READY", "EXEC_DONE", "OUTPUTS_SEALED")

#: States after which an attempt is settled (storage evicts these first).
TERMINAL_STATES = ("FINISHED", "FAILED")


class TaskEventRing:
    """Lock-light bounded ring of task events (drop-oldest).

    `emit` is the hot-path append: one `enabled` check, one tuple, one
    deque append — all GIL-atomic enough that no lock is taken (the
    dropped counter is best-effort exact under single-writer sites and
    approximate under concurrent writers, which is the accounting the
    reference's buffer makes too: it reports drops, it does not
    serialize emitters to count them)."""

    __slots__ = ("events", "enabled", "dropped", "capacity")

    def __init__(self, capacity: int = 10000, enabled: bool = False):
        self.capacity = capacity
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.enabled = enabled
        self.dropped = 0  # monotonic; drain() reports deltas

    def configure(self, enabled: bool, capacity: int):
        """(Re-)latch onto a resolved config. Drops anything buffered —
        a re-init in the same process (tests, notebooks) must not leak a
        previous session's events into the new head store."""
        self.enabled = bool(enabled)
        self.dropped = 0
        if capacity != self.capacity:
            self.capacity = capacity
            self.events = collections.deque(maxlen=capacity)
        else:
            self.events.clear()

    def emit(self, task_id, attempt: int, state: str, name=None,
             data: dict | None = None, ts: float | None = None):
        if not self.enabled:
            return
        ev = self.events
        if len(ev) >= self.capacity:
            self.dropped += 1
        ev.append((task_id, attempt, state,
                   time.time() if ts is None else ts, name, data))

    def emit_span(self, kind: str, label: str, ts: float, dur: float,
                  **data):
        if not self.enabled:
            return
        data["kind"] = kind
        data["dur"] = dur
        ev = self.events
        if len(ev) >= self.capacity:
            self.dropped += 1
        ev.append((None, 0, "SPAN", ts, label, data))

    def drain(self, max_events: int = 4096):
        """Pop up to `max_events` oldest events + the drop delta since the
        last drain. Safe against concurrent emitters (deque.popleft)."""
        ev = self.events
        if not ev and not self.dropped:
            return [], 0
        out = []
        try:
            for _ in range(min(len(ev), max_events)):
                out.append(ev.popleft())
        except IndexError:
            pass  # raced an emitter on the last slot
        dropped, self.dropped = self.dropped, 0
        return out, dropped


_RING = TaskEventRing()


def ring() -> TaskEventRing:
    """The process-global emission ring (a singleton: `configure`
    mutates it in place so references captured at import stay live)."""
    return _RING


def configure(cfg):
    """Latch the ring onto the resolved config (head runtime, node agent
    and worker processes each call this once at boot)."""
    _RING.configure(bool(cfg.task_events),
                    int(cfg.task_events_buffer_size) or 1)


def attempt_of(spec) -> int:
    """Attempt number of a TaskSpec: retries consumed so far. The head
    decrements `retries_left` before a replay is re-dispatched, so every
    process holding the spec derives the same number."""
    try:
        return max(0, (spec.max_retries or 0) - (spec.retries_left or 0))
    except AttributeError:
        return 0


def emit_task(spec, state: str, data: dict | None = None,
              ts: float | None = None):
    """Emit one state transition for `spec` into the process ring."""
    if not _RING.enabled:
        return
    _RING.emit(spec.task_id, attempt_of(spec), state,
               (spec.name, spec.method_name), data, ts)


def format_name(name) -> str:
    if isinstance(name, str):
        return name
    if not name:
        return "task"
    base, method = name
    return f"{base}.{method}" if method else (base or "task")


# ---------------- head-side storage ----------------


class TaskAttempt:
    """Merged view of one (task_id, attempt): every event that named it,
    wherever it was emitted, sorted by wall-clock at read time."""

    __slots__ = ("task_id", "attempt", "name", "events", "data", "node",
                 "worker", "job", "first_ts", "last_ts", "terminal")

    def __init__(self, task_id: bytes, attempt: int):
        self.task_id = task_id
        self.attempt = attempt
        self.name = None
        # [(state, ts, node_hex|None, worker_hex|None, data|None)]
        self.events: list = []
        self.data: dict = {}       # merged small facts (lease_seq, ...)
        self.node: str | None = None     # last executing node (hex)
        self.worker: str | None = None   # last executing worker (hex)
        self.job = "driver"
        self.first_ts = float("inf")
        self.last_ts = 0.0
        self.terminal = False  # saw FINISHED/FAILED (eviction fast path)

    def expanded(self) -> list:
        """Events with packed EXEC_SPANS records unfolded into the four
        exec sub-states (expansion is deferred to query time so the
        storm-rate ingest path stays one append per task)."""
        if not any(ev[0] == "EXEC_SPANS" for ev in self.events):
            return self.events
        out = []
        for ev in self.events:
            if ev[0] != "EXEC_SPANS":
                out.append(ev)
                continue
            stamps = list(ev[4][:3]) if ev[4] else [0.0, 0.0, 0.0]
            for st2, ts2 in zip(EXEC_STATES, stamps + [ev[1]]):
                if ts2:
                    out.append((st2, ts2, ev[2], ev[3], None))
        return out

    def state(self) -> str:
        """Current state: terminal wins, else the latest event."""
        latest, latest_ts = "UNKNOWN", -1.0
        for st, ts, _n, _w, _d in self.events:
            if st in TERMINAL_STATES:
                return st
            if st == "EXEC_SPANS":
                st = "OUTPUTS_SEALED"
            if st != "SPAN" and ts >= latest_ts:
                latest, latest_ts = st, ts
        return latest

    def ts_of(self, state: str):
        """First timestamp of `state` in this attempt, or None."""
        best = None
        for st, ts, _n, _w, _d in self.expanded():
            if st == state and (best is None or ts < best):
                best = ts
        return best

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id.hex(),
            "attempt": self.attempt,
            "name": format_name(self.name),
            "state": self.state(),
            "job": self.job,
            "node": self.node,
            "worker": self.worker,
            "lease_seq": self.data.get("lease_seq"),
            "spill_hops": self.data.get("spill_hops"),
            "events": [
                {"state": st, "ts": ts, "node": n, "worker": w,
                 **({"data": d} if d else {})}
                for st, ts, n, w, d in sorted(self.expanded(),
                                              key=lambda e: e[1])],
        }


class TaskEventStorage:
    """Bounded head-side merge of the cluster's task events.

    Parity: `GcsTaskManagerStorage` (gcs_task_manager.h:94) — bounded
    per-attempt storage with job-aware eviction and drop accounting.
    Eviction prefers settled attempts of the job holding the most
    attempts (so one chatty job cannot evict everyone else's history),
    and every eviction/overflow is counted, never silent."""

    def __init__(self, max_tasks: int = 10000, max_spans: int = 10000,
                 export=None, max_per_job: int = 0):
        self.max_tasks = max(1, int(max_tasks))
        # Per-job retention ceiling (0 = off): one storming tenant's
        # history caps out on its own attempts instead of waiting for
        # the global bound to start job-aware eviction.
        self.max_per_job = max(0, int(max_per_job))
        self.lock = threading.Lock()
        self.attempts: "collections.OrderedDict[tuple, TaskAttempt]" = (
            collections.OrderedDict())
        # Resource spans (channel writes/reads, objxfer pulls):
        # (node_hex, worker_hex|None, label, ts, dur, data)
        self.spans: collections.deque = collections.deque(maxlen=max_spans)
        self.dropped_at_sources = 0   # ring drops reported by emitters
        self.dropped_at_head = 0      # attempts evicted from this store
        self.dropped_per_job: dict[str, int] = {}
        self._job_counts: dict[str, int] = {}  # live attempts per job
        self.finished_total = 0
        self.failed_total = 0
        self._export = export  # ExportEventWriter | None

    # -- ingest --

    def ingest(self, events: list, node: bytes | str | None = None,
               worker: bytes | None = None, dropped: int = 0):
        """Merge one shipped batch. `node`/`worker` identify the emitting
        process (None = the head/driver process itself)."""
        node_hex = (node.hex() if isinstance(node, bytes)
                    else node) if node else "head"
        worker_hex = worker.hex() if isinstance(worker, bytes) else worker
        evict = []
        with self.lock:
            if dropped:
                self.dropped_at_sources += int(dropped)
            for task_id, attempt, state, ts, name, data in events:
                if state == "SPAN":
                    self.spans.append(
                        (node_hex, worker_hex, name, ts, data or {}))
                    continue
                key = (task_id, attempt)
                at = self.attempts.get(key)
                if at is None:
                    at = TaskAttempt(task_id, attempt)
                    self.attempts[key] = at
                    self._job_counts[at.job] = (
                        self._job_counts.get(at.job, 0) + 1)
                    if (self.max_per_job
                            and self._job_counts[at.job]
                            > self.max_per_job):
                        self._evict_job_locked(at.job, skip=key)
                if name is not None and at.name is None:
                    at.name = name
                if state == "EXEC_SPANS":
                    # Packed exec record: (exec_start, args_ready,
                    # exec_done[, worker_hex, node_hex]) in `data`, seal
                    # time as the event ts (the hex tail rides records
                    # the HEAD unpacked from done frames — its own ring
                    # is the batch source then, not the executor).
                    # Stored AS-IS; queries expand via
                    # `TaskAttempt.expanded()`, so the storm-rate ingest
                    # path stays one append per task.
                    if data and len(data) > 3:
                        worker_hex = data[3] or worker_hex
                        node_hex = data[4] or node_hex
                    at.events.append((state, ts, node_hex, worker_hex,
                                      data or None))
                    at.first_ts = min(at.first_ts,
                                      data[0] if data and data[0] else ts)
                    at.last_ts = max(at.last_ts, ts)
                    at.node = node_hex
                    if worker_hex:
                        at.worker = worker_hex
                    if self._export is not None:
                        self._export.emit(
                            "TASK_LIFECYCLE", task_id=task_id.hex(),
                            attempt=attempt, name=format_name(at.name),
                            state="EXEC_START",
                            lease_seq=at.data.get("lease_seq"),
                            node=at.node, worker=at.worker)
                    continue
                at.events.append((state, ts, node_hex, worker_hex,
                                  data or None))
                at.first_ts = min(at.first_ts, ts)
                at.last_ts = max(at.last_ts, ts)
                if data:
                    if "job" in data and data["job"] != at.job:
                        self._job_counts[at.job] -= 1
                        at.job = data["job"]
                        self._job_counts[at.job] = (
                            self._job_counts.get(at.job, 0) + 1)
                        # The insertion-time cap check ran against the
                        # default job; the real tenant only lands here
                        # (SUBMITTED carries it in data), so re-check.
                        if (self.max_per_job
                                and self._job_counts[at.job]
                                > self.max_per_job):
                            self._evict_job_locked(at.job, skip=key)
                    for k in ("lease_seq", "spill_hops"):
                        if k in data:
                            at.data[k] = data[k]
                if state in EXEC_STATES:
                    at.node = node_hex
                    if worker_hex:
                        at.worker = worker_hex
                elif state in ("LEASE_GRANTED", "DISPATCHED") and data:
                    at.node = data.get("node", at.node)
                    at.worker = data.get("worker", at.worker)
                if state == "FINISHED":
                    self.finished_total += 1
                    at.terminal = True
                elif state == "FAILED":
                    self.failed_total += 1
                    at.terminal = True
                if self._export is not None and state in (
                        "EXEC_START", "FINISHED", "FAILED"):
                    self._export.emit(
                        "TASK_LIFECYCLE", task_id=task_id.hex(),
                        attempt=attempt, name=format_name(at.name),
                        state=state, lease_seq=at.data.get("lease_seq"),
                        node=at.node, worker=at.worker)
            while len(self.attempts) > self.max_tasks:
                evict.append(self._evict_one_locked())
        del evict  # nothing asynchronous to do with them today

    def _evict_job_locked(self, job: str, skip=None):
        """Per-job cap eviction: drop this job's oldest attempt
        (preferring a settled one within a bounded scan window; the
        window keeps the storm-rate ingest path from going O(n) —
        nothing else about the global bound changes). `skip` protects
        the attempt that just triggered the cap."""
        import itertools
        victim_key = fallback = None
        for key, cand in itertools.islice(self.attempts.items(), 256):
            if cand.job != job or key == skip:
                continue
            if fallback is None:
                fallback = key
            if cand.terminal:
                victim_key = key
                break
        victim_key = victim_key or fallback
        if victim_key is None:
            return  # this job's attempts are all beyond the scan window
        at = self.attempts.pop(victim_key)
        self._job_counts[at.job] -= 1
        if not self._job_counts[at.job]:
            del self._job_counts[at.job]
        self.dropped_at_head += 1
        self.dropped_per_job[at.job] = (
            self.dropped_per_job.get(at.job, 0) + 1)

    def _evict_one_locked(self):
        """Drop one attempt: a settled attempt of the job holding the
        most attempts if any, else the oldest attempt outright. Job
        counts are maintained incrementally and the oldest-first scan is
        bounded — under storm load (the common eviction regime) the
        oldest attempt is settled and the scan stops at the first entry,
        keeping eviction amortized O(1) per ingested event (an O(n)
        recount here turned the head listener quadratic and collapsed a
        10k-task storm to ~200 tasks/s)."""
        if len(self._job_counts) <= 1:
            # One job: per-job preference is moot — pure oldest-first,
            # O(1). This is the storm regime, where eviction runs per
            # ingested attempt and any scan work multiplies.
            _key, at = self.attempts.popitem(last=False)
        else:
            import itertools
            big_job = max(self._job_counts, key=self._job_counts.get)
            victim_key = None
            for key, cand in itertools.islice(self.attempts.items(), 64):
                if cand.job == big_job and cand.terminal:
                    victim_key = key  # oldest settled of the big job
                    break
            if victim_key is None:
                victim_key = next(iter(self.attempts))
            at = self.attempts.pop(victim_key)
        self._job_counts[at.job] -= 1
        if not self._job_counts[at.job]:
            del self._job_counts[at.job]
        self.dropped_at_head += 1
        self.dropped_per_job[at.job] = (
            self.dropped_per_job.get(at.job, 0) + 1)
        return at

    # -- queries --

    def list_events(self, limit: int = 1000) -> list[dict]:
        with self.lock:
            ats = list(self.attempts.values())[-int(limit):]
        return [at.to_dict() for at in ats]

    def summary(self) -> dict:
        """Per-function rollup (the `ray summary tasks` shape): counts,
        state breakdown, and mean stage latencies."""
        with self.lock:
            ats = list(self.attempts.values())
            dropped = {"at_sources": self.dropped_at_sources,
                       "at_head": self.dropped_at_head,
                       "per_job": dict(self.dropped_per_job)}
        out: dict[str, dict] = {}
        for at in ats:
            row = out.setdefault(format_name(at.name), {
                "count": 0, "by_state": {},
                "_queue": [], "_exec": [], "_total": []})
            row["count"] += 1
            st = at.state()
            row["by_state"][st] = row["by_state"].get(st, 0) + 1
            sub = at.ts_of("SUBMITTED")
            start = (at.ts_of("LEASE_GRANTED") or at.ts_of("DISPATCHED")
                     or at.ts_of("EXEC_START"))
            es, ed = at.ts_of("EXEC_START"), at.ts_of("EXEC_DONE")
            if sub is not None and start is not None and start >= sub:
                row["_queue"].append(start - sub)
            if es is not None and ed is not None and ed >= es:
                row["_exec"].append(ed - es)
            if sub is not None and st in TERMINAL_STATES:
                row["_total"].append(max(0.0, at.last_ts - sub))
        for row in out.values():
            for key, label in (("_queue", "mean_queue_ms"),
                               ("_exec", "mean_exec_ms"),
                               ("_total", "mean_total_ms")):
                vals = row.pop(key)
                row[label] = (round(1e3 * sum(vals) / len(vals), 3)
                              if vals else None)
        return {"tasks": out, "dropped": dropped,
                "finished_total": self.finished_total,
                "failed_total": self.failed_total}

    def stage_durations(self, max_attempts: int = 4096) -> dict:
        """Per-stage latencies of the most recent attempts, derived at
        call (scrape) time — nothing is aggregated on the hot path."""
        with self.lock:
            ats = list(self.attempts.values())[-max_attempts:]
        out = {"queue_wait": [], "spill_transit": [], "exec": [],
               "seal": []}
        for at in ats:
            sub = at.ts_of("SUBMITTED")
            start = (at.ts_of("LEASE_GRANTED") or at.ts_of("DISPATCHED")
                     or at.ts_of("EXEC_START"))
            if sub is not None and start is not None and start >= sub:
                out["queue_wait"].append(start - sub)
            es, ed = at.ts_of("EXEC_START"), at.ts_of("EXEC_DONE")
            if es is not None and ed is not None and ed >= es:
                out["exec"].append(ed - es)
            sealed = at.ts_of("OUTPUTS_SEALED")
            if ed is not None and sealed is not None and sealed >= ed:
                out["seal"].append(sealed - ed)
            for t0, t1 in self._spill_pairs(at):
                if t1 >= t0:
                    out["spill_transit"].append(t1 - t0)
        return out

    @staticmethod
    def _spill_pairs(at: TaskAttempt) -> list[tuple]:
        """Match SPILL_SENT -> SPILL_RECEIVED per hop number."""
        sent, recv = {}, {}
        for st, ts, _n, _w, d in at.events:
            if st not in ("SPILL_SENT", "SPILL_RECEIVED"):
                continue  # EXEC_SPANS data is a tuple, not a dict
            hop = (d or {}).get("hop", 0)
            if st == "SPILL_SENT":
                sent.setdefault(hop, ts)
            else:
                recv.setdefault(hop, ts)
        return [(sent[h], recv[h]) for h in sent if h in recv]

    def rate_buckets(self, window_s: float = 300.0,
                     bucket_s: float = 5.0) -> list[dict]:
        """Tasks-over-time view: per-bucket submitted/finished/failed
        counts for the trailing window (the dashboard chart's data)."""
        now = time.time()
        t0 = now - window_s
        n = max(1, int(window_s / bucket_s))
        buckets = [{"ts": round(t0 + i * bucket_s, 1), "SUBMITTED": 0,
                    "FINISHED": 0, "FAILED": 0} for i in range(n)]
        with self.lock:
            ats = list(self.attempts.values())
        for at in ats:
            if at.last_ts < t0:
                continue
            for st, ts, _n, _w, _d in at.events:
                if st not in ("SUBMITTED", "FINISHED", "FAILED"):
                    continue
                i = int((ts - t0) / bucket_s)
                if 0 <= i < n:
                    buckets[i][st] += 1
        return buckets

    # -- Chrome/Perfetto trace export --

    def chrome_trace(self) -> list[dict]:
        """Trace events (JSON-safe dicts only, so a json round trip is
        identity). Rows: one per worker (B/E phase pairs — workers
        execute serially, so the pairs nest), one per node's lease plane
        and one scheduler row (X slices — these overlap freely), with
        lease-spill hops drawn as flow arrows between node rows."""
        with self.lock:
            ats = sorted(self.attempts.values(), key=lambda a: a.first_ts)
            spans = list(self.spans)
        trace: list[dict] = []
        us = 1e6

        def x(name, pid, tid, t0, t1, args=None, cat="task"):
            trace.append({"name": name, "cat": cat, "ph": "X",
                          "ts": t0 * us, "dur": max(0.0, (t1 - t0) * us),
                          "pid": pid, "tid": tid,
                          **({"args": args} if args else {})})

        for at in ats:
            name = format_name(at.name)
            ident = f"{at.task_id.hex()[:8]}#{at.attempt}"
            args = {"task_id": at.task_id.hex(), "attempt": at.attempt,
                    "lease_seq": at.data.get("lease_seq"),
                    "state": at.state(), "job": at.job}
            sub = at.ts_of("SUBMITTED")
            if sub is not None:
                x(f"task:{name}", "head", "scheduler", sub, at.last_ts,
                  args)
            lg = at.ts_of("LEASE_GRANTED")
            if lg is not None:
                lease_node = at.data.get("node") or at.node or "?"
                for st, ts, n, _w, d in at.events:
                    if st == "LEASE_GRANTED" and d and d.get("node"):
                        lease_node = d["node"]
                        break
                end = (at.ts_of("NODE_DISPATCHED")
                       or at.ts_of("EXEC_START") or at.last_ts)
                x(f"lease:{name}", f"node:{lease_node}", "leases", lg,
                  end, args, cat="lease")
            # Spill hops: a slice on the origin row + a flow arrow into
            # the receiving node's row.
            sent = [(ts, n, d or {}) for st, ts, n, _w, d in at.events
                    if st == "SPILL_SENT"]
            recv = {(d or {}).get("hop", 0): (ts, n)
                    for st, ts, n, _w, d in at.events
                    if st == "SPILL_RECEIVED"}
            for ts, n, d in sent:
                hop = d.get("hop", 0)
                rts, rn = recv.get(hop, (ts, d.get("to", "?")))
                flow_id = f"{ident}:h{hop}"
                x(f"spill_hop:{name}", f"node:{n}", "spill", ts,
                  max(rts, ts), {"hop": hop, "to": rn, **args},
                  cat="spill")
                trace.append({"name": f"spill:{name}", "cat": "spill",
                              "ph": "s", "id": flow_id, "ts": ts * us,
                              "pid": f"node:{n}", "tid": "spill"})
                trace.append({"name": f"spill:{name}", "cat": "spill",
                              "ph": "f", "bp": "e", "id": flow_id,
                              "ts": max(rts, ts) * us,
                              "pid": f"node:{rn}", "tid": "spill"})
            # Worker execution: B/E pairs with the three sub-spans.
            es = at.ts_of("EXEC_START")
            if es is not None:
                pid = f"node:{at.node or 'head'}"
                tid = f"worker:{at.worker or '?'}"
                ar = at.ts_of("ARGS_READY")
                ed = at.ts_of("EXEC_DONE")
                sealed = at.ts_of("OUTPUTS_SEALED")
                end = sealed or ed or ar or es
                trace.append({"name": f"exec:{name}", "cat": "exec",
                              "ph": "B", "ts": es * us, "pid": pid,
                              "tid": tid, "args": args})
                for label, t0, t1 in (("deserialize_args", es, ar),
                                      ("execute", ar, ed),
                                      ("store_outputs", ed, sealed)):
                    if t0 is None or t1 is None:
                        continue
                    trace.append({"name": label, "cat": "exec",
                                  "ph": "B", "ts": t0 * us, "pid": pid,
                                  "tid": tid})
                    trace.append({"name": label, "cat": "exec",
                                  "ph": "E", "ts": max(t0, t1) * us,
                                  "pid": pid, "tid": tid})
                trace.append({"name": f"exec:{name}", "cat": "exec",
                              "ph": "E", "ts": max(es, end) * us,
                              "pid": pid, "tid": tid})
        for node_hex, worker_hex, label, ts, data in spans:
            kind = data.get("kind", "span")
            tid = (f"worker:{worker_hex}" if worker_hex
                   else {"obj_pull": "objxfer"}.get(kind, "channels"))
            x(f"{kind}:{label}", f"node:{node_hex}", tid, ts,
              ts + float(data.get("dur", 0.0)),
              {k: v for k, v in data.items() if k != "dur"}, cat=kind)
        return trace
