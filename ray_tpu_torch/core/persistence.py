"""Head state persistence: a pluggable store behind the control plane.

Parity: reference GCS storage tier — `gcs/store_client/store_client.h`
(pluggable), `redis_store_client.h:111` (durable backend), reload via
`gcs_server/gcs_init_data.h`. Here the durable backend is an append-only
pickle journal on the filesystem (one record per mutation, replayed on
restart); the in-memory backend is a no-op for heads that opt out.

Tables journaled by the head (see runtime.py):
  kv     — internal KV (includes job table entries)
  fn     — exported function/class blobs (needed to re-dispatch)
  actor  — actor creation specs keyed by actor id
  named  — actor name -> actor id
  pg     — placement group specs
  task   — queued/in-flight normal task specs (removed on completion)

Restart flow: a new head with the same persistence dir replays the journal,
restores KV/functions/PGs, re-queues pending tasks, and marks persisted
actors RESTARTING; node agents reconnect (agent-side grace loop) and
re-register with a worker inventory, which ADOPTS still-running actor
workers back into ALIVE without restarting them.
"""

from __future__ import annotations

import os
import pickle
import threading


class NullStore:
    """Persistence disabled (the default)."""

    def append(self, table: str, key: bytes, value) -> None:
        pass

    def delete(self, table: str, key: bytes) -> None:
        pass

    def load(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class SqliteStore:
    """Transactional persistence tier (parity: the reference's
    RedisStoreClient role, `redis_store_client.h:111` — a durable store a
    RESTARTED-ELSEWHERE head can reload, minus the network server: SQLite
    on shared storage gives the same restart-anywhere capability with
    zero extra processes). Selected by a path ending in `.db`/`.sqlite`
    or a `sqlite://` prefix.

    Unlike the journal, writes are transactional upserts — no torn-tail
    handling, no compaction; `load()` is a table scan."""

    def __init__(self, path: str):
        import sqlite3
        if path.startswith("sqlite://"):
            path = path[len("sqlite://"):]
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " tbl TEXT NOT NULL, key BLOB NOT NULL, value BLOB,"
            " PRIMARY KEY (tbl, key))")
        # WAL + synchronous=NORMAL: no fsync per commit — durability
        # target is head-process death, not power loss (the journal's
        # documented posture); FULL would put a disk flush on every task
        # submission.
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.commit()

    def append(self, table: str, key: bytes, value) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (tbl, key, value) VALUES (?, ?, ?) "
                "ON CONFLICT(tbl, key) DO UPDATE SET value=excluded.value",
                (table, key, pickle.dumps(value,
                                          protocol=pickle.HIGHEST_PROTOCOL)))
            self._db.commit()

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE tbl=? AND key=?",
                             (table, key))
            self._db.commit()

    def load(self) -> dict:
        tables: dict[str, dict] = {}
        with self._lock:
            for tbl, key, value in self._db.execute(
                    "SELECT tbl, key, value FROM kv"):
                try:
                    tables.setdefault(tbl, {})[key] = pickle.loads(value)
                except Exception:  # noqa: BLE001 — skip corrupt record
                    continue
        return tables

    def close(self) -> None:
        with self._lock:
            try:
                self._db.close()
            except Exception:  # noqa: BLE001
                pass


def make_store(path: str | None):
    """Persistence backend for `path`: None -> NullStore; sqlite for
    `.db`/`.sqlite`/`sqlite://` paths; the append-only journal otherwise
    (parity: the reference's pluggable StoreClient,
    `store_client/store_client.h`)."""
    if not path:
        return NullStore()
    if (path.startswith("sqlite://") or path.endswith(".db")
            or path.endswith(".sqlite")):
        raw = path[len("sqlite://"):] if path.startswith("sqlite://") \
            else path
        try:  # a pre-existing JOURNAL at a .db path keeps its format —
            with open(raw, "rb") as f:  # never corrupt prior state
                if not f.read(16).startswith(b"SQLite format 3"):
                    return FileStore(raw)
        except FileNotFoundError:
            pass
        return SqliteStore(path)
    return FileStore(path)


class FileStore:
    """Append-only journal of (table, key, value|None) pickle records.

    Writes are buffered by the OS (no fsync per record — the durability
    target is head-process death, not power loss, matching the reference's
    default Redis persistence posture). `load()` replays in order; a later
    record for the same (table, key) wins; value None is a tombstone.
    Replaying also compacts: the journal is rewritten with only live
    records so restart cost stays bounded across generations.
    """

    # In-place compaction triggers once this many bytes accumulate since
    # the last compaction — keeps a long-lived head's journal bounded by
    # its live state, not its mutation history.
    COMPACT_THRESHOLD = 64 << 20

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._since_compact = 0
        self._compacting = False
        self._f = open(path, "ab")  # noqa: SIM115 — lifetime = head lifetime

    def append(self, table: str, key: bytes, value) -> None:
        rec = pickle.dumps((table, key, value),
                           protocol=pickle.HIGHEST_PROTOCOL)
        compact = False
        with self._lock:
            self._f.write(len(rec).to_bytes(8, "little") + rec)
            self._f.flush()
            self._since_compact += len(rec) + 8
            if (self._since_compact >= self.COMPACT_THRESHOLD
                    and not self._compacting):
                self._since_compact = 0
                self._compacting = True
                compact = True
        if compact:
            # Off the caller's (control-plane) thread; appenders only stall
            # on the store lock for the rewrite itself.
            threading.Thread(target=self._compact_locked,
                             daemon=True).start()

    def _compact_locked(self):
        try:
            with self._lock:
                tables = self._replay_locked()
                self._rewrite_locked(tables)
        finally:
            self._compacting = False

    def delete(self, table: str, key: bytes) -> None:
        self.append(table, key, None)

    def load(self) -> dict:
        """Replay -> {table: {key: value}}, then compact the journal.
        (Boot-time path; concurrent appends are excluded by the lock.)"""
        with self._lock:
            tables = self._replay_locked()
            self._rewrite_locked(tables)
        return tables

    def _replay_locked(self) -> dict:
        tables: dict[str, dict] = {}
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return tables
        off = 0
        while off + 8 <= len(data):
            n = int.from_bytes(data[off:off + 8], "little")
            off += 8
            if off + n > len(data):
                break  # torn tail record (head died mid-write): drop it
            try:
                table, key, value = pickle.loads(data[off:off + n])
            except Exception:  # noqa: BLE001 — skip corrupt record
                off += n
                continue
            off += n
            t = tables.setdefault(table, {})
            if value is None:
                t.pop(key, None)
            else:
                t[key] = value
        return tables

    def _rewrite_locked(self, tables: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for table, entries in tables.items():
                for key, value in entries.items():
                    rec = pickle.dumps(
                        (table, key, value),
                        protocol=pickle.HIGHEST_PROTOCOL)
                    f.write(len(rec).to_bytes(8, "little") + rec)
        os.replace(tmp, self.path)
        self._f.close()
        self._f = open(self.path, "ab")  # noqa: SIM115

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass
