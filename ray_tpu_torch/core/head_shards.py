"""Head shards: horizontal scale-out of the control plane's
embarrassingly-shardable state.

Parity: the reference GCS's service split (PAPER.md L4 — ~39k LoC, 10
gRPC services over a pluggable `store_client`) and the Ownership paper's
observation (NSDI'21) that object metadata and event ingest shard
cleanly by id space while lease POLICY does not. Here the head proper
keeps lease policy and stays the object-directory authority for the
fast path; N shard subprocesses own disjoint id-space slices of

  * the durable object-directory mirror (oid -> node locations, WAL'd
    per shard so a head restart re-seeds its directory from shard
    snapshots before any agent has reconnected), and
  * task-event ingest (agents ship their `task_events` rings straight
    to the owning shard — the head's per-event merge cost leaves the
    storm's critical path; the head drains lazily on query).

Id space is carved into `N_BUCKETS` fixed buckets (first id byte);
`buckets[i]` names the owning shard, so re-slicing after a shard death
is one list rewrite, epoch-stamped.  The shard map rides the existing
cluster-view broadcast as a reserved pseudo-entry (`SHARD_MAP_KEY`),
so distribution, delta encoding and the cursor-reset full catch-up are
inherited rather than re-built.

Failure story: every shard journals its directory slice through
`core/persistence.py` (same WAL tier as the head tables). A shard
SIGKILL is detected by the manager's health pass, its buckets re-slice
onto survivors (epoch+1, no double-ownership: shards reject stale
epochs), the process respawns with the same WAL path, replays, and
takes its buckets back (epoch+2). The head's in-memory directory stays
the resolution authority throughout, so lookups never block on a dead
shard.

Wire frames (pickle framing over core/transport, documented in
raytpu.proto and pinned in tools/staticcheck/wire_drift.py):

  ("shard_hello", shard_id)                      -> ("shard_ready", ...)
  ("shard_assign", epoch, buckets)               epoch-gated ownership
  ("dir_add", [(oid, nid), ...])                 WAL commit, then merge
  ("dir_drop", [oid, ...])                       tombstone entries
  ("tev_ingest", node_id, batch, dropped)        task-event slice ingest
  ("tev_drain", req_id) -> ("tev_batch", req_id, batches)
  ("shard_snapshot", req_id)
      -> ("shard_state", req_id, epoch, {oid: [nid]}, tev_pending)
"""

from __future__ import annotations

import collections
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.transport import (
    dial,
    enable_nodelay,
    free_tcp_port,
    recv_msg,
    send_msg,
)

# Fixed bucket count: the re-slice unit. 64 buckets over <=8 shards keeps
# every re-slice near-balanced without consistent-hashing machinery.
N_BUCKETS = 64

# Reserved cluster-view key the shard map rides under. Agents treat it as
# the shard map, never as a node: every existing view consumer already
# filters on state == "ALIVE" / a ctrl address, which this entry lacks.
SHARD_MAP_KEY = b"\x00smap"


def bucket_of(id_bytes: bytes) -> int:
    """Owning bucket of a task/object id (first byte; ids are urandom)."""
    return (id_bytes[0] if id_bytes else 0) % N_BUCKETS


class ShardState:
    """The shard process's protocol core, separated from its sockets so
    the racecheck interleaving explorer can bind these exact methods.

    Invariants (machine-checked by the `shard_reslice` model):
      * a dir entry is COMMITTED once its WAL append returned — it must
        survive kill + `replay_wal` (append-before-merge ordering);
      * ownership is epoch-gated: `apply_assign` with a stale epoch is a
        no-op, so a re-slice racing a late assign can never leave one
        bucket owned under two epochs at once.
    """

    def __init__(self, shard_id: int, store):
        self.shard_id = shard_id
        self.lock = threading.Lock()
        self.epoch = -1
        self.buckets: frozenset[int] = frozenset()
        self.dir: dict[bytes, set] = {}  # oid -> {node_id}
        self.tev: collections.deque = collections.deque(maxlen=4096)
        self.tev_dropped = 0
        self._store = store  # persistence store (the shard's WAL)

    def apply_assign(self, epoch: int, buckets) -> bool:
        """Adopt a bucket assignment; stale epochs are rejected."""
        with self.lock:
            if epoch <= self.epoch:
                return False
            self.epoch = epoch
            self.buckets = frozenset(buckets)
            return True

    def dir_merge(self, pairs) -> int:
        """Merge (oid, node_id) locations. WAL append FIRST: once the
        append returns the entry is committed and must survive SIGKILL;
        merging first would ack state the journal can still lose."""
        n = 0
        for oid, nid in pairs:
            with self.lock:
                locs = self.dir.get(oid)
                new = set(locs) if locs else set()
                new.add(nid)
                self._store.append("dir", oid, sorted(new))
                self.dir[oid] = new
                n += 1
        return n

    def dir_drop(self, oids) -> None:
        for oid in oids:
            with self.lock:
                if self.dir.pop(oid, None) is not None:
                    self._store.delete("dir", oid)

    def dir_snapshot(self) -> dict:
        with self.lock:
            return {oid: sorted(locs) for oid, locs in self.dir.items()}

    def tev_ingest(self, node_id, batch, dropped: int) -> None:
        with self.lock:
            if len(self.tev) == self.tev.maxlen:
                self.tev_dropped += 1
            self.tev.append((node_id, batch, dropped))

    def tev_drain(self) -> list:
        with self.lock:
            out = list(self.tev)
            self.tev.clear()
            return out

    def replay_wal(self) -> int:
        """Reload the directory slice from the WAL (boot / respawn)."""
        tables = self._store.load()
        with self.lock:
            for oid, locs in tables.get("dir", {}).items():
                self.dir[oid] = set(locs)
            return len(self.dir)


class ShardServer:
    """Socket shell around ShardState: one accept loop, one serve thread
    per connection (head manager + every agent that ships tev frames)."""

    def __init__(self, shard_id: int, port: int, wal_path: str | None):
        from ray_tpu_torch.core.persistence import make_store
        self.state = ShardState(shard_id, make_store(wal_path))
        self.state.replay_wal()
        self._shutdown = False
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", port))
        self.srv.listen(128)
        self.port = self.srv.getsockname()[1]

    def serve_forever(self):
        threads = []
        try:
            while not self._shutdown:
                try:
                    sock, _addr = self.srv.accept()
                except OSError:
                    break
                enable_nodelay(sock)
                t = threading.Thread(target=self._serve_conn, args=(sock,),
                                     daemon=True, name="rtpu-shard-conn")
                t.start()
                threads.append(t)
        finally:
            try:
                self.srv.close()
            except OSError:
                pass

    def _serve_conn(self, sock: socket.socket):
        st = self.state
        lock = threading.Lock()
        try:
            while not self._shutdown:
                try:
                    msg = recv_msg(sock)
                except (OSError, EOFError):
                    return
                if msg is None:
                    return
                op = msg[0]
                if op == "dir_add":
                    # Crash-consistency probe: the kill seam sits between
                    # arrival and WAL commit — an entry that died here was
                    # never acked committed, one that survived replays.
                    chaos.kill("shard.kill")
                    st.dir_merge(msg[1])
                elif op == "tev_ingest":
                    chaos.kill("shard.kill")
                    st.tev_ingest(msg[1], msg[2], msg[3])
                elif op == "dir_drop":
                    st.dir_drop(msg[1])
                elif op == "shard_assign":
                    st.apply_assign(msg[1], msg[2])
                elif op == "tev_drain":
                    send_msg(sock, ("tev_batch", msg[1], st.tev_drain()),
                             lock)
                elif op == "shard_snapshot":
                    send_msg(sock, ("shard_state", msg[1], st.epoch,
                                    st.dir_snapshot(), len(st.tev)), lock)
                elif op == "shard_hello":
                    send_msg(sock, ("shard_ready", st.shard_id,
                                    len(st.dir), len(st.tev)), lock)
                elif op == "shard_shutdown":
                    self._shutdown = True
                    try:
                        self.srv.close()
                    except OSError:
                        pass
                    return
        finally:
            try:
                sock.close()
            except OSError:
                pass


def _watch_parent_loop(ppid: int):
    while True:
        try:
            os.kill(ppid, 0)
        except OSError:
            os._exit(0)  # head died: no orphaned shard processes
        time.sleep(1.0)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="ray_tpu_torch.core.head_shards")
    p.add_argument("--shard-id", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--wal", default="")
    p.add_argument("--watch-parent", type=int, default=0)
    args = p.parse_args(argv)
    from ray_tpu_torch.core.config import get_config
    chaos.configure_from(get_config())
    if args.watch_parent:
        threading.Thread(target=_watch_parent_loop,
                         args=(args.watch_parent,), daemon=True,
                         name="rtpu-shard-watch").start()
    srv = ShardServer(args.shard_id, args.port, args.wal or None)
    print(f"SHARD_READY {srv.port}", flush=True)
    srv.serve_forever()


class _ShardLink:
    """Manager-side channel to one shard process."""

    __slots__ = ("shard_id", "port", "proc", "sock", "send_lock",
                 "wal")

    def __init__(self, shard_id: int, port: int, proc, wal: str | None):
        self.shard_id = shard_id
        self.port = port
        self.proc = proc
        self.sock: socket.socket | None = None
        self.send_lock = threading.Lock()
        self.wal = wal

    def connect(self, timeout: float = 20.0):
        deadline = time.monotonic() + timeout
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                self.sock = dial(("127.0.0.1", self.port), timeout=2.0)
                send_msg(self.sock, ("shard_hello", self.shard_id),
                         self.send_lock)
                msg = recv_msg(self.sock)
                if msg and msg[0] == "shard_ready":
                    return msg
            except OSError as e:
                last = e
                time.sleep(0.1)
        raise OSError(f"shard {self.shard_id} never came up: {last}")

    def send(self, msg):
        if self.sock is None:
            raise OSError("shard link closed")
        send_msg(self.sock, msg, self.send_lock)

    def request(self, msg):
        """Synchronous round trip. The link is single-reader (the
        manager), so holding the send lock across send+recv IS the
        protocol: it serializes whole round trips on the channel."""
        if self.sock is None:
            raise OSError("shard link closed")
        with self.send_lock:
            send_msg(self.sock, msg)
            return recv_msg(self.sock)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class ShardManager:
    """Head-side owner of the shard fleet: spawn, assignment epochs,
    health/re-slice, the async dir mirror, and lazy tev drains."""

    def __init__(self, n_shards: int, wal_base: str | None,
                 chaos_env: dict | None = None):
        self.n_shards = max(1, int(n_shards))
        self.wal_base = wal_base
        self.lock = threading.Lock()
        self.epoch = 0
        self.links: dict[int, _ShardLink] = {}
        # buckets[i] -> shard id owning bucket i (exactly one owner).
        self.buckets: list[int] = [i % self.n_shards
                                   for i in range(N_BUCKETS)]
        self._env = {**os.environ, **(chaos_env or {})}
        self._dirq: collections.deque = collections.deque()
        self._dirq_cv = threading.Condition()
        self._shutdown = False
        for sid in range(self.n_shards):
            self._spawn_locked(sid)
        self.epoch = 1
        self._assign_all_locked()
        threading.Thread(target=self._dir_flush_loop, daemon=True,
                         name="rtpu-shard-dirflush").start()

    # -------- spawn / assignment --------

    def _wal_path(self, sid: int) -> str | None:
        return f"{self.wal_base}.shard{sid}" if self.wal_base else None

    def _spawn_locked(self, sid: int):
        port = free_tcp_port()
        wal = self._wal_path(sid)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.head_shards",
             "--shard-id", str(sid), "--port", str(port),
             "--wal", wal or "",
             "--watch-parent", str(os.getpid())],
            env=self._env, start_new_session=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        link = _ShardLink(sid, port, proc, wal)
        link.connect()
        self.links[sid] = link

    def _assign_all_locked(self):
        owned: dict[int, list] = {sid: [] for sid in self.links}
        for b, sid in enumerate(self.buckets):
            owned.setdefault(sid, []).append(b)
        for sid, link in self.links.items():
            try:
                link.send(("shard_assign", self.epoch, owned.get(sid, [])))
            except OSError:
                pass  # health pass owns dead-shard handling

    def _reslice_locked(self, dead_sid: int) -> list:
        """Rehome the dead shard's buckets onto survivors, round-robin.
        Pure assignment math (no I/O, no state writes — the caller
        commits the returned list to self.buckets under self.lock) so
        the racecheck model can bind it: post-state must keep EXACTLY
        ONE owner per bucket."""
        survivors = sorted(sid for sid in self.links if sid != dead_sid)
        out = list(self.buckets)
        if not survivors:
            return out
        it = 0
        for b, sid in enumerate(out):
            if sid == dead_sid:
                out[b] = survivors[it % len(survivors)]
                it += 1
        return out

    # -------- the map the cluster view carries --------

    def shard_map(self) -> dict:
        with self.lock:
            return {
                "epoch": self.epoch,
                "shards": tuple((sid, "127.0.0.1", link.port)
                                for sid, link in sorted(self.links.items())),
                "buckets": tuple(self.buckets),
            }

    def owner_of(self, id_bytes: bytes) -> int:
        with self.lock:
            return self.buckets[bucket_of(id_bytes)]

    # -------- async dir mirror --------

    def dir_add(self, oid: bytes, nid: bytes):
        """Queue one location for the background mirror flush — callers
        sit on the head's completion hot path and must not block on a
        shard socket."""
        with self._dirq_cv:
            self._dirq.append(("add", oid, nid))
            self._dirq_cv.notify()

    def dir_discard(self, oid: bytes):
        with self._dirq_cv:
            self._dirq.append(("drop", oid, None))
            self._dirq_cv.notify()

    def _dir_flush_loop(self):
        while not self._shutdown:
            with self._dirq_cv:
                while not self._dirq and not self._shutdown:
                    self._dirq_cv.wait(timeout=1.0)
                batch = list(self._dirq)
                self._dirq.clear()
            if not batch:
                continue
            adds: dict[int, list] = {}
            drops: dict[int, list] = {}
            with self.lock:
                buckets = list(self.buckets)
                links = dict(self.links)
            for kind, oid, nid in batch:
                sid = buckets[bucket_of(oid)]
                if kind == "add":
                    adds.setdefault(sid, []).append((oid, nid))
                else:
                    drops.setdefault(sid, []).append(oid)
            for sid in set(adds) | set(drops):
                link = links.get(sid)
                if link is None:
                    continue
                try:
                    if sid in adds:
                        link.send(("dir_add", adds[sid]))
                    if sid in drops:
                        link.send(("dir_drop", drops[sid]))
                except OSError:
                    # Dead shard: requeue for after the heal pass — the
                    # mirror must not silently drop locations.
                    with self._dirq_cv:
                        self._dirq.extend(
                            ("add", o, n) for o, n in adds.get(sid, []))
                        self._dirq.extend(
                            ("drop", o, None) for o in drops.get(sid, []))
                    time.sleep(0.2)

    # -------- health / failover --------

    def check_and_heal(self) -> bool:
        """One health pass: respawn dead shards (WAL replay brings their
        committed slice back), re-slice around the dead window, then hand
        buckets back. Returns True when the shard map changed."""
        changed = False
        with self.lock:
            dead = [sid for sid, link in self.links.items()
                    if not link.alive()]
            for sid in dead:
                changed = True
                self.links[sid].close()
                self.epoch += 1
                self.buckets = self._reslice_locked(sid)
                self._assign_all_locked()
                try:
                    self._spawn_locked(sid)
                except OSError:
                    traceback.print_exc()
                    self.links.pop(sid, None)
                    continue
                # Respawned + replayed: hand its buckets back.
                self.epoch += 1
                self.buckets = [sid if orig == sid else cur
                                for orig, cur in zip(
                                    [i % self.n_shards
                                     for i in range(N_BUCKETS)],
                                    self.buckets)]
                self._assign_all_locked()
        return changed

    # -------- queries --------

    def snapshot_all(self) -> dict:
        """Merged {oid: [node_id]} across shards — the head-restart
        directory re-seed (each shard replays its WAL on boot)."""
        merged: dict[bytes, list] = {}
        with self.lock:
            links = dict(self.links)
        for _sid, link in links.items():
            try:
                msg = link.request(("shard_snapshot", 0))
            except (OSError, EOFError):
                continue  # dead shard: its slice returns after the heal
            if msg and msg[0] == "shard_state":
                merged.update(msg[3])
        return merged

    def drain_tev(self) -> list:
        """[(node_id, batch, dropped)] accumulated across shards since
        the last drain (the lazy pull behind sync_task_store)."""
        out: list = []
        with self.lock:
            links = dict(self.links)
        for _sid, link in links.items():
            try:
                msg = link.request(("tev_drain", 0))
            except (OSError, EOFError):
                continue
            if msg and msg[0] == "tev_batch":
                out.extend(msg[2])
        return out

    def shutdown(self):
        self._shutdown = True
        with self._dirq_cv:
            self._dirq_cv.notify_all()
        with self.lock:
            links = list(self.links.values())
            self.links.clear()
        for link in links:
            try:
                link.send(("shard_shutdown",))
            except OSError:
                pass
            link.close()
            if link.proc is not None:
                try:
                    link.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    link.proc.kill()


if __name__ == "__main__":
    main()
