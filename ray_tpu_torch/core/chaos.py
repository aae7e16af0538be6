"""Deterministic, seeded fault injection at named hot-path seams.

Parity: reference `src/ray/rpc/rpc_chaos.h` (RpcFailure injection keyed by
method name) — generalized from "drop this RPC" to a registry of NAMED
INJECTION SITES threaded through every hot seam of the runtime: transport
send/recv, objxfer range pulls, the shm store's write-reservation plane,
the agent's lease/spill control frames, the worker's direct-call plane,
and the head's lease grants. Each site encodes one concrete fault the
surrounding code must survive (a torn frame, a dead stream, a SIGKILL
between reserve and publish); the schedule only decides WHEN it fires.

Schedule grammar (`chaos_schedule` config knob, comma-separated):

    site:N      fire exactly once, on the N-th hit of that site (1-based)
    site:P      P in (0, 1): fire each hit with probability P
    glob:spec   `site` may be an fnmatch glob over REGISTERED_SITES
                ("transport.*:0.01" arms every transport seam at 1%)

Determinism: every site derives its own RNG from (`chaos_seed`, site
name), so a given seed replays the identical per-site fire sequence
regardless of how calls to DIFFERENT sites interleave across threads —
the property that makes a chaos storm a regression test instead of a
flake generator. The fire log (`fire_log()`) records (site, hit#) pairs
for reproducibility assertions.

Zero overhead when disabled: `site()` reads one module global and
returns. Armed processes pay a dict lookup + lock per hit.

The schedule rides the resolved config (env / `_system_config`), so every
process in the cluster — head, agents, workers — arms the same table;
role targeting falls out of the site namespace (`agent.*` sites only ever
execute inside agents, `worker.*` inside workers).
"""

from __future__ import annotations

import fnmatch
import os
import signal
import threading
import time
import zlib

# Every legal site name -> the fault the seam injects when it fires.
# tools/staticcheck's chaos_sites pass cross-checks this table against the
# `chaos.site("...")` literals in the source tree, both directions.
REGISTERED_SITES: dict[str, str] = {
    "transport.send.drop": "frame silently dropped on send",
    "transport.send.trunc": "half the frame sent, then connection reset "
                            "(torn frame at the receiver)",
    "transport.send.delay": "send delayed by a seeded jitter",
    "transport.recv.delay": "recv delayed by a seeded jitter",
    "transport.recv.reset": "recv reports connection reset (peer EOF)",
    "transport.dial.fail": "ctrl-plane dial raises OSError",
    "objxfer.pull.reset": "pull connection dies before the request",
    "objxfer.range.reset": "one range stream of a striped pull dies "
                           "mid-transfer",
    "objxfer.fetch.delay": "cross-node fetch delayed by a seeded jitter",
    "store.reserve.exhaust": "write-reservation carve reports arena "
                             "exhaustion (falls back to evicting create)",
    "store.reserve.abandon": "reservation tail leaked instead of released "
                             "(the crash window the liveness sweep repairs)",
    "store.publish.kill": "self-SIGKILL between reserve and publish",
    "head.lease_grant.lose": "a node_exec lease batch dropped on send",
    "head.kill": "the head self-SIGKILLs right after WAL-committing a "
                 "lease batch and before sending it (restart must replay "
                 "every committed task and re-admit every journaled "
                 "stream from the journal alone)",
    "shard.kill": "a head shard self-SIGKILLs on a dir/tev ingest frame, "
                  "before the WAL append (the manager's heal pass must "
                  "re-slice, respawn and WAL-replay it; committed "
                  "entries survive, the un-acked frame is re-driven by "
                  "the mirror flusher)",
    "agent.spill_notice.lose": "the lease_spilled notice to the head "
                               "dropped",
    "agent.peer_dial.fail": "agent->agent ctrl dial reports unreachable",
    "agent.sigkill": "the node agent SIGKILLs itself (heartbeat tick)",
    "worker.exec.kill": "worker self-SIGKILLs right before executing a "
                        "task",
    "worker.direct_call.reset": "the direct worker<->worker UDS channel "
                                "resets under an outgoing call",
    "train.worker_kill": "a train worker self-SIGKILLs mid-step (on a "
                         "session.report — no ack, no shard durability)",
    "train.ckpt_shard_abandon": "a rank writes its checkpoint shard but "
                                "dies before acking durability, so the "
                                "step's manifest can never commit",
    "train.manifest_loss": "the controller's manifest commit for a "
                           "fully-acked step is dropped (resume must come "
                           "from the previous committed step)",
    "train.poll_hang": "a train worker's poll() wedges without dying "
                       "(the hung-not-dead worker the watchdog converts "
                       "into a FailurePolicy restart)",
    "serve.router.drop": "the serving coordinator's routed decode "
                         "dispatch is dropped before it reaches the "
                         "pool (redriven through the shared backoff)",
    "serve.kv_handoff.lose": "the sealed prefill->decode KV handoff "
                             "object is lost in flight — the decode "
                             "replica must fall back to re-prefilling",
    "serve.decode.kill": "a decode replica self-SIGKILLs mid-stream "
                         "(one hit per emitted stream chunk; in-flight "
                         "streams must re-resolve exactly-once on a "
                         "surviving replica)",
    "serve.prefill.stall": "the prefill worker stalls by a seeded "
                           "jitter before returning its KV handoff",
    "job.hostile": "the hostile tenant strikes: a seeded task-storm "
                   "burst plus a giant put attributed to one job "
                   "(core/jobs.py hostile_tick — the multi_tenant "
                   "bench's replayable noisy neighbor)",
}


class _SiteState:
    __slots__ = ("mode", "arg", "rng", "hits", "fires")

    def __init__(self, mode: str, arg, rng):
        self.mode = mode  # "nth" | "prob"
        self.arg = arg
        self.rng = rng
        self.hits = 0
        self.fires = 0


_armed: dict[str, _SiteState] | None = None
_fire_log: list = []
_FIRE_LOG_CAP = 8192
_lock = threading.Lock()

# racecheck seam: the interleaving explorer (tools/racecheck) registers a
# schedule hook so every chaos site doubles as a yield point — the same
# zero-overhead contract as a disarmed schedule (one global read).
_sched_hook = None


def set_schedule_hook(hook):
    """Install (or clear, with None) the explorer's schedule hook;
    returns the previous hook so nested explorers can restore it."""
    global _sched_hook
    old = _sched_hook
    _sched_hook = hook
    return old


def _site_rng(name: str, seed: int):
    import random
    # Stable per-site stream: crc32 (not hash(): salted per process) mixed
    # with the shared seed, so every process derives identical streams.
    return random.Random(((zlib.crc32(name.encode()) + 1) << 32)
                         ^ (seed * 0x9E3779B97F4A7C15 + 0x1234567))


def _parse_spec(spec: str):
    try:
        if "." in spec or "e" in spec.lower():
            p = float(spec)
            if not 0.0 < p < 1.0:
                raise ValueError
            return "prob", p
        n = int(spec)
        if n < 1:
            raise ValueError
        return "nth", n
    except ValueError:
        raise ValueError(
            f"chaos_schedule spec {spec!r}: expected a 1-based hit count "
            "(integer) or a probability in (0, 1)") from None


def configure(schedule: str, seed: int = 0) -> None:
    """(Re)arm from a schedule string; empty schedule disarms. Raises
    ValueError on an unknown site or malformed spec — a typo'd schedule
    must fail the boot, not silently inject nothing."""
    global _armed, _fire_log
    if not schedule:
        _armed = None
        _fire_log = []
        return
    armed: dict[str, _SiteState] = {}
    for part in schedule.split(","):
        part = part.strip()
        if not part:
            continue
        pat, sep, spec = part.rpartition(":")
        if not sep or not pat:
            raise ValueError(f"chaos_schedule entry {part!r}: want "
                             "'site:spec'")
        names = (fnmatch.filter(REGISTERED_SITES, pat)
                 if any(c in pat for c in "*?[") else
                 ([pat] if pat in REGISTERED_SITES else []))
        if not names:
            raise ValueError(
                f"chaos_schedule: no registered site matches {pat!r} "
                f"(have: {', '.join(sorted(REGISTERED_SITES))})")
        mode, arg = _parse_spec(spec)
        for name in names:
            armed[name] = _SiteState(mode, arg, _site_rng(name, seed))
    _fire_log = []
    _armed = armed


def configure_from(cfg) -> None:
    configure(getattr(cfg, "chaos_schedule", ""),
              getattr(cfg, "chaos_seed", 0))


def armed() -> bool:
    return _armed is not None


def site(name: str) -> bool:
    """One hit of the named seam; returns True when the fault should
    fire. The caller implements the fault — the site's semantics live at
    the seam, the schedule only picks the hits."""
    h = _sched_hook
    if h is not None:
        h(name)
    a = _armed
    if a is None:
        return False
    st = a.get(name)
    if st is None:
        if name not in REGISTERED_SITES:
            raise ValueError(f"chaos site {name!r} is not registered "
                             "(add it to chaos.REGISTERED_SITES)")
        return False
    with _lock:
        st.hits += 1
        if st.mode == "nth":
            fire = st.hits == st.arg
        else:
            fire = st.rng.random() < st.arg
        if fire:
            st.fires += 1
            if len(_fire_log) < _FIRE_LOG_CAP:
                _fire_log.append((name, st.hits))
    return fire


def delay(name: str, max_s: float = 0.05) -> None:
    """Sleep a seeded fraction of `max_s` when the site fires (the
    duration draw rides the same per-site RNG, so it replays too)."""
    a = _armed
    if a is None:
        if _sched_hook is not None:
            site(name)  # schedule point only: disarmed sites never fire
        return
    if site(name):
        st = a[name]
        with _lock:
            frac = st.rng.random()
        time.sleep(max_s * frac)


def kill(name: str) -> None:
    """SIGKILL this process when the site fires — the crash-consistency
    probe: no atexit, no flush, no release runs."""
    if _armed is None and _sched_hook is None:
        return
    if site(name):
        os.kill(os.getpid(), signal.SIGKILL)


def snapshot() -> dict:
    """site -> (hits, fires) for every armed site (diagnostics/tests)."""
    a = _armed
    if a is None:
        return {}
    with _lock:
        return {name: (st.hits, st.fires) for name, st in a.items()}


def fire_log() -> list:
    """[(site, hit#)] in fire order — the reproducibility witness: same
    seed + same per-site call sequence => identical log."""
    with _lock:
        return list(_fire_log)
