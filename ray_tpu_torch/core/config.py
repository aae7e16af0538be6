"""Central config table with environment override.

Parity: reference `src/ray/common/ray_config_def.h` (RAY_CONFIG X-macro table,
223 flags, overridable via `RAY_<name>` env vars) and
`python/ray/_private/ray_constants.py`. Here the table is a typed dict; every
entry can be overridden with `RAY_TPU_TORCH_<NAME>` in the environment or a
`_system_config` dict passed to `ray_tpu_torch.init()`, and the resolved table is
inherited by spawned worker processes through the environment.
"""

from __future__ import annotations

import json
import os
from typing import Any

ENV_PREFIX = "RAY_TPU_TORCH_"

# name -> (type, default, help)
_CONFIG_DEFS: dict[str, tuple[type, Any, str]] = {
    # --- object store ---
    "object_store_memory_bytes": (int, 0, "shm arena size; 0 = auto (30% RAM, capped)"),
    "object_store_auto_cap_bytes": (int, 20 * 2**30, "cap for auto-sized arena"),
    "object_store_hash_slots": (int, 1 << 16, "object index slots in shm"),
    "object_store_shards": (int, 0, "lock shards in the shm store (index + "
                            "allocator split per-shard); 0 = auto "
                            "(power of two in [8, 16])"),
    "max_inline_object_bytes": (int, 100 * 1024, "results <= this are returned inline"),
    "max_inline_arg_bytes": (int, 256 * 1024, "task/actor-call args whose "
                             "pickle-5 buffers exceed this ship through the "
                             "shm arena (create/seal + ref in the frame) "
                             "instead of riding the socket frame; smaller "
                             "args stay inline to keep the no-arg latency "
                             "floor"),
    "object_spill_dir": (str, "", "directory for spilled objects; '' = <session>/spill"),
    "object_spill_threshold": (float, 0.8, "spill when arena usage exceeds this"),
    "put_reservation_min_bytes": (int, 4 << 20, "puts at least this large "
                                  "take the per-client write-reservation "
                                  "path (carve once under the shard/global "
                                  "lock, fill lock-free, publish sealed); "
                                  "0 disables the plane"),
    "put_reservation_bytes": (int, 0, "write-reservation extent size per "
                              "client; 0 = auto (min(256MB, arena/16)). "
                              "Bigger extents amortize the global carve + "
                              "spill check over more puts but strand more "
                              "headroom per idle client"),
    "objxfer_conn_cache_size": (int, 4, "idle persistent pull connections "
                                "cached per peer address (the objxfer "
                                "client reuses one connection per pull "
                                "instead of dialing); 0 = close after "
                                "every pull"),
    "objxfer_streams": (int, 4, "connections a single large cross-node "
                        "object pull is striped over (range requests on "
                        "cached connections); 1 = whole-object pulls"),
    "objxfer_stream_min_bytes": (int, 32 << 20, "objects smaller than this "
                                 "always pull on one connection"),
    # --- data plane (Arrow blocks in the arena) ---
    "data_block_arrow": (bool, True, "pyarrow.Table values seal into the "
                         "arena as tagged Arrow IPC objects (format "
                         "'arrow': the writer streams the IPC encoding "
                         "straight into a write reservation, readers "
                         "re-hydrate zero-copy over the mapped arena); "
                         "off = blocks ride the pickle path like any "
                         "other value"),
    "vectored_arg_fetch_min": (int, 2, "a task whose args carry at least "
                               "this many locally-missing ObjectRefs "
                               "subscribes to all of them in ONE wait_objs "
                               "frame, and the head groups same-source "
                               "pulls into one batched objxfer round "
                               "(fetch_many) instead of N serial gets; "
                               "0 disables vectored fetch"),
    # --- compiled-graph channels (parity: the NCCL-channel data plane
    #     under the reference's compiled graphs) ---
    "dag_channel_type": (str, "tensor", "compiled-graph channel encoding: "
                         "'tensor' stages array leaves straight into shm "
                         "(no pickle on tensor bytes; zero-copy reads), "
                         "'pickle' is the legacy whole-value frame"),
    "tensor_channel_inline_bytes": (int, 4096, "array leaves smaller than "
                                    "this ride the tensor frame's sidecar "
                                    "pickle instead of the binary leaf "
                                    "plane (descriptor overhead isn't "
                                    "worth it below ~a page)"),
    # --- workers / scheduling ---
    "num_workers": (int, 0, "worker pool size; 0 = num_cpus"),
    "gc_gen0_threshold": (int, 20000, "python gc gen-0 threshold in head/"
                          "workers; default 700 triggers a collection (and "
                          "jax's gc callback) every ~70 control messages"),
    "gc_freeze_init": (bool, True, "gc.freeze() the boot-time object "
                       "universe (jax + imports, ~1M objects) in head/"
                       "zygote/agent processes: full collections stop "
                       "re-scanning it (a gen-2 pass over the jax universe "
                       "ran 100ms+ and showed up as bimodal task-storm "
                       "rates), and zygote-forked workers keep those pages "
                       "COW-shared. Cost: cyclic garbage created BEFORE "
                       "init leaks (refcounted objects still free "
                       "normally)"),
    "worker_startup_timeout_s": (float, 60.0, "time to wait for a worker to boot"),
    "worker_idle_timeout_s": (float, 300.0, "idle workers above pool size are reaped"),
    "max_pending_lease_requests": (int, 10, "in-flight lease requests per scheduling key"),
    "max_tasks_in_flight_per_worker": (int, 8, "same-key tasks pipelined "
                                      "onto one busy worker (depth-K "
                                      "dispatch; 1 disables pipelining)"),
    "task_max_retries_default": (int, 3, "default retries for idempotent tasks"),
    "actor_max_restarts_default": (int, 0, "default actor restarts"),
    # --- cluster-view broadcast + lease spillback (parity:
    #     ray_syncer.h:20 broadcast half + cluster_task_manager.cc:187
    #     scheduler spillback — decentralized agent->agent rebalancing) ---
    "cluster_view_broadcast_ms": (int, 100, "head broadcasts the versioned "
                                  "cluster resource view to node agents at "
                                  "this interval; per-agent version cursors "
                                  "make every frame a delta (an agent only "
                                  "receives entries that changed since its "
                                  "cursor); 0 disables the broadcast plane"),
    "lease_spillback": (bool, True, "a node agent whose un-started lease "
                        "backlog exceeds its capacity forwards leases "
                        "directly to an under-loaded peer agent (one "
                        "agent->agent hop; the head is informed "
                        "asynchronously via a lease_spilled delta)"),
    "lease_spill_backlog_per_worker": (int, 2, "spillback backlog "
                                       "threshold: spill only while the "
                                       "agent's un-started lease queue "
                                       "exceeds this many tasks per local "
                                       "worker (the kept-local floor)"),
    "lease_spill_max_hops": (int, 2, "max agent->agent hops a lease may "
                             "take before it must execute where it is "
                             "(ping-pong guard; each spill consumes one)"),
    # --- lineage reconstruction (parity: object_recovery_manager.h:43,
    #     task_manager.h:216 lineage resubmission) ---
    "max_object_reconstructions": (int, 3, "times a task is re-executed to "
                                   "recover its lost plasma-tier outputs"),
    "lineage_cache_entries": (int, 50000, "max finished-task specs retained "
                              "for reconstruction; 0 disables lineage"),
    # --- memory / OOM (parity: memory_monitor.h + worker killing policy) ---
    "memory_monitor_refresh_ms": (int, 0, "OOM monitor interval; 0 = off"),
    "memory_usage_threshold": (float, 0.95, "kill a worker above this usage"),
    # --- control plane ---
    "health_check_period_ms": (int, 1000, "node health-check interval"),
    "fetch_retry_timeout_s": (float, 10.0, "re-drive a cross-node object "
                              "fetch with no reply after this long "
                              "(<=0 disables; 3 retries then lost)"),
    "async_actor_executor_shards": (int, 0, "event-loop shards per async "
                                    "actor (each a thread running its own "
                                    "asyncio loop; idle shards steal queued "
                                    "calls from busy ones). 0 = auto "
                                    "(min(4, cores/2), floor 1). >1 runs "
                                    "coroutines of ONE actor on several "
                                    "threads — method bodies that mutate "
                                    "instance state between awaits should "
                                    "pin shards to 1"),
    "async_actor_default_max_concurrency": (int, 1000, "max_concurrency "
                                            "for async actors that don't "
                                            "set one (parity: the "
                                            "reference's async-actor "
                                            "default)"),
    "direct_actor_calls": (bool, True, "worker->actor calls between agent "
                           "nodes ride direct agent<->agent channels, "
                           "bypassing the head relay"),
    "worker_direct_calls": (bool, True, "same-node worker->worker actor "
                            "calls ride a direct unix-socket peer plane "
                            "(2 hops instead of 4), bypassing the head on "
                            "head nodes and the agent relay on agent "
                            "nodes (call AND reply; the agent only sees "
                            "async task-event/bookkeeping traffic)"),
    "health_check_failure_threshold": (int, 5, "missed checks before a node is dead"),
    "gcs_port": (int, 0, "GCS TCP port; 0 = pick free port"),
    # --- head fault tolerance (parity: redis_store_client.h:111 +
    #     gcs_init_data.h reload; raylet reconnect/resync) ---
    "head_persistence_path": (str, "", "journal file for head tables "
                              "(kv/fns/actors/pgs/tasks); '' = volatile"),
    "agent_reconnect_grace_s": (float, 15.0, "node agent retries the head "
                                "connection this long before dying"),
    "head_restart_adopt_grace_s": (float, 10.0, "restored actors wait this "
                                   "long for their old worker to be "
                                   "re-registered before respawning"),
    "head_wal": (bool, True, "when head_persistence_path is set, extend "
                 "the journal from the durable tables to the full "
                 "control-plane WAL: in-flight lease grants, object-"
                 "directory locations, PG reservations and serve stream "
                 "cursors (the state a head.kill chaos SIGKILL must "
                 "replay). False keeps PR-8's tables-only journal"),
    # --- head shards (parity: the reference GCS's service split; object
    #     directory + task-event ingest shard by id space, lease policy
    #     stays on the head — core/head_shards.py) ---
    "head_shards": (int, 0, "spawn N head-shard subprocesses owning "
                    "disjoint id-space slices of the object directory "
                    "(durable per-shard WAL mirror) and task-event "
                    "ingest; the shard map rides the cluster-view "
                    "broadcast and agents ship task_events straight to "
                    "the owning shard. 0 = single-head (no shards)"),
    # --- fault injection (test leverage, parity: rpc_chaos.h) ---
    "testing_rpc_failure": (str, "", "'method=max_failures' comma list; drops messages"),
    "testing_delay_us": (str, "", "'method=min:max' comma list; injects delays"),
    # --- chaos plane (core/chaos.py: deterministic seeded fault
    #     injection at named hot-path seams) ---
    "chaos_schedule": (str, "", "comma list of 'site:spec' arming named "
                       "injection sites (chaos.REGISTERED_SITES): spec is "
                       "a 1-based hit count (fire exactly once on that "
                       "hit) or a probability in (0,1) applied per hit; "
                       "site may be an fnmatch glob ('transport.*:0.01'). "
                       "Same chaos_seed => identical per-site fire "
                       "sequence. '' disables (zero overhead)"),
    "chaos_seed": (int, 0, "seed for the chaos plane's per-site RNGs; a "
                   "fixed seed makes a chaos storm replayable"),
    # --- unified retry/backoff policy (core/retry.py Backoff: capped
    #     exponential + jitter against a deadline — the one cadence every
    #     core retry loop sleeps through) ---
    "retry_backoff_base_s": (float, 0.05, "first retry interval"),
    "retry_backoff_cap_s": (float, 2.0, "retry interval ceiling"),
    "retry_backoff_jitter": (float, 0.2, "fractional jitter (+/-) applied "
                             "to every interval — desynchronizes N "
                             "processes re-dialing one restarted peer"),
    "peer_dial_timeout_s": (float, 5.0, "connect timeout for ctrl-plane "
                            "dials (agent<->agent channels, spill hops)"),
    "lease_redrive_timeout_s": (float, 10.0, "head re-sends a granted "
                                "lease whose node reports ITSELF idle "
                                "(no backlog, nothing in flight) this "
                                "long after the grant — recovers a "
                                "node_exec frame lost on the wire; "
                                "agents dedup re-sent (task, lease_seq) "
                                "pairs so a re-drive can never "
                                "double-queue. <=0 disables"),
    "native_sched": (bool, True, "run the scheduling hot loop's select-"
                     "round core in C++ (cpp/agent_core.cc): the agent's "
                     "frame pump, lease queue/dedup/dispatch bookkeeping "
                     "and hot-frame builds go native, and the head grants "
                     "leases as raw spec bytes (node_exec_raw) consumed "
                     "without a Python unpickle. Pure-Python fallback "
                     "(off, or a failed native build) is behaviorally "
                     "identical; chaos-armed processes route every send "
                     "through the Python chaos sites either way"),
    "native_head": (bool, True, "run the HEAD's listener select round in "
                    "C++ too (cpp/head_core.cc), finishing the scheduling "
                    "plane's native split: the node-listener frame pump, "
                    "in-place node_done_raw parse + (task_id, lease_seq) "
                    "completion ledger, and native node_exec_raw grant "
                    "builds into per-node outboxes go native, while "
                    "Python keeps all policy (placement, spill, placement "
                    "groups, dep gating, retries) and every cold path "
                    "(lease_return/lease_spilled/reclaim/redrive/cpp "
                    "leases) keeps its object-form frames. Pure-Python "
                    "fallback (off, or a failed native build) is "
                    "behaviorally identical; chaos-armed processes skip "
                    "native consumption and route every send through the "
                    "Python chaos sites either way"),
    "put_extent_affinity": (bool, True, "store_reserve prefers free-list "
                            "ranges this pid owned before (per-pid extent "
                            "hints recorded when reservations retire): "
                            "refilled write extents land on pages already "
                            "in the writer's page table instead of cold "
                            "ones — the r06-measured 8.4->2.1 GB/s "
                            "multi-writer collapse"),
    "put_extent_pretouch": (bool, True, "pre-fault a freshly carved "
                            "reservation extent's pages at reserve time "
                            "(MADV_POPULATE_WRITE, manual touch "
                            "fallback) so the bump-fill memcpys never "
                            "minor-fault mid-copy"),
    "objxfer_stream_fail_limit": (int, 3, "after this many striped-pull "
                                  "range failures against one peer "
                                  "address, pulls from it degrade to "
                                  "single-stream until a striped pull "
                                  "completes clean"),
    "orphan_reclaim_interval_s": (float, 5.0, "store owners (head, node "
                                  "agents) sweep the arena's write-"
                                  "reservation records for dead-pid "
                                  "owners at this cadence, returning "
                                  "leaked extents and repairing "
                                  "rsv_unused (a client SIGKILLed "
                                  "between reserve and publish strands "
                                  "its extent otherwise). <=0 disables "
                                  "the periodic sweep (pressure-path "
                                  "sweeps still run)"),
    # --- elastic training plane (train/trainer.py + train/checkpoint.py:
    #     crash-consistent sharded checkpoints, gang re-mesh on worker
    #     death; parity: Train FailureConfig/worker-group restart) ---
    "train_poll_timeout_s": (float, 600.0, "controller-side deadline for "
                             "one worker-group poll() round trip; a "
                             "worker that is wedged-not-dead (poll never "
                             "returns) is declared hung after this long "
                             "and handled by the FailurePolicy instead "
                             "of stalling the run"),
    "train_progress_timeout_s": (float, 0.0, "hung-GANG watchdog: if NO "
                                 "rank reports progress (a report or a "
                                 "finish) for this long while polls still "
                                 "answer, the group is declared hung and "
                                 "restarted by the FailurePolicy. 0 "
                                 "disables (polls answering + steps "
                                 "legitimately slow is the common case)"),
    "train_restart_wait_s": (float, 5.0, "elastic restart capacity-settle "
                             "deadline: a gang restart waits up to this "
                             "long (sleeping through the retry_backoff_* "
                             "cadence) for the dead gang's resources to "
                             "release before sizing the new world"),
    "train_ckpt_arena": (bool, True, "checkpoint shards are additionally "
                         "sealed as tagged arena objects (put_tagged) so "
                         "a restarted gang can restore over striped "
                         "objxfer pulls from surviving peers; the "
                         "committed on-disk manifest stays the source of "
                         "truth (arena restore is best-effort)"),
    # --- multi-tenancy (core/jobs.py job ledger: quotas + weighted-DRF
    #     fair-share at the head's lease grant; parity: DRF NSDI '11 +
    #     Borg quota semantics over the reference's JobID attribution) ---
    "fair_share": (bool, True, "the head's grant loop picks the next "
                   "lease in weighted dominant-resource-fairness order "
                   "over the live cluster view, so a task-storm job "
                   "queues behind its share instead of monopolizing the "
                   "pump; off = FIFO over scheduling keys (the "
                   "multi_tenant bench's A/B collapse mode)"),
    "job_quota_cpu": (float, 0.0, "default per-job CPU ceiling enforced "
                      "at lease grant (a task that would push the job's "
                      "charged CPUs over this stays queued); 0 = "
                      "unlimited. Per-job overrides ride "
                      "submit_job(quota=...)"),
    "job_quota_gpu": (float, 0.0, "default per-job GPU ceiling "
                      "enforced at lease grant; 0 = unlimited"),
    "job_quota_object_store_bytes": (int, 0, "default per-job object-"
                                     "store footprint ceiling; a job "
                                     "beyond it has ITS coldest objects "
                                     "spilled to disk (per-job blast "
                                     "radius) instead of cluster-wide "
                                     "eviction pressure; 0 = unlimited"),
    "job_default_weight": (float, 1.0, "DRF weight for jobs that don't "
                           "set one (share = dominant usage fraction / "
                           "weight; heavier jobs are granted more)"),
    "task_events_max_per_job": (int, 0, "head-side TaskEventStorage "
                                "per-job retention cap: settled attempts "
                                "of a job beyond it are evicted (drop-"
                                "accounted in dropped_per_job) even when "
                                "the global task_events_max_tasks bound "
                                "has room; 0 = no per-job cap"),
    # --- autoscaler policy core (autoscaler/policy.py: quota-aware
    #     demand -> slice-shaped node types) ---
    "autoscaler_quota_demand": (bool, True, "queued-beyond-quota leases "
                                "count as autoscaler demand (scale up "
                                "rather than starve an over-quota "
                                "tenant; its quota still caps what it "
                                "may hold, so the new capacity serves "
                                "the other tenants it was crowding)"),
    "autoscaler_shed_window_s": (float, 30.0, "trailing window over "
                                 "which serve shed events "
                                 "(ray_tpu_serve_shed_total) are rated "
                                 "for scale-up demand"),
    "autoscaler_shed_rate_threshold": (float, 1.0, "sheds/second over "
                                       "the window that convert into "
                                       "one serve-replica-shaped "
                                       "scale-up bundle"),
    # --- observability ---
    "event_stats": (bool, False, "record per-handler event-loop stats"),
    "export_events": (bool, False, "append task/actor/node state "
                      "transitions as JSONL under <session>/export_events"),
    "task_events": (bool, True, "task-event pipeline (parity: "
                    "task_event_buffer.h:225 + gcs_task_manager.h:94): "
                    "every process stamps timestamped task state "
                    "transitions (submit, lease grant, spill hops, "
                    "dispatch, exec sub-spans, output seal, channel/"
                    "objxfer transfers) into a per-process drop-oldest "
                    "ring, shipped to the head on frames the agents/"
                    "workers already send; powers ray_tpu_torch.timeline(), "
                    "util.state.summary_tasks(), /api/timeline and the "
                    "per-stage latency histograms at /metrics. Off = "
                    "near-zero cost (one flag check per site)"),
    "task_events_buffer_size": (int, 10000, "per-process task-event ring "
                                "capacity (drop-oldest; drops counted "
                                "and exported at /metrics)"),
    "task_events_flush_ms": (int, 200, "emitters flush their ring at "
                             "most this often, piggybacked on frames "
                             "they already send (worker reply channel, "
                             "agent select-round batch/heartbeat)"),
    "task_events_max_tasks": (int, 10000, "head-side TaskEventStorage "
                              "bound: merged task attempts retained; "
                              "eviction prefers settled attempts of the "
                              "largest job (gcs_task_manager.h:94 "
                              "parity) and is drop-accounted"),
    "metrics_report_interval_ms": (int, 10000, "metrics flush interval"),
    # --- logging ---
    "log_dir": (str, "", "session log dir; '' = <session>/logs"),
    "log_to_driver": (bool, True, "stream worker log lines to the driver "
                      "stdout (parity: log_monitor.py + log_to_driver)"),
}


def _coerce(ty: type, raw: str):
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw


class Config:
    """Resolved config. Priority: explicit system_config > env > default."""

    def __init__(self, system_config: dict[str, Any] | None = None):
        self._values: dict[str, Any] = {}
        overrides = dict(system_config or {})
        for name, (ty, default, _help) in _CONFIG_DEFS.items():
            if name in overrides:
                self._values[name] = overrides.pop(name)
            else:
                raw = os.environ.get(ENV_PREFIX + name.upper())
                self._values[name] = _coerce(ty, raw) if raw is not None else default
        if overrides:
            raise ValueError(f"unknown config keys: {sorted(overrides)}")

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def to_env(self) -> dict[str, str]:
        """Serialize for inheritance by child processes."""
        return {ENV_PREFIX + "SYSTEM_CONFIG": json.dumps(self._values)}

    @classmethod
    def from_env(cls) -> "Config":
        raw = os.environ.get(ENV_PREFIX + "SYSTEM_CONFIG")
        return cls(json.loads(raw)) if raw else cls()


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_config(cfg: Config):
    global _global_config
    _global_config = cfg
    # Chaos-injection specs live in the config; invalidate the cached injector.
    try:
        from ray_tpu_torch.core import transport
        transport._chaos = None
    except ImportError:
        pass
    # Arm (or disarm) the named-site chaos plane from the resolved config
    # — every process that adopts a config re-derives its site table, so
    # the schedule propagates to workers/agents through the environment.
    try:
        from ray_tpu_torch.core import chaos
        chaos.configure_from(cfg)
    except ImportError:
        pass
