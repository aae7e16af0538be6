"""Job ledger: multi-tenant attribution, quotas, and weighted-DRF shares.

Parity: the reference's job table (`gcs_job_manager.h` — every driver gets
a JobID and every task carries it) crossed with two scheduling papers the
ISSUE names as the policy source: Dominant Resource Fairness (Ghodsi et
al., NSDI '11 — pick the next grant from the job with the smallest
dominant share) and Borg (Verma et al., EuroSys '15 — quota as an
admission-time ceiling, not a reservation). TPU chips are the expected
dominant resource on this cluster, so shares are computed over the live
cluster totals including `TPU`.

The ledger is head-local state guarded by its own lock, deliberately kept
as small lock-scoped methods: tools/racecheck binds them directly in the
`job_ledger` protocol model to explore concurrent grant / settle /
stop-job interleavings. Two invariants the model checks live here:

  * a job's charged usage never exceeds its quota (charge() is the only
    admission point and checks under the lock);
  * no task is charged twice (`inflight` is keyed by task_id; a second
    charge for a live task_id is refused, which is what makes the head's
    grant paths safe to race against requeue/retry).

Attribution flows: JobSupervisor registers a job and stamps
`RAY_TPU_TORCH_JOB_ID` into the entrypoint's environment; drivers fall back to
the DEFAULT_JOB; workers inherit the job of the task they are executing
(nested submissions stay attributed); `.options(_job_id=...)` pins it
explicitly (tests/bench drive multiple tenants from one process this way).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

DEFAULT_JOB = "driver"

# Resources a quota can bound. Object-store bytes are accounted separately
# (per-put, not per-task) under the same record.
_QUOTA_KEYS = ("CPU", "GPU")


class JobRecord:
    __slots__ = ("job_id", "weight", "quota", "object_quota", "usage",
                 "inflight", "objects", "object_bytes", "spilled_bytes",
                 "over_quota_waits", "stopped", "submitted", "finished")

    def __init__(self, job_id: str, weight: float, quota: dict,
                 object_quota: int):
        self.job_id = job_id
        self.weight = max(float(weight), 1e-9)
        self.quota = {k: float(v) for k, v in (quota or {}).items()}
        self.object_quota = int(object_quota)
        self.usage = {k: 0.0 for k in _QUOTA_KEYS}
        self.inflight: dict[bytes, dict] = {}  # task_id -> charged req
        self.objects: OrderedDict[bytes, int] = OrderedDict()  # oid -> nbytes
        self.object_bytes = 0
        self.spilled_bytes = 0
        self.over_quota_waits = 0
        self.stopped = False
        self.submitted = 0
        self.finished = 0

    def dominant_share(self, totals: dict) -> float:
        """Weighted dominant share over the live cluster view (DRF):
        max over resources of usage/total, divided by the job weight."""
        share = 0.0
        for k, used in self.usage.items():
            total = totals.get(k, 0.0)
            if total > 0 and used > 0:
                share = max(share, used / total)
        return share / self.weight


class JobLedger:
    """Head-side per-job accounting. Every method takes the ledger lock
    for its whole body — callers never hold it across this boundary (the
    head's Runtime.lock is always taken FIRST when both are needed)."""

    def __init__(self, default_quota: dict | None = None,
                 default_object_quota: int = 0,
                 default_weight: float = 1.0):
        self.lock = threading.Lock()
        self.jobs: dict[str, JobRecord] = {}
        # oid -> owning job: the free path only knows the oid, and a scan
        # over every job's object table per free would make _free_object
        # O(jobs) on the head's hot release loop.
        self._obj_job: dict[bytes, str] = {}
        self._default_quota = dict(default_quota or {})
        self._default_object_quota = int(default_object_quota)
        self._default_weight = float(default_weight)

    # ---- registration / lifecycle ----

    def register(self, job_id: str, weight: float | None = None,
                 quota: dict | None = None,
                 object_quota: int | None = None) -> None:
        """Register (or re-arm) a job. Idempotent; re-registering a
        stopped id revives it (a resubmitted job reuses its name)."""
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                rec = self._new_record(job_id)
                self.jobs[job_id] = rec
            if weight is not None:
                rec.weight = max(float(weight), 1e-9)
            if quota is not None:
                rec.quota = {k: float(v) for k, v in quota.items()}
            if object_quota is not None:
                rec.object_quota = int(object_quota)
            rec.stopped = False

    def _new_record(self, job_id: str) -> JobRecord:
        return JobRecord(job_id, self._default_weight,
                         dict(self._default_quota),
                         self._default_object_quota)

    def _ensure_locked(self, job_id: str) -> JobRecord:
        rec = self.jobs.get(job_id)
        if rec is None:
            rec = self._new_record(job_id)
            self.jobs[job_id] = rec
        return rec

    def stop(self, job_id: str) -> bool:
        """Mark stopped: future charges are refused. The head separately
        drains queued specs and releases the job's live leases/objects."""
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None or rec.stopped:
                return False
            rec.stopped = True
            return True

    def is_stopped(self, job_id: str) -> bool:
        with self.lock:
            rec = self.jobs.get(job_id)
            return rec is not None and rec.stopped

    def multi_tenant(self) -> bool:
        """More than one live (non-stopped) tenant registered. The grant
        loop uses this to switch off single-tenant fast paths whose
        grants bypass the DRF order (worker pipelining)."""
        with self.lock:
            return sum(1 for j in self.jobs.values()
                       if not j.stopped) > 1

    # ---- task admission (the quota gate) ----

    def charge(self, job_id: str, task_id: bytes, req: dict) -> bool:
        """Admit one grant. False = refuse: job stopped, task already
        charged (double-grant guard), or the charge would push any
        quota'd resource over its ceiling. The refused key stays queued;
        the caller counts it as over-quota demand for the autoscaler."""
        with self.lock:
            rec = self._ensure_locked(job_id)
            if rec.stopped:
                return False
            if task_id in rec.inflight:
                return False
            for k, limit in rec.quota.items():
                if limit <= 0:
                    continue  # 0 = unlimited
                if rec.usage.get(k, 0.0) + req.get(k, 0.0) > limit + 1e-9:
                    rec.over_quota_waits += 1
                    return False
            charged = {k: float(v) for k, v in req.items()
                       if k in rec.usage and v}
            for k, v in charged.items():
                rec.usage[k] += v
            rec.inflight[task_id] = charged
            return True

    def would_admit(self, job_id: str, req: dict) -> bool:
        """Read-only admission probe: would charge() accept this request
        right now? No usage mutation, no over-quota counter bump — the
        autoscaler policy uses it to split queued demand into
        \"waiting on cluster capacity\" (scale-up signal) versus
        \"waiting on its own quota\" (adding nodes would not help)."""
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                return True
            if rec.stopped:
                return False
            for k, limit in rec.quota.items():
                if limit <= 0:
                    continue
                if rec.usage.get(k, 0.0) + req.get(k, 0.0) > limit + 1e-9:
                    return False
            return True

    def settle(self, job_id: str, task_id: bytes) -> None:
        """Release one grant's charge (completion, failure, requeue,
        node death). Idempotent — every lease/assignment pop funnel calls
        it and some tasks travel both paths across retries."""
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                return
            charged = rec.inflight.pop(task_id, None)
            if not charged:
                return
            for k, v in charged.items():
                rec.usage[k] = max(0.0, rec.usage.get(k, 0.0) - v)

    def note_submitted(self, job_id: str) -> None:
        with self.lock:
            self._ensure_locked(job_id).submitted += 1

    def note_finished(self, job_id: str) -> None:
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is not None:
                rec.finished += 1

    # ---- fair-share ordering ----

    def order(self, job_ids, totals: dict) -> list[str]:
        """Weighted-DRF order: smallest dominant share first (ties break
        on job id for determinism). Unknown ids sort as zero-share."""
        with self.lock:
            def share(jid):
                rec = self.jobs.get(jid)
                return rec.dominant_share(totals) if rec else 0.0
            return sorted(job_ids, key=lambda j: (share(j), j))

    def dominant_share(self, job_id: str, totals: dict) -> float:
        with self.lock:
            rec = self.jobs.get(job_id)
            return rec.dominant_share(totals) if rec else 0.0

    # ---- object plane (per-job blast radius) ----

    def charge_object(self, job_id: str, oid: bytes, nbytes: int) -> None:
        """Attribute a sealed object; insertion order is put order, so
        iteration yields the job's coldest objects first."""
        with self.lock:
            rec = self._ensure_locked(job_id)
            if oid not in rec.objects:
                rec.objects[oid] = int(nbytes)
                rec.object_bytes += int(nbytes)
                self._obj_job[oid] = job_id

    def release_object(self, oid: bytes, job_id: str | None = None) -> None:
        """Drop an object's attribution (free path). The owning job is
        resolved from the reverse map when the caller only has the oid."""
        with self.lock:
            jid = job_id if job_id is not None else self._obj_job.get(oid)
            if jid is None:
                return
            rec = self.jobs.get(jid)
            self._obj_job.pop(oid, None)
            if rec is None:
                return
            nbytes = rec.objects.pop(oid, None)
            if nbytes:
                rec.object_bytes = max(0, rec.object_bytes - nbytes)

    def note_spilled(self, job_id: str, nbytes: int) -> None:
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is not None:
                rec.spilled_bytes += int(nbytes)

    def object_overage(self, job_id: str) -> int:
        """Bytes this job holds beyond its object-store quota (0 when
        unlimited or within quota) — the spill trigger for the per-job
        blast-radius path."""
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None or rec.object_quota <= 0:
                return 0
            return max(0, rec.object_bytes - rec.object_quota)

    def over_quota_objects(self) -> list[tuple[str, int]]:
        """Every (job_id, overage bytes) past its object quota, biggest
        offender first — the head's pressure spiller drains these before
        touching within-quota tenants' objects."""
        with self.lock:
            out = [(jid, rec.object_bytes - rec.object_quota)
                   for jid, rec in self.jobs.items()
                   if rec.object_quota > 0
                   and rec.object_bytes > rec.object_quota]
            out.sort(key=lambda t: -t[1])
            return out

    def coldest_objects(self, job_id: str, limit: int = 64) -> list[bytes]:
        with self.lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                return []
            return [oid for oid, _ in list(rec.objects.items())[:limit]]

    def owner_of_object(self, oid: bytes) -> str | None:
        with self.lock:
            return self._obj_job.get(oid)

    # ---- introspection ----

    def snapshot(self, totals: dict | None = None) -> list[dict]:
        """Per-job view for /api/jobs: dominant share, quota usage,
        blast-radius counters."""
        totals = totals or {}
        with self.lock:
            out = []
            for jid in sorted(self.jobs):
                rec = self.jobs[jid]
                out.append({
                    "job_id": jid,
                    "weight": rec.weight,
                    "stopped": rec.stopped,
                    "dominant_share": round(rec.dominant_share(totals), 4),
                    "usage": {k: v for k, v in rec.usage.items() if v},
                    "quota": {k: v for k, v in rec.quota.items() if v > 0},
                    "inflight_tasks": len(rec.inflight),
                    "submitted": rec.submitted,
                    "finished": rec.finished,
                    "over_quota_waits": rec.over_quota_waits,
                    "object_bytes": rec.object_bytes,
                    "object_quota": rec.object_quota,
                    "spilled_bytes": rec.spilled_bytes,
                })
            return out

    def usage_of(self, job_id: str) -> dict:
        with self.lock:
            rec = self.jobs.get(job_id)
            return dict(rec.usage) if rec else {}


def ledger_from_config(cfg) -> JobLedger:
    quota = {}
    if getattr(cfg, "job_quota_cpu", 0.0) > 0:
        quota["CPU"] = cfg.job_quota_cpu
    if getattr(cfg, "job_quota_gpu", 0.0) > 0:
        quota["GPU"] = cfg.job_quota_gpu
    return JobLedger(
        default_quota=quota,
        default_object_quota=getattr(cfg, "job_quota_object_store_bytes", 0),
        default_weight=getattr(cfg, "job_default_weight", 1.0))


def current_job_id(opts: dict | None = None, rt=None) -> str:
    """Resolve the submitting job for a new TaskSpec. Priority:
    explicit `.options(_job_id=...)` pin > the job of the task this
    worker is currently executing (nested submissions inherit) >
    `RAY_TPU_TORCH_JOB_ID` (stamped by JobSupervisor into entrypoint
    subprocesses) > the default driver job."""
    if opts:
        jid = opts.get("_job_id")
        if jid:
            return str(jid)
    spec = getattr(rt, "current_task", None) if rt is not None else None
    jid = getattr(spec, "job_id", None)
    if jid:
        return jid
    return os.environ.get("RAY_TPU_TORCH_JOB_ID") or DEFAULT_JOB


def hostile_tick(submit, put=None, burst: int = 32,
                 put_bytes: int = 1 << 20) -> bool:
    """One tick of the replayable hostile tenant: when the armed
    `job.hostile` chaos site fires, unleash a task-storm burst (`submit`
    called `burst` times) and one giant put (`put(put_bytes)`). The bench
    and tests pass job-attributed closures; the chaos schedule + seed
    decide WHEN the storm hits, which is what makes the multi_tenant
    bench's hostile tenant replay identically run to run."""
    from ray_tpu_torch.core import chaos
    if not chaos.site("job.hostile"):
        return False
    for _ in range(burst):
        submit()
    if put is not None:
        put(put_bytes)
    return True
