"""In-loop training session API.

Parity: reference `python/ray/train/_internal/session.py` —
`ray.train.report(:672)`, `get_checkpoint(:786)`, `get_dataset_shard(:1114)`.
The session lives inside each training worker actor; report() hands metrics
(+ optional checkpoint data) to the worker's mailbox, which the controller
polls.

Checkpoint reports are phase 1 of the two-phase commit (train/checkpoint.py):
EVERY rank that passes `checkpoint=` durably writes its own shard into the
step's deterministic directory (tmp+fsync+rename) and acks the write in its
report; the controller commits the manifest only once all ranks of the step
acked. A rank that dies between the shard write and the ack (the
`train.ckpt_shard_abandon` chaos site) leaves an uncommitted directory the
next restart garbage-collects — never a torn checkpoint that looks
resumable.
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch.core import chaos


class TrainSession:
    def __init__(self, rank: int, world_size: int, storage_dir: str,
                 checkpoint=None, dataset_shards: dict | None = None,
                 local_rank: int = 0, local_world_size: int = 1,
                 dataset_offsets: dict | None = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.storage_dir = storage_dir
        self.resume_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        # name -> rows the run consumed BEFORE this (re)start (recorded in
        # the committed manifest; the trainer already re-split the shards
        # past them — exposed so loops can keep their own cursors honest).
        self.dataset_offsets = dict(dataset_offsets or {})
        self.reports: list[dict] = []
        self._ckpt_seq = 0  # fallback step for loops that don't report one
        self.latest_checkpoint = None
        self.finished = False
        self.error: BaseException | None = None
        self._lock = threading.Lock()

    def report(self, metrics: dict, checkpoint=None,
               dataset_offsets: dict | None = None):
        # Mid-step crash probe: fires BEFORE the shard write, so the step's
        # report (and any checkpoint ack) is lost exactly the way a
        # preempted host loses it.
        chaos.kill("train.worker_kill")
        entry = {"metrics": dict(metrics), "rank": self.rank}
        if checkpoint is not None:
            entry.update(self._write_ckpt_shard(
                checkpoint, metrics, dataset_offsets))
        with self._lock:
            self.reports.append(entry)

    def _write_ckpt_shard(self, checkpoint, metrics: dict,
                          dataset_offsets: dict | None) -> dict:
        """Phase 1: durably persist this rank's shard and build the ack.
        Returns report fields ({} when the rank abandons pre-ack)."""
        from ray_tpu_torch.train import checkpoint as ckpt_mod
        # Monotonic fallback: reports are DRAINED by the controller's
        # polls, so len(reports) repeats and would collide step dirs.
        step = int(metrics.get("step", self._ckpt_seq))
        self._ckpt_seq += 1
        if isinstance(checkpoint, ckpt_mod.Checkpoint):
            # Externally-written state (e.g. an orbax save_state dir the
            # loop owns): nothing to write, but the commit protocol still
            # gates on every rank acking it reached this point.
            ckpt_dir, shard = checkpoint.path, None
        else:
            ckpt_dir = ckpt_mod.step_dir(self.storage_dir, step)
            shard = ckpt_mod.write_shard(
                checkpoint, ckpt_dir, self.rank, self.world_size)
        # The crash window between durability and the ack: the shard file
        # exists, the controller never hears — the manifest must not
        # commit, and restart must fall back to the previous step.
        if chaos.site("train.ckpt_shard_abandon"):
            return {}
        arena_hex = None
        if shard is not None:
            arena_hex = self._seal_shard_arena(checkpoint)
        self.latest_checkpoint = ckpt_mod.Checkpoint(ckpt_dir)
        ack = {"dir": ckpt_dir, "step": step, "rank": self.rank,
               "world": self.world_size, "shard": shard}
        if arena_hex:
            ack["arena"] = arena_hex
        if dataset_offsets and self.rank == 0:
            ack["dataset_offsets"] = dict(dataset_offsets)
        return {"ckpt_shard": ack}

    def _seal_shard_arena(self, data) -> str | None:
        """Seal the shard as a tagged arena object so a restarted gang can
        restore it over objxfer from a surviving peer instead of shared
        disk. Best-effort: no runtime / store pressure never blocks the
        report (the committed disk shard is the source of truth)."""
        try:
            from ray_tpu_torch.core.config import get_config
            from ray_tpu_torch.core.runtime import current_runtime
            rt = current_runtime()
            if rt is None or not get_config().train_ckpt_arena:
                return None
            put = getattr(rt, "put_tagged", None) or rt.put
            return put(data).hex()
        except Exception:  # noqa: BLE001 — acceleration only, never gates
            return None

    def drain_reports(self) -> list[dict]:
        with self._lock:
            out = self.reports
            self.reports = []
            return out


_session: TrainSession | None = None


def _set_session(s: TrainSession | None):
    global _session
    _session = s


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError("not inside a ray_tpu_torch.train training loop")
    return _session


def report(metrics: dict, checkpoint=None, dataset_offsets: dict | None = None):
    get_session().report(metrics, checkpoint,
                         dataset_offsets=dataset_offsets)


def get_checkpoint():
    return get_session().resume_checkpoint


def get_dataset_shard(name: str = "train"):
    return get_session().dataset_shards.get(name)


def get_dataset_offset(name: str = "train") -> int:
    """Rows of `name` consumed before this (re)start (already skipped in
    the shard this rank received)."""
    return int(get_session().dataset_offsets.get(name, 0))


def get_world_rank() -> int:
    return get_session().rank


def get_world_size() -> int:
    return get_session().world_size


class TrainContext:
    """Parity: ray.train.get_context() (TrainContext in the reference) —
    a read-only view over the worker's session."""

    def get_world_rank(self) -> int:
        return get_world_rank()

    def get_world_size(self) -> int:
        return get_world_size()

    def get_local_rank(self) -> int:
        return get_session().local_rank

    def get_local_world_size(self) -> int:
        return get_session().local_world_size

    def get_trial_dir(self) -> str:
        return get_session().storage_dir


def get_context() -> TrainContext:
    get_session()  # raises outside a training loop
    return TrainContext()
