"""Trainer: controller + worker-group actors running torch train steps.

Counterpart of `ray_tpu/train/trainer.py` (JaxTrainer) on the port's
runtime. Parity: reference Train v2 (`TrainController` FSM
`v2/_internal/execution/controller/controller.py:91`, worker group
`v2/.../worker_group/worker_group.py`, `FailurePolicy`
`failure_handling/failure_policy.py:14`) and the v1 `BackendExecutor`
(`train/_internal/backend_executor.py:73`).

One worker actor per rank. A worker holds `ScalingConfig.gpus_per_worker`
GPUs (the head assigns the device ids; the worker sees them as
CUDA_VISIBLE_DEVICES, so each rank's `cuda:0` is its own card, or a
share of one at a fraction). With `TorchDistributedConfig` the workers
form one torch.distributed group (rank 0 mints the rendezvous address);
the port's meshes (`ray_tpu_torch.parallel.make_mesh`) then build over it,
and the sharded train step runs DP/FSDP/TP inside the step.

Elastic resume: checkpoints are two-phase-committed (train/checkpoint.py
— every rank's durable shard ack, THEN the controller's manifest rename),
`latest_ckpt_path` advances only on committed manifests, and a worker
death restarts the gang at whatever world size the cluster still fits (>=
min_workers), resharding state and re-splitting datasets from the
manifest's recorded offsets. A wedged-not-dead worker is converted into
the same restart by the poll/progress watchdogs instead of stalling the run.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
import traceback
from typing import Any, Callable

import pickle

import ray_tpu_torch
from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.serialization import dumps_code
from ray_tpu_torch.core.status import GetTimeoutError, RayTpuError


def _train_knob(name: str, override=None) -> float:
    """RunConfig override first, then the cluster config knob."""
    if override is not None:
        return override
    from ray_tpu_torch.core.config import get_config
    return getattr(get_config(), name)


@dataclasses.dataclass
class ScalingConfig:
    """Parity: ray.train.ScalingConfig (air/config.py)."""

    num_workers: int = 1          # = ranks of the gang
    use_gpu: bool = False
    resources_per_worker: dict | None = None
    # GPUs a worker holds when use_gpu: a fraction shares a card (two
    # ranks at 0.5 on one), 0 = all GPUs of the host
    gpus_per_worker: float = 0
    # Elastic lower bound (parity: Train v2 ScalingPolicy,
    # scaling_policy.py:29): None = fixed size; set to let a run start (or
    # RESTART after failures/preemptions) with however many workers
    # currently fit the cluster, down to this floor. Preemptible fleets
    # make resuming smaller beat not resuming.
    min_workers: int | None = None


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: str = "train_run"
    storage_path: str | None = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_keep: int = 2
    # Per-run overrides for the train_* config knobs (None = knob value):
    # one poll round-trip deadline, the no-progress gang watchdog, and the
    # restart capacity-settle wait.
    poll_timeout_s: float | None = None
    progress_timeout_s: float | None = None
    restart_wait_s: float | None = None


@dataclasses.dataclass
class Result:
    """Parity: ray.air.Result."""

    metrics: dict
    checkpoint: Any
    path: str
    error: BaseException | None = None
    metrics_history: list = dataclasses.field(default_factory=list)


class TrainWorker:
    """Actor hosting the user training loop (one per host)."""

    def __init__(self, rank: int, world_size: int, storage_dir: str,
                 coordinator: str | None, env: dict,
                 backend_bytes: bytes | None = None):
        os.environ.update(env)
        self.rank = rank
        self.world_size = world_size
        self.storage_dir = storage_dir
        self.coordinator = coordinator
        self._thread = None
        self._session = None
        self.local_rank = 0
        self.local_world_size = 1
        self._backend = None
        if backend_bytes is not None:
            self._backend = pickle.loads(backend_bytes)

    def get_address(self) -> str:
        """Rendezvous address minted on THIS worker's host (rank 0 binds
        it): the loopback, as the port's runtime spans one host (a
        multi-node gang needs the interface other hosts reach, with the
        multi-node slice)."""
        import socket
        ip = "127.0.0.1"
        # Probe-bind BELOW the kernel's ephemeral floor: bind(0) mints a
        # port from the ephemeral range (net.ipv4.ip_local_port_range,
        # 32768+ by default), which any unrelated outgoing connection can
        # grab in the close -> torch-rebind window — the EADDRINUSE flake
        # on a busy host. A sub-ephemeral port can only lose a race to
        # another deliberate binder, and the pid-spread start keeps
        # concurrent gangs on disjoint probes.
        bind_ip = ip
        base, span = 20000, 8000
        start = (os.getpid() * 97) % span
        for off in range(512):
            port = base + (start + off) % span
            s = socket.socket()
            try:
                s.bind((bind_ip, port))
            except OSError:
                s.close()
                continue
            s.close()
            return f"{ip}:{port}"
        s = socket.socket()  # range exhausted (pathological): old path
        s.bind((bind_ip, 0))
        port = s.getsockname()[1]
        s.close()
        return f"{ip}:{port}"

    def get_node_id(self) -> str:
        import ray_tpu_torch
        return ray_tpu_torch.get_node_id()

    def set_local_rank(self, local_rank: int, local_world_size: int):
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        return True

    def setup_distributed(self, coordinator: str | None = None):
        """Join the gang via the framework Backend hook (the torch
        process group of TorchDistributedConfig / TorchConfig); no-op
        without one."""
        if coordinator is not None:
            self.coordinator = coordinator
        if self._backend is not None:
            self._backend.on_worker_start(self.rank, self.world_size,
                                          self.coordinator)
        return self.rank

    def run(self, loop_fn_bytes: bytes, loop_config: dict,
            checkpoint_path: str | None, dataset_shards: dict | None = None,
            dataset_offsets: dict | None = None):
        from ray_tpu_torch.train import session as session_mod
        from ray_tpu_torch.train.checkpoint import Checkpoint
        loop_fn = pickle.loads(loop_fn_bytes)
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        self._session = session_mod.TrainSession(
            self.rank, self.world_size, self.storage_dir, checkpoint=ckpt,
            dataset_shards=dataset_shards, local_rank=self.local_rank,
            local_world_size=self.local_world_size,
            dataset_offsets=dataset_offsets)
        session_mod._set_session(self._session)

        def target():
            try:
                loop_fn(loop_config)
            except BaseException as e:  # noqa: BLE001 — ship to controller
                self._session.error = e
                self._session.reports.append(
                    {"error": traceback.format_exc(), "rank": self.rank})
            finally:
                self._session.finished = True

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def poll(self):
        """Controller heartbeat: (reports, finished, error_str)."""
        if chaos.site("train.poll_hang"):
            # Wedged-not-dead: the actor thread hangs without the process
            # dying — the shape a stuck collective / NFS stall takes. The
            # controller's poll deadline must convert this into a restart.
            time.sleep(3600)
        s = self._session
        if s is None:
            return [], False, None
        # Read finished BEFORE draining: the loop thread appends its final
        # report before setting finished, so this order can't lose it.
        finished = s.finished
        reports = s.drain_reports()
        err = None
        if s.error is not None:
            err = repr(s.error)
        return reports, finished, err

    def latest_checkpoint_path(self):
        s = self._session
        if s and s.latest_checkpoint:
            return s.latest_checkpoint.path
        return None

    def shutdown(self):
        if self._backend is not None:
            try:
                self._backend.on_worker_shutdown()
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass
        return True


# controller states (parity: TrainControllerState in v2 controller.py)
INIT, RUNNING, RESTARTING, FINISHED, ERRORED = (
    "INITIALIZING", "RUNNING", "RESTARTING", "FINISHED", "ERRORED")


class _PendingCommit:
    """Phase-2 state for one (dir, step): which ranks acked a durable
    shard, plus the manifest payload accumulated from the acks."""

    __slots__ = ("step", "world", "acks", "shards", "arena", "offsets")

    def __init__(self, step: int, world: int):
        self.step = step
        self.world = world
        self.acks: set[int] = set()
        self.shards: dict[int, str] = {}
        self.arena: dict[str, str] = {}
        self.offsets: dict = {}


class Trainer:
    """Parity: TorchTrainer (`train/torch/torch_trainer.py:11`) +
    DataParallelTrainer (`data_parallel_trainer.py:26`); the counterpart
    of the JAX package's JaxTrainer."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 resume_from_checkpoint=None,
                 torch_config=None):
        self.train_loop = train_loop_per_worker
        self.loop_config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        # Framework Backend: pass torch_config=TorchDistributedConfig()
        # for one torch.distributed group over the workers.
        self.backend = torch_config
        self.state = INIT

    def _storage_dir(self) -> str:
        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_train")
        path = os.path.join(base, self.run_config.name)
        os.makedirs(path, exist_ok=True)
        return path

    def _per_worker_req(self) -> dict:
        """Every resource one worker consumes (custom resources included) —
        the ONE definition sizing and group creation both use."""
        res = dict(self.scaling.resources_per_worker or {})
        req = dict(res)
        req["CPU"] = res.get("CPU", 1)
        gpus = res.get("GPU", self.scaling.gpus_per_worker
                       if self.scaling.use_gpu else 0)
        if self.scaling.use_gpu and not gpus:   # 0 = all GPUs of the host
            gpus = max((row["resources"].get("GPU", 0.0)
                        for row in ray_tpu_torch.nodes() if row["alive"]),
                       default=0.0)
            if not gpus:
                raise RayTpuError("ScalingConfig(use_gpu=True) but no node "
                                  "of the cluster has a GPU")
        if gpus:
            req["GPU"] = gpus
        else:
            req.pop("GPU", None)
        return req

    def _fit_now(self) -> int:
        """Workers placeable RIGHT NOW, summed per node (aggregate totals
        would mis-fit fragmented clusters: 4+4 free GPUs cannot host an
        8-GPU worker)."""
        req = {k: v for k, v in self._per_worker_req().items() if v > 0}
        if not req:
            # Zero-resource workers (co-location pattern): nothing bounds
            # placement, so the full requested size always fits.
            return self.scaling.num_workers
        total = 0
        for row in ray_tpu_torch.nodes():
            if not row["alive"]:
                continue
            avail = row["available"]
            total += min(int(avail.get(k, 0.0) // v)
                         for k, v in req.items())
        return total

    def _elastic_size(self, wait_s: float = 0.0) -> int:
        """Workers for this (re)start: fixed, or fitted to what the cluster
        offers (elastic ScalingPolicy). On restarts the previous gang's
        kills release resources asynchronously — wait for capacity to
        settle (through the shared backoff policy, not a hot 100ms poll)
        instead of snapshotting mid-teardown and shrinking to the floor
        for no reason."""
        from ray_tpu_torch.core.retry import Backoff
        n = self.scaling.num_workers
        lo = self.scaling.min_workers
        if lo is None:
            return n
        best = self._fit_now()
        if best < n:
            # Capacity-wait is the autoscaler's scale-UP signal (the
            # counterpart to the shrink loop): post the missing workers'
            # bundles so the policy core can launch slice-shaped nodes
            # while we wait.
            self._request_scale_up(n - best)
        if wait_s > 0:
            bo = Backoff(deadline_s=wait_s)
            while best < n and bo.sleep():
                best = max(best, self._fit_now())
        if best < lo:
            from ray_tpu_torch.core.status import ResourceError
            raise ResourceError(
                f"elastic run needs at least min_workers={lo} x "
                f"{self._per_worker_req()} but the cluster currently fits "
                f"{best} (fail-fast beats burning the failure budget on "
                f"placement timeouts)")
        return min(best, n)

    def _request_scale_up(self, missing: int) -> None:
        """Post `missing` per-worker bundles to the head's scale-request
        queue (drained by autoscaler/policy.py). Works from the driver
        (direct Runtime call) and from workers (head request); a
        pre-autoscaler head just ignores it."""
        req = {k: v for k, v in self._per_worker_req().items() if v > 0}
        if not req:
            return
        bundles = [dict(req) for _ in range(max(1, int(missing)))]
        try:
            from ray_tpu_torch.core.runtime import Runtime, get_runtime
            rt = get_runtime()
            if isinstance(rt, Runtime):
                rt.request_scale_up(bundles, source="train.capacity_wait")
            else:
                rt.request("scale_up", (bundles, "train.capacity_wait"),
                           timeout=10.0)
        except Exception:  # noqa: BLE001 — a hint, never a failure
            pass

    def _make_group(self, storage_dir: str, n: int):
        from ray_tpu_torch.train.backend import GPUS_PER_WORKER_ENV
        req = self._per_worker_req()
        num_cpus = req.get("CPU", 1)
        num_gpus = req.get("GPU", 0)
        custom = {k: v for k, v in req.items() if k not in ("CPU", "GPU")}
        env = {GPUS_PER_WORKER_ENV: str(num_gpus)}
        backend_bytes = None
        needs_coordinator = n > 1 and (
            getattr(self.backend, "needs_coordinator", False))
        if self.backend is not None:
            backend_bytes = dumps_code(self.backend)
        WorkerCls = ray_tpu_torch.remote(TrainWorker).options(
            num_cpus=num_cpus, num_gpus=num_gpus,
            resources=custom or None)
        workers = [
            WorkerCls.remote(rank=i, world_size=n, storage_dir=storage_dir,
                             coordinator=None, env=env,
                             backend_bytes=backend_bytes)
            for i in range(n)
        ]
        try:
            # Local ranks: position of each worker among the workers
            # co-located on its node (torch-style LOCAL_RANK semantics).
            node_ids = ray_tpu_torch.get(
                [w.get_node_id.remote() for w in workers], timeout=60)
            per_node: dict = {}
            assignments = []
            for nid in node_ids:
                assignments.append(per_node.get(nid, 0))
                per_node[nid] = per_node.get(nid, 0) + 1
            ray_tpu_torch.get(
                [w.set_local_rank.remote(assignments[i],
                                         per_node[node_ids[i]])
                 for i, w in enumerate(workers)], timeout=60)
            coordinator = None
            if needs_coordinator:
                # Rank 0 mints the rendezvous address on ITS node — it is
                # the process that binds it.
                coordinator = ray_tpu_torch.get(
                    workers[0].get_address.remote(), timeout=60)
            # Gang rendezvous (SPMD impedance, SURVEY §7 hard-part 3).
            ray_tpu_torch.get([w.setup_distributed.remote(coordinator)
                         for w in workers], timeout=300)
        except BaseException:
            # A partial gang must not leak: surviving actors would hold
            # their reservations forever and starve every retry.
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001
                    pass
            raise
        return workers

    def _resume_path(self, latest_ckpt_path: str | None) -> str | None:
        """The path the NEXT gang resumes from: committed manifests only.
        An uncommitted or torn directory (possible only for caller-supplied
        resume_from_checkpoint — in-run paths advance on commit) is refused
        loudly: resuming from state that merely LOOKS complete is the bug
        this plane exists to kill."""
        if latest_ckpt_path is None:
            return None
        from ray_tpu_torch.train import checkpoint as ckpt_mod
        if not ckpt_mod.is_committed(latest_ckpt_path):
            raise RayTpuError(
                f"checkpoint {latest_ckpt_path} has no committed manifest "
                "(torn or abandoned write); refusing to resume from it")
        return latest_ckpt_path

    def fit(self) -> Result:
        from ray_tpu_torch.train import checkpoint as ckpt_mod
        storage_dir = self._storage_dir()
        _register_run(self)
        loop_bytes = dumps_code(self.train_loop)
        failures_left = self.run_config.failure_config.max_failures
        resume_path = (self.resume_from_checkpoint.path
                       if self.resume_from_checkpoint else None)
        history: list[dict] = []
        latest_metrics: dict = {}
        # Held on self, not a local: _poll_until_done commits checkpoints
        # as acks arrive and may then RAISE on a worker death — a local
        # would forget every commit of the crashed attempt and restart
        # the run from scratch instead of the last committed step.
        self._latest_committed = self._resume_path(resume_path)
        self._ckpt_mgr = ckpt_mod.CheckpointManager(
            storage_dir, keep=self.run_config.checkpoint_keep)

        first_start = True
        while True:
            self.state = RUNNING
            # A crashed attempt's debris (shards written, manifest never
            # committed) must not survive into this attempt: no writer can
            # be mid-flight here, so uncommitted dirs are garbage.
            ckpt_mod.gc_uncommitted(storage_dir)
            try:
                # Restarts wait for the previous gang's resources to
                # release first.
                n = self._elastic_size(
                    wait_s=0.0 if first_start else _train_knob(
                        "train_restart_wait_s",
                        self.run_config.restart_wait_s))
            except RayTpuError as e:
                if first_start:
                    raise  # misconfigured from the start: surface raw
                # Below the elastic floor on a RESTART: end the run with
                # the normal Result contract (error + last checkpoint +
                # history) instead of leaking a raw exception.
                self.state = ERRORED
                _finalize_run(self)
                from ray_tpu_torch.train.checkpoint import Checkpoint
                return Result(
                    metrics=latest_metrics,
                    checkpoint=Checkpoint(self._latest_committed)
                    if self._latest_committed else None,
                    path=storage_dir, error=e, metrics_history=history)
            first_start = False
            error = None
            workers = []
            try:
                # Group setup and gang start can also lose a worker (crash
                # in the first steps races the start RPC; a shrunk cluster
                # can kill placement) — all of it is FailurePolicy territory.
                workers = self._make_group(storage_dir, n)
                shards, offsets = self._split_datasets(
                    n, self._latest_committed)
                ray_tpu_torch.get([
                    w.run.remote(loop_bytes, self.loop_config,
                                 self._latest_committed, shards[i], offsets)
                    for i, w in enumerate(workers)], timeout=300)
            except _WorkerGroupError as e:
                error = e
            except ray_tpu_torch.RayTpuError as e:
                error = _WorkerGroupError(f"worker group start failed: {e}")
            try:
                if error is not None:
                    raise error
                # _poll_until_done appends into `history` in place, so
                # reports from an attempt that later crashes still reach
                # the Result (and the dashboard).
                latest_metrics = self._poll_until_done(workers, history)
                self.state = FINISHED
            except _WorkerGroupError as e:
                error = e
            # Backend teardown hook (best effort, bounded), then hard kill.
            # A HUNG group gets no grace (its poll already ate the poll
            # deadline once), and an already-broken group gets one second,
            # not five: restart latency is the recovery metric.
            if workers and not isinstance(error, _WorkerGroupHung):
                try:
                    ray_tpu_torch.get([w.shutdown.remote() for w in workers],
                                timeout=5 if error is None else 1)
                except Exception:  # noqa: BLE001 — wedged workers
                    pass
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass
            if error is None:
                break
            # FailurePolicy: restart the whole gang from the last
            # COMMITTED checkpoint (latest_ckpt_path only ever advances on
            # manifest commits).
            if failures_left > 0:
                failures_left -= 1
                self.state = RESTARTING
                _finalize_run(self)
                continue
            self.state = ERRORED
            _finalize_run(self)
            from ray_tpu_torch.train.checkpoint import Checkpoint
            return Result(metrics=latest_metrics,
                          checkpoint=Checkpoint(self._latest_committed)
                          if self._latest_committed else None,
                          path=storage_dir, error=error,
                          metrics_history=history)

        _finalize_run(self)
        from ray_tpu_torch.train.checkpoint import Checkpoint
        return Result(
            metrics=latest_metrics,
            checkpoint=Checkpoint(self._latest_committed)
            if self._latest_committed else None,
            path=storage_dir, metrics_history=history)

    def _split_datasets(self, n: int, latest_ckpt_path: str | None = None):
        """Per-worker dataset shards (parity: get_dataset_shard/
        streaming_split). Equal-row shards: lockstep SPMD loops need
        identical iteration counts per rank (streaming_split(equal=True)
        semantics — a ragged shard would hang a collective at epoch end).

        Elastic resume: the committed manifest records per-dataset row
        offsets (reported by rank 0 alongside its checkpoint); rows before
        the offset were consumed pre-crash, so the new gang — possibly a
        different world size — re-splits only the remainder."""
        offsets: dict = {}
        if latest_ckpt_path:
            from ray_tpu_torch.train import checkpoint as ckpt_mod
            m = ckpt_mod.load_manifest(latest_ckpt_path)
            offsets = dict((m or {}).get("dataset_offsets") or {})
        shards = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            off = int(offsets.get(name, 0))
            if off > 0 and hasattr(ds, "split_at_indices"):
                ds = ds.split_at_indices([off])[1]
            if hasattr(ds, "split"):
                parts = ds.split(n, equal=True)
            else:
                parts = [ds] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards, offsets

    def _commit_if_ready(self, pending: "_PendingCommit", ckpt_dir: str,
                         latest_metrics: dict) -> bool:
        """Phase 2: all ranks acked durable shards -> rename the manifest
        in. Returns True when the checkpoint committed (the ONLY event
        that advances latest_ckpt_path)."""
        from ray_tpu_torch.train import checkpoint as ckpt_mod
        if len(pending.acks) < pending.world:
            return False
        if chaos.site("train.manifest_loss"):
            # Controller crash window: every shard is durable but the
            # manifest rename never happens — the step must be invisible
            # to restarts (gc'd), and resume comes from the previous one.
            return False
        # The manifest's shard list is indexed BY RANK — it is either
        # complete (every rank wrote a dict shard) or empty (externally
        # written state, e.g. an orbax dir); a partial list would silently
        # remap ranks onto wrong shards.
        shards = [pending.shards.get(r) for r in range(pending.world)]
        if any(s is None for s in shards):
            shards = []
        try:
            ckpt_mod.commit_manifest(
                ckpt_dir, step=pending.step, world_size=pending.world,
                shards=shards,
                dataset_offsets=pending.offsets, arena=pending.arena)
        except FileNotFoundError:
            # The dir vanished between the acks and the commit (a restart
            # re-running an old step can race keep-K eviction of its own
            # dir). The checkpoint is gone: it must NOT become latest —
            # same outcome as a lost manifest, and just as survivable.
            return False
        self._ckpt_mgr.register(ckpt_mod.Checkpoint(ckpt_dir),
                                latest_metrics or None)
        return True

    def _poll_until_done(self, workers, history: list):
        poll_timeout = _train_knob("train_poll_timeout_s",
                                   self.run_config.poll_timeout_s)
        progress_timeout = _train_knob("train_progress_timeout_s",
                                       self.run_config.progress_timeout_s)
        latest = {}
        done = [False] * len(workers)
        pending: dict[str, _PendingCommit] = {}
        last_progress = time.monotonic()
        while not all(done):
            time.sleep(0.05)
            refs = [w.poll.remote() for w in workers]
            polls = []
            group_error = None
            for ref in refs:
                # Per-ref resolution: one dead rank must not discard the
                # SURVIVORS' drained reports for this round — their shard
                # acks may complete a commit the restart then resumes
                # from, instead of re-running work that was already done.
                try:
                    polls.append(ray_tpu_torch.get(
                        ref, timeout=max(poll_timeout, 0.001)))
                except GetTimeoutError as e:
                    # Wedged-not-dead: the worker process answers liveness
                    # but its poll never returns (hung collective, stuck
                    # I/O). Without this deadline the run stalls for the
                    # full get timeout on EVERY poll round; with it, the
                    # FailurePolicy restarts from the committed manifest.
                    raise _WorkerGroupHung(
                        f"worker group hung: poll() exceeded "
                        f"train_poll_timeout_s={poll_timeout}s: {e}") from e
                except ray_tpu_torch.RayTpuError as e:
                    # A hard-crashed worker (OOM kill, preempted host,
                    # os._exit) dies as an actor, not as an error report —
                    # still a worker-group failure the FailurePolicy must
                    # see, AFTER the survivors' rounds are processed.
                    polls.append(([], False, None))
                    if group_error is None:
                        group_error = _WorkerGroupError(
                            f"worker actor died: {e}")
            progressed = False
            for i, (reports, finished, err) in enumerate(polls):
                for r in reports:
                    progressed = True
                    if "error" in r:
                        raise _WorkerGroupError(
                            f"worker {i} failed:\n{r['error']}")
                    if r["rank"] == 0:
                        latest = r["metrics"]
                        history.append(r["metrics"])
                        _update_run(self, latest, len(history))
                    ack = r.get("ckpt_shard")
                    if ack:
                        ckpt_dir = ack["dir"]
                        pc = pending.get(ckpt_dir)
                        if pc is None:
                            pc = pending[ckpt_dir] = _PendingCommit(
                                ack["step"], ack["world"])
                        pc.acks.add(ack["rank"])
                        if ack.get("shard"):
                            pc.shards[ack["rank"]] = ack["shard"]
                        if ack.get("arena"):
                            pc.arena[str(ack["rank"])] = ack["arena"]
                        if ack.get("dataset_offsets"):
                            pc.offsets = ack["dataset_offsets"]
                        if self._commit_if_ready(pc, ckpt_dir, latest):
                            self._latest_committed = ckpt_dir
                            pending.pop(ckpt_dir, None)
                if err and not any("error" in r for r in reports):
                    raise _WorkerGroupError(f"worker {i} failed: {err}")
                if finished and not done[i]:
                    progressed = True
                done[i] = finished
            if group_error is not None:
                raise group_error
            now = time.monotonic()
            if progressed:
                last_progress = now
            elif (progress_timeout and progress_timeout > 0
                    and now - last_progress > progress_timeout):
                # Polls answer but NOTHING moves: no reports, no finishes.
                # The per-step progress deadline turns the wedge into a
                # FailurePolicy restart instead of an unbounded stall.
                raise _WorkerGroupHung(
                    "worker group hung: no rank reported progress for "
                    f"train_progress_timeout_s={progress_timeout}s")
        return latest


# ---- train-run registry (feeds the dashboard's Train page; parity:
# dashboard/modules/train state aggregation) ----

_TRAIN_RUNS: dict[str, dict] = {}


def _register_run(trainer):
    _TRAIN_RUNS[trainer.run_config.name] = {
        "name": trainer.run_config.name,
        "num_workers": trainer.scaling.num_workers,
        "state": "RUNNING",
        "started": time.time(),
        "iterations": 0,
        "latest_metrics": {},
    }


def _update_run(trainer, metrics: dict, iterations: int):
    run = _TRAIN_RUNS.get(trainer.run_config.name)
    if run is not None:
        run["state"] = str(trainer.state)
        run["iterations"] = iterations
        run["latest_metrics"] = {
            k: v for k, v in metrics.items()
            if isinstance(v, (int, float, str, bool))}


def _finalize_run(trainer):
    run = _TRAIN_RUNS.get(trainer.run_config.name)
    if run is not None:
        run["state"] = str(trainer.state)


def list_train_runs() -> list[dict]:
    """Dashboard/state surface: every run fit() in this driver process,
    newest first, with live state + rank-0's latest reported metrics."""
    out = []
    for run in _TRAIN_RUNS.values():
        t = dict(run)
        out.append(t)
    out.sort(key=lambda r: -r["started"])
    return out


class _WorkerGroupError(RayTpuError):
    pass


class _WorkerGroupHung(_WorkerGroupError):
    """A group declared hung by the poll/progress watchdogs — restartable
    like any group failure, but skipped for graceful-shutdown grace."""
