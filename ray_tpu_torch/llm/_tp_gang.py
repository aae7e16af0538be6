"""A tensor-parallel LLM replica as a gang of processes in lockstep.

The reference serves a replica with tensor_parallelism = tp as one
process over its first tp chips (`ray_tpu/llm/serve.py`, `_replica_mesh`);
here `join` forms the gang and its `mesh` is that replica mesh.
The port's tp engine is SPMD (`llm/engine.py`): every rank builds the
engine and makes the same calls on it. So a port replica at tp > 1 is tp
processes, one per rank:

- Rank 0 is the serve replica actor. It answers requests and alone holds
  the tokenizer's text, the waiters, the streams and HTTP. In `__init__`
  it starts the tp - 1 followers (`_Follower` actors) in bundles
  1..tp-1 of the replica's placement group (the controller reserved it
  and runs rank 0 in bundle 0), then every rank joins one process group
  (`TorchDistributedConfig.on_worker_start`: nccl when a rank holds a
  whole card, gloo when ranks share one or on the CPU) and builds
  `make_mesh(MeshConfig(tp=tp, fsdp=1))` and the same engine from the
  same seed.
- Rank 0 drives the followers by messages (`Gang.send`) over a gloo
  group of its own (`broadcast_object_list`), separate from the tensor
  group. A follower builds the replica class's own state
  (`cls(llm_config)`, which finds this process's gang through `join`)
  and hands each message to it (`_follow(kind, payload)`), so every rank
  makes the same engine calls in the same order.
- Fate: a failed send or collective marks the gang broken (`Gang.error`)
  and rank 0's health check fails, so the serve controller replaces the
  whole replica; a follower that raises, or whose receive fails (rank 0
  is gone), exits its process. Rank 0 sends at least every HEARTBEAT_S,
  so an idle gang notices a dead rank too. Every collective of a gang
  times out after GANG_TIMEOUT_S.

Without a runtime, a process group of tp ranks made by the caller serves
as well (the tests): rank 0 builds the replica class as usual and the
others call `follow(cls, llm_config)`.
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from ray_tpu_torch.core.status import RayTpuError

GANG_TIMEOUT_S = 60.0   # rendezvous, and every collective of a gang
HEARTBEAT_S = 0.5       # rank 0 sends at least this often

_gang: "Gang | None" = None   # this process's gang (one replica a process)


class GangBroken(RayTpuError):
    """A rank of a tp replica's gang failed; the gang goes on with none."""


class Gang:
    """This process's rank of a replica's gang: its mesh, and the control
    group rank 0 sends its messages on."""

    def __init__(self, rank: int, tp: int, mesh, ctrl, runs=(),
                 followers=()):
        self.rank = rank
        self.tp = tp
        self.mesh = mesh
        self._ctrl = ctrl
        self._runs = list(runs)            # the followers' run() refs
        self._followers = list(followers)  # their actor handles
        self.lock = threading.Lock()       # one message, then its work
        self.error: GangBroken | None = None
        self._last_send = time.monotonic()
        self._stopped = False

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def fail(self, exc: BaseException) -> GangBroken:
        """Mark the gang broken by `exc` (the first cause is kept)."""
        if self.error is None:
            self.error = (exc if isinstance(exc, GangBroken) else GangBroken(
                f"tp gang rank {self.rank}: {type(exc).__name__}: {exc}"))
        return self.error

    def check(self) -> None:
        """Raise GangBroken when the gang is broken or, on rank 0 under
        the runtime, when a follower has exited."""
        if self.error is None and self._runs:
            import ray_tpu_torch
            done, _ = ray_tpu_torch.wait(self._runs,
                                         num_returns=len(self._runs),
                                         timeout=0)
            if done:
                self.fail(RuntimeError(f"{len(done)} follower(s) exited"))
        if self.error is not None:
            raise self.error

    def send(self, kind: str, payload=None) -> None:
        """Rank 0: one message to every follower. The caller holds
        `lock` through the work the message starts, so no other message
        comes between."""
        if self._stopped:
            raise self.fail(RuntimeError("the gang was stopped"))
        if self.error is not None:
            raise self.error
        try:
            dist.broadcast_object_list([(kind, payload)], src=0,
                                       group=self._ctrl)
        except Exception as e:  # noqa: BLE001 — a rank is gone
            raise self.fail(e) from e
        self._last_send = time.monotonic()

    def recv(self):
        """A follower: rank 0's next message, (kind, payload)."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._ctrl)
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.tp
        dist.all_gather_object(out, obj, group=self._ctrl)
        return out

    def gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A CPU tensor [..., h, hd] of this rank's h kv heads -> the full
        [..., h * tp, hd], ranks' heads in rank order (every rank gets
        it). The bytes travel as uint8 (list-form all_gather on the gloo
        control group)."""
        t = t.contiguous()
        if t.numel() == 0:
            shape = list(t.shape)
            shape[-2] *= self.tp
            return t.new_empty(shape)
        raw = t.view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.tp)]
        dist.all_gather(parts, raw, group=self._ctrl)
        return torch.cat([p.view(t.dtype) for p in parts], dim=-2)

    def start_heartbeat(self) -> None:
        """Rank 0: a thread that sends a tick whenever nothing was sent
        for HEARTBEAT_S; it ends when the gang breaks or stops."""
        def beat():
            while not self._stopped and self.error is None:
                time.sleep(HEARTBEAT_S / 2)
                with self.lock:
                    if (self._stopped or time.monotonic() - self._last_send
                            < HEARTBEAT_S):
                        continue
                    try:
                        self.send("tick")
                    except GangBroken:
                        return
        threading.Thread(target=beat, daemon=True,
                         name="tp-gang-heartbeat").start()

    def stop(self) -> None:
        """Rank 0: tell the followers to leave, then let this process's
        gang go (a later replica in the process forms its own)."""
        global _gang
        with self.lock:
            if not self._stopped and self.error is None:
                try:
                    self.send("stop")
                except GangBroken:
                    pass
            self._stopped = True
        if self._followers:
            import ray_tpu_torch
            for f in self._followers:
                try:
                    ray_tpu_torch.kill(f)
                except Exception:  # noqa: BLE001 — already gone
                    pass
        if _gang is self:
            _gang = None


def rank_share(llm_config) -> float:
    """The "GPU" each rank of a replica reserves: the replica's total
    over its ranks."""
    return llm_config.num_gpus_per_replica / llm_config.tensor_parallelism


def rank_bundles(llm_config) -> list:
    """The replica's placement group: one bundle a rank, packed on one
    node, each a CPU for the rank's process and its GPU share."""
    share = rank_share(llm_config)
    bundle = {"CPU": 1.0, **({"GPU": share} if share > 0 else {})}
    return [dict(bundle) for _ in range(llm_config.tensor_parallelism)]


def _form(llm_config, rank: int, tp: int, runs=(), followers=()) -> Gang:
    """Every rank, in the same order: the replica's tp mesh and the gloo
    control group, over the process group the rank has joined."""
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    if dist.get_world_size() != tp or dist.get_rank() != rank:
        raise RuntimeError(
            f"a tp={tp} gang's rank {rank} is in a process group of "
            f"{dist.get_world_size()} ranks as rank {dist.get_rank()}")
    device = "cpu" if llm_config.device == "cpu" else "cuda"
    mesh = make_mesh(MeshConfig(tp=tp, fsdp=1), device=device)
    ctrl = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=GANG_TIMEOUT_S))
    return Gang(rank, tp, mesh, ctrl, runs, followers)


def _join_group(llm_config, rank: int, tp: int, address: str) -> None:
    """Join the gang's process group through the Trainer's backend hook,
    the backend picked from this rank's GPU share (gloo on the CPU)."""
    from ray_tpu_torch.train.backend import (GPUS_PER_WORKER_ENV,
                                             TorchDistributedConfig)
    os.environ[GPUS_PER_WORKER_ENV] = str(rank_share(llm_config))
    TorchDistributedConfig(
        backend="gloo" if llm_config.device == "cpu" else None,
        init_timeout_s=GANG_TIMEOUT_S).on_worker_start(rank, tp, address)


def join(llm_config, cls) -> Gang | None:
    """This replica process's gang (None at tp = 1), formed on first call.
    A follower finds the gang it formed; rank 0 forms it over the
    caller's process group of tp ranks when there is one, else starts
    the followers (`cls` is the replica class they build) in its
    placement group's other bundles and forms it with them."""
    global _gang
    tp = llm_config.tensor_parallelism
    if tp <= 1:
        return None
    if _gang is not None:
        return _gang
    if dist.is_initialized():
        _gang = _form(llm_config, 0, tp)
    else:
        _gang = _start(llm_config, cls, tp)
    _gang.start_heartbeat()
    return _gang


def _start(llm_config, cls, tp: int) -> Gang:
    import ray_tpu_torch
    from ray_tpu_torch.train.backend import rendezvous_address
    from ray_tpu_torch.util.placement_group import \
        get_current_placement_group
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy
    if not ray_tpu_torch.is_initialized():
        raise RuntimeError(
            f"a tensor_parallelism={tp} replica is a gang of {tp} "
            f"processes: it runs under the port's runtime "
            f"(ray_tpu_torch.init, serve.run), or in a process group of "
            f"{tp} ranks whose others call _tp_gang.follow")
    pg = get_current_placement_group()
    if pg is None or pg.bundle_count != tp:
        raise RuntimeError(
            f"a tensor_parallelism={tp} replica runs in a placement group "
            f"of {tp} bundles, one a rank (build_llm_deployment and "
            f"build_disagg_deployment set its placement_group_bundles); "
            f"this one has {pg}")
    address = rendezvous_address()
    share = rank_share(llm_config)
    Follower = ray_tpu_torch.remote(_Follower)
    followers, runs = [], []
    try:
        for r in range(1, tp):
            f = Follower.options(
                num_cpus=1, num_gpus=share,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    pg, r)).remote()
            followers.append(f)
            runs.append(f.run.remote(cls, llm_config, r, tp, address))
        _join_group(llm_config, 0, tp, address)
        return _form(llm_config, 0, tp, runs, followers)
    except BaseException:
        for f in followers:
            try:
                ray_tpu_torch.kill(f)
            except Exception:  # noqa: BLE001 — already gone
                pass
        raise


def follow(cls, llm_config) -> None:
    """A follower over the caller's process group: build the replica
    class's state and apply rank 0's messages until it says stop."""
    global _gang
    _gang = gang = _form(llm_config, dist.get_rank(),
                         llm_config.tensor_parallelism)
    try:
        member = cls(llm_config)
        while True:
            try:
                kind, payload = gang.recv()
            except Exception as e:  # noqa: BLE001 — rank 0 is gone
                raise GangBroken(
                    f"tp gang rank {gang.rank}: rank 0's message did not "
                    f"come ({str(e).splitlines()[0][:200]})") from None
            if kind == "stop":
                return
            if kind != "tick":
                member._follow(kind, payload)
    finally:
        _gang = None


class _Follower:
    """Rank r > 0 of a replica's gang, an actor in bundle r of the
    replica's placement group. `run` lasts as long as the gang: its
    process exits when rank 0 says stop, when its receive fails (rank 0
    is gone) or when it raises, so no follower outlives its rank 0."""

    def run(self, cls, llm_config, rank: int, tp: int, address: str):
        code = 1
        try:
            _join_group(llm_config, rank, tp, address)
            follow(cls, llm_config)
            code = 0
        except GangBroken as e:
            print(e, file=sys.stderr)
        except BaseException:  # noqa: BLE001 — logged, then the exit
            traceback.print_exc()
        finally:
            os._exit(code)
