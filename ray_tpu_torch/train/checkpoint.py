"""Checkpoints: crash-consistent directories under a two-phase manifest,
and train-state save/restore (counterpart of `ray_tpu/train/checkpoint.py`).

The manifest protocol is the JAX package's, copied (it imports no JAX):
- **Two-phase commit.** A checkpoint directory is only valid once it
  carries a `MANIFEST.json`: every rank writes its shard (tmp + fsync +
  rename, so a shard file either exists complete or not at all), and one
  writer commits the manifest (shard list + step + world size + dataset
  offsets) with the same dance, only after every rank's write is durable.
  A crash anywhere in the window leaves either a previous committed
  checkpoint or an uncommitted directory `gc_uncommitted` removes on
  restart; never a torn checkpoint that looks resumable. The two
  packages read each other's manifests (the same JSON fields).
- Shard naming is deterministic (`checkpoint_<step>` /
  `shard_R-of-W.pkl`), so every rank converges on the same directory.

Train state: `save_state` / `restore_state` take the place of the JAX
package's orbax pair. A one-device state (`mesh=None`) is one
`torch.save` file, written atomically. A state placed on a mesh (DTensor
params and moments) goes through `torch.distributed.checkpoint`: every
rank writes its own shards into a directory, without gathering, and
`restore_state` loads into the target's placements, which may be those
of another mesh (an N-way save restored M-way: the elastic re-mesh path).
The counterpart of `abstract_state` is the target itself: a state from
the train step's `init_fn` on the new mesh, whose DTensors carry the
placements to restore into. `save_checkpoint` commits such a directory
under a manifest (with no dict shards, as an orbax directory is
committed), so `latest_committed` only ever points at a whole checkpoint.

The arena path: a rank's report seals its dict shard into the port's
object store too (`train/session.py`), and the manifest records the
object ids. `load_shard` reads that object first under the port's
runtime (a `get` with a 1 s deadline) and the disk shard when there is no
runtime or the object is gone; the disk shard is the source of truth.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from ray_tpu_torch.train.optim import tree_leaves, tree_map

MANIFEST_NAME = "MANIFEST.json"
_CKPT_PREFIX = "checkpoint_"
# The torch.distributed.checkpoint format's metadata file: its presence
# marks a directory as a sharded state.
_DCP_METADATA = ".metadata"


def _fsync_dir(path: str) -> None:
    # Directory fsync publishes the rename itself; ignore filesystems that
    # refuse to fsync a directory fd (the rename is still atomic there).
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp (same dir) + fsync + rename + dir fsync: `path` either holds
    the complete bytes or does not exist — never a torn prefix."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_" + os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())


def shard_name(rank: int, world: int) -> str:
    return f"shard_{rank:05d}-of-{world:05d}.pkl"


def step_dir(storage_dir: str, step: int) -> str:
    """Deterministic per-step directory: all ranks converge on it with no
    coordination."""
    return os.path.join(storage_dir, f"{_CKPT_PREFIX}{int(step):06d}")


def write_shard(data: dict, ckpt_dir: str, rank: int, world: int) -> str:
    """Durably write one rank's state shard; returns the shard file name.
    The shard is complete-or-absent (atomic_write_bytes)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = shard_name(rank, world)
    atomic_write_bytes(os.path.join(ckpt_dir, name),
                       pickle.dumps(data, protocol=5))
    return name


def commit_manifest(ckpt_dir: str, *, step: int, world_size: int,
                    shards: list[str], dataset_offsets: dict | None = None,
                    mesh_shape: dict | None = None,
                    arena: dict | None = None,
                    extra: dict | None = None) -> str:
    """Phase 2: publish the checkpoint. Called by one writer only after
    every rank's shard is durable; the manifest rename is the commit point
    — `latest_committed` may only ever advance to a directory whose
    manifest exists."""
    manifest = {
        "step": int(step),
        "world_size": int(world_size),
        "shards": list(shards),
        "dataset_offsets": dict(dataset_offsets or {}),
        "mesh_shape": dict(mesh_shape or {}),
        # rank -> arena object id hex, as the JAX package writes it (kept
        # for the format; the port restores from disk only)
        "arena": dict(arena or {}),
        "committed_at": time.time(),
    }
    if extra:
        manifest.update(extra)
    atomic_write_json(os.path.join(ckpt_dir, MANIFEST_NAME), manifest)
    return ckpt_dir


def load_manifest(path: str) -> dict | None:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed(path: str) -> bool:
    """Committed = manifest present, or the legacy single-file layout
    (data.pkl — its atomic rename IS that layout's commit point)."""
    return (os.path.exists(os.path.join(path, MANIFEST_NAME))
            or os.path.exists(os.path.join(path, "data.pkl")))


def latest_committed(storage_dir: str) -> str | None:
    """Highest-step committed checkpoint dir under storage_dir, or None."""
    best: tuple[int, str] | None = None
    try:
        names = os.listdir(storage_dir)
    except OSError:
        return None
    for name in names:
        if not name.startswith(_CKPT_PREFIX):
            continue
        path = os.path.join(storage_dir, name)
        if not os.path.isdir(path) or not is_committed(path):
            continue
        m = load_manifest(path)
        step = (m or {}).get("step")
        if step is None:
            # Legacy dir: fall back to the name's step field.
            try:
                step = int(name[len(_CKPT_PREFIX):].split("_")[0])
            except ValueError:
                step = -1
        if best is None or step > best[0]:
            best = (step, path)
    return best[1] if best else None


def gc_uncommitted(storage_dir: str) -> list[str]:
    """Remove checkpoint dirs that never committed (no manifest, no legacy
    data.pkl) — the debris a crash leaves between shard writes and the
    manifest rename. Run at (re)start, when no writer can be mid-flight.
    Returns the removed paths."""
    removed = []
    try:
        names = os.listdir(storage_dir)
    except OSError:
        return removed
    for name in names:
        path = os.path.join(storage_dir, name)
        if not (name.startswith(_CKPT_PREFIX) and os.path.isdir(path)):
            continue
        if not is_committed(path):
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


class Checkpoint:
    """A handle to a checkpoint directory (legacy single-file, dict-shard
    manifest, or a sharded state committed under a manifest)."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_dict(cls, data: dict, storage_dir: str,
                  step: int = 0) -> "Checkpoint":
        """Single-writer convenience: a world-size-1 sharded checkpoint,
        committed on the spot (write shard, then manifest)."""
        path = step_dir(storage_dir, step)
        name = write_shard(data, path, 0, 1)
        commit_manifest(path, step=step, world_size=1, shards=[name])
        return cls(path)

    def manifest(self) -> dict | None:
        return load_manifest(self.path)

    def is_committed(self) -> bool:
        return is_committed(self.path)

    def to_dict(self) -> dict:
        """The rank-0 shard (legacy surface: with one writer — or
        DP-replicated state — this IS the state)."""
        legacy = os.path.join(self.path, "data.pkl")
        if os.path.exists(legacy):
            with open(legacy, "rb") as f:
                return pickle.load(f)
        return self.load_shard(0)

    def load_shard(self, rank: int, world: int | None = None) -> dict:
        """Shard for `rank` under a (possibly different) restore world
        size. An N-way save restored at world M maps rank r to saved
        shard r % N — exact for DP-replicated dict state; a sharded train
        state reshards through `restore_state` instead."""
        m = self.manifest()
        if m is None:
            raise FileNotFoundError(
                f"{self.path} has no committed manifest — uncommitted "
                "checkpoints are not restorable (gc_uncommitted removes "
                "them at restart)")
        n = m["world_size"]
        if not m["shards"]:
            raise FileNotFoundError(
                f"{self.path} committed without dict shards (externally "
                "written state, e.g. a sharded save_state dir) — restore "
                "it with checkpoint.restore_state, not load_shard")
        src = rank % n if n else 0
        data = self._load_shard_arena(m, src)
        if data is not None:
            return data
        with open(os.path.join(self.path, m["shards"][src]), "rb") as f:
            return pickle.load(f)

    def _load_shard_arena(self, manifest: dict, src_rank: int):
        """Best-effort arena restore: the manifest's sealed shard object
        from the port's object store. Any failure (no runtime, the object
        freed or evicted, its owner gone) falls back to the disk shard."""
        hex_id = (manifest.get("arena") or {}).get(str(src_rank))
        if not hex_id:
            return None
        try:
            import ray_tpu_torch
            from ray_tpu_torch.core.ids import ObjectID
            from ray_tpu_torch.core.object_ref import ObjectRef
            from ray_tpu_torch.core.runtime import current_runtime
            if current_runtime() is None:
                return None
            ref = ObjectRef(ObjectID.from_hex(hex_id), _add_ref=False)
            # A short deadline: the common miss is an object freed with its
            # dead owner, and every rank's restore would otherwise wait out
            # a long resolution before the disk read the restart needs.
            return ray_tpu_torch.get(ref, timeout=1)
        except Exception:  # noqa: BLE001 — the disk is the source of truth
            return None

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def __repr__(self):
        return f"Checkpoint({self.path})"


# ---- train state ----


def _is_sharded(state) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tree_leaves(state.params))


def _paths(tree, prefix=""):
    """(key path, leaf) of a nested dict in sorted-key order, the order of
    `tree_leaves` (and so of the optimizer's params)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _flat_state(state) -> dict:
    """A sharded TrainState as one flat dict of tensors: params, both AdamW
    moments (the optimizer's local shards, viewed as DTensors placed as
    their params) and step count of each leaf by its key path, and the
    step."""
    from torch.distributed.tensor import DTensor
    opt = state.opt_state
    out = {"step": state.step}
    for (path, p), loc in zip(_paths(state.params),
                              opt.param_groups[0]["params"], strict=True):
        st = opt.state[loc]
        out[f"params/{path}"] = p
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k}/{path}"] = DTensor.from_local(
                st[k], p.device_mesh, p.placements, run_check=False)
        out[f"adam_step/{path}"] = st["step"]
    return out


def save_state(state, path: str) -> None:
    """Write `state` (a TrainState). One device: the file `path`, created
    atomically with its directory. Sharded (DTensor params): the
    directory `path`, every rank writing its own shards
    (torch.distributed.checkpoint); every rank calls it."""
    path = os.path.abspath(path)
    if _is_sharded(state):
        import torch.distributed.checkpoint as dcp
        with torch.no_grad():
            dcp.save(_flat_state(state), checkpoint_id=path)
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    torch.save({"params": tree_map(lambda t: t.detach(), state.params),
                "opt_state": state.opt_state.state_dict(),
                "step": state.step.detach()}, buf)
    atomic_write_bytes(path, buf.getvalue())


def restore_state(path: str, target):
    """Read a checkpoint into `target`, a TrainState from `init_fn` over
    params of the same tree: params, moments and step are copied into it
    in place, on its devices. A sharded save loads into the target's
    placements, whatever mesh it was saved from. Returns `target`."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, _DCP_METADATA)):
        import torch.distributed.checkpoint as dcp
        if not _is_sharded(target):
            raise ValueError(f"{path} holds a sharded state: restore it into "
                             f"a state placed on a mesh")
        with torch.no_grad():
            dcp.load(_flat_state(target), checkpoint_id=path)
        return target
    blob = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(target.params),
                            tree_leaves(blob["params"]), strict=True):
            dst.copy_(src)
        target.step.copy_(blob["step"])
    # The moments move to each param's device; the per-leaf step counts
    # stay host scalars, as torch's AdamW keeps them.
    target.opt_state.load_state_dict(blob["opt_state"])
    return target


def save_checkpoint(state, storage_dir: str, step: int, mesh=None,
                    dataset_offsets: dict | None = None) -> Checkpoint:
    """Both phases for a sharded state: every rank writes its shards into
    `step_dir(storage_dir, step)` (save_state); after a barrier, rank 0
    commits the manifest (no dict shards: the directory is restored with
    `restore_state`), and a second barrier holds every rank until the
    checkpoint is committed. Every rank calls it."""
    path = step_dir(storage_dir, step)
    save_state(state, path)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized():
        dist.barrier()
    if not dist.is_initialized() or dist.get_rank() == 0:
        shape = {} if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                 tuple(mesh.shape)))
        commit_manifest(path, step=step, world_size=world, shards=[],
                        dataset_offsets=dataset_offsets, mesh_shape=shape,
                        extra={"format": "torch.distributed.checkpoint"})
    if dist.is_initialized():
        dist.barrier()
    return Checkpoint(path)


class CheckpointManager:
    """Keep-top-K checkpoint retention with a metrics index."""

    def __init__(self, storage_dir: str, keep: int = 2,
                 metric: str | None = None, mode: str = "min"):
        self.storage_dir = storage_dir
        self.keep = keep
        self.metric = metric
        self.mode = mode
        self.entries: list[tuple[float, str]] = []
        self.latest_committed_path: str | None = None
        os.makedirs(storage_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: dict | None = None):
        score = 0.0
        if self.metric and metrics and self.metric in metrics:
            score = float(metrics[self.metric])
            if self.mode == "max":
                score = -score
        else:
            score = -time.time()  # newest wins
        if checkpoint.is_committed():
            self.latest_committed_path = checkpoint.path
        # Re-registration (a restart re-commits the step it resumed at)
        # replaces the old entry: duplicate entries would let keep-K
        # evict a path that is still tracked live.
        self.entries = [e for e in self.entries if e[1] != checkpoint.path]
        self.entries.append((score, checkpoint.path))
        self.entries.sort()
        while len(self.entries) > self.keep:
            victim_i = len(self.entries) - 1
            # Never evict the latest COMMITTED checkpoint, even when the
            # keep-K metric scoring ranks it worst: it is the only state a
            # crash right now is provably able to resume from.
            if self.entries[victim_i][1] == self.latest_committed_path:
                victim_i -= 1
            if victim_i < 0:
                break
            _, path = self.entries.pop(victim_i)
            shutil.rmtree(path, ignore_errors=True)
        self._write_index(metrics)

    def _write_index(self, metrics):
        atomic_write_json(os.path.join(self.storage_dir, "index.json"),
                          {"checkpoints": [p for _, p in self.entries],
                           "latest_metrics": metrics})

    def best(self) -> Checkpoint | None:
        return Checkpoint(self.entries[0][1]) if self.entries else None
