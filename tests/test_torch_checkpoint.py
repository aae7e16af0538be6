"""PyTorch port, checkpoints: the two-phase manifest protocol against the
JAX package's (each reads the other's manifests and shards), keep-K
retention, and a sharded train state saved through
torch.distributed.checkpoint at fsdp=2 and restored on other meshes.

The sharded case runs in a 2-rank gloo process group on the CPU
(`tests/test_torch_dist_workers.py`): 2 steps at fsdp=2, a committed
checkpoint, the uninterrupted run's next loss; then the same processes
restore it at tp=2, and rank 0 alone restores it at world 1; each
restored state's next loss must equal the uninterrupted one."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from ray_tpu.models import configs as j_configs
from ray_tpu.models import init_params as j_init_params
from ray_tpu.train import checkpoint as j_ckpt
from ray_tpu_torch.models import configs
from ray_tpu_torch.train import checkpoint as t_ckpt
from tests import test_torch_dist_workers as workers


def _shard(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "step": np.int64(seed), "nested": {"b": np.arange(5)}}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_cross_between_the_packages(tmp_path, writer):
    """A world-2 checkpoint of dict shards (write_shard per rank, then
    commit_manifest) written by one package is read by the other's
    load_manifest / latest_committed / Checkpoint with the same fields,
    and the shards load back equal."""
    w, r = (t_ckpt, j_ckpt) if writer == "port" else (j_ckpt, t_ckpt)
    storage = str(tmp_path)
    for step in (3, 7):
        path = w.step_dir(storage, step)
        names = [w.write_shard(_shard(step * 10 + rank), path, rank, 2)
                 for rank in range(2)]
        assert names == [r.shard_name(rank, 2) for rank in range(2)]
        w.commit_manifest(path, step=step, world_size=2, shards=names,
                          dataset_offsets={"train": step},
                          mesh_shape={"fsdp": 2})
    latest = r.latest_committed(storage)
    assert latest == w.latest_committed(storage) == w.step_dir(storage, 7)
    got, want = r.load_manifest(latest), w.load_manifest(latest)
    assert got == want
    assert set(got) == {"step", "world_size", "shards", "dataset_offsets",
                        "mesh_shape", "arena", "committed_at"}
    assert got["step"] == 7 and got["world_size"] == 2
    for rank in range(2):
        _same(r.Checkpoint(latest).load_shard(rank), _shard(70 + rank))
    _same(r.Checkpoint(latest).load_shard(3, world=4), _shard(71))
    single = w.Checkpoint.from_dict(_shard(1), storage, step=9)
    _same(r.Checkpoint(single.path).to_dict(), _shard(1))
    assert r.latest_committed(storage) == single.path


def test_gc_uncommitted_removes_only_debris(tmp_path):
    """A step directory with shards but no manifest is invisible to
    latest_committed and is what gc_uncommitted removes; committed and
    legacy (data.pkl) directories stay."""
    storage = str(tmp_path)
    done = t_ckpt.Checkpoint.from_dict(_shard(1), storage, step=1)
    legacy = t_ckpt.step_dir(storage, 2)
    os.makedirs(legacy)
    t_ckpt.atomic_write_bytes(os.path.join(legacy, "data.pkl"), b"x")
    torn = t_ckpt.step_dir(storage, 5)
    t_ckpt.write_shard(_shard(5), torn, 0, 2)
    assert not t_ckpt.is_committed(torn)
    assert t_ckpt.latest_committed(storage) == legacy
    assert t_ckpt.gc_uncommitted(storage) == [torn]
    assert sorted(os.listdir(storage)) == sorted(
        os.path.basename(p) for p in (done.path, legacy))
    with pytest.raises(FileNotFoundError, match="no committed manifest"):
        t_ckpt.Checkpoint(torn).load_shard(0)


def test_checkpoint_manager_keeps_k_and_the_latest_committed(tmp_path):
    """keep=2 by a metric: the worst goes, re-registration replaces its
    entry, and the latest committed checkpoint is never evicted even when
    it scores worst; the index lists the kept paths (as the JAX
    package's manager does on the same sequence)."""
    def run(mod, storage):
        mgr = mod.CheckpointManager(storage, keep=2, metric="loss")
        for step, loss in ((1, 0.5), (2, 0.3), (3, 0.9), (3, 0.9), (4, 0.2)):
            mgr.register(mod.Checkpoint.from_dict(_shard(step), storage,
                                                  step=step),
                         {"loss": loss})
        return mgr, sorted(os.listdir(storage))
    mgr, kept = run(t_ckpt, str(tmp_path / "port"))
    _jmgr, jkept = run(j_ckpt, str(tmp_path / "jax"))
    assert kept == jkept
    assert [os.path.basename(p) for _, p in mgr.entries] == [
        "checkpoint_000004", "checkpoint_000002"]
    assert mgr.best().path.endswith("checkpoint_000004")


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    storage = str(tmp_path_factory.mktemp("sharded"))
    w = jax.tree.map(np.asarray, j_init_params(j_configs.tiny(),
                                               jax.random.PRNGKey(31)))
    rng = np.random.default_rng(32)
    batch = {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32)}
    res = workers.run_group(
        workers.checkpoint_roundtrip, 2, dataclasses.asdict(configs.tiny()),
        w, batch, 1e-3, storage, timeout=150)
    return storage, res


def test_sharded_save_restores_on_other_meshes(roundtrip):
    """The fsdp=2 save, restored into a fresh state at tp=2 and at world
    1, takes the uninterrupted run's next two steps: the same losses within
    1e-6 (fp32; another mesh sums over other shards; the second loss
    follows an update by the restored moments). The manifest commits the
    torch.distributed.checkpoint directory with no dict shards, as the JAX
    package commits an orbax directory, and both packages' readers find
    it."""
    storage, res = roundtrip
    want = res[0]["uninterrupted"]
    assert len(want) == 2 and want[1] < want[0]
    for r in res:
        assert r["uninterrupted"] == pytest.approx(want, rel=1e-7)
        assert r["restored_step"] == 2
        assert r["tp"] == pytest.approx(want, rel=1e-6)
    assert res[0]["world1"] == pytest.approx(want, rel=1e-6)
    m = res[0]["manifest"]
    assert m["step"] == 2 and m["world_size"] == 2 and m["shards"] == []
    assert m["mesh_shape"]["fsdp"] == 2
    assert m["format"] == "torch.distributed.checkpoint"
    path = t_ckpt.step_dir(storage, 2)
    assert res[0]["latest"] == path
    assert j_ckpt.latest_committed(storage) == path
    assert j_ckpt.load_manifest(path)["shards"] == []
    with pytest.raises(FileNotFoundError, match="restore_state"):
        t_ckpt.Checkpoint(path).load_shard(0)


def test_uncommitted_sharded_dir_is_left_then_collected(roundtrip):
    """A later step's directory written without its manifest (a crash
    between the shard writes and the commit) is never latest; it stays
    until gc_uncommitted removes it, and the committed one remains."""
    storage, _ = roundtrip
    torn = t_ckpt.step_dir(storage, 3)
    t_ckpt.write_shard({"partial": np.zeros(2)}, torn, 0, 2)
    assert os.path.isdir(torn)
    assert t_ckpt.latest_committed(storage) == t_ckpt.step_dir(storage, 2)
    assert t_ckpt.gc_uncommitted(storage) == [torn]
    assert not os.path.exists(torn)
    assert t_ckpt.latest_committed(storage) == t_ckpt.step_dir(storage, 2)
