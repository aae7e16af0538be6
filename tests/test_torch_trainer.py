"""PyTorch port, the Trainer (`ray_tpu_torch.train.trainer`, the port's
copy of `ray_tpu/train/trainer.py` on its own runtime), on the CPU.

The JAX package's `tests/test_train.py` cases on the port's Trainer (fit,
reports and checkpoints; a failure restart from the committed manifest;
local ranks; TorchTrainer single and DDP), and the port's train step
through the Trainer against the JAX package's `make_train_step` on the
same params: one worker, and a two-rank gang at fsdp = 2 under
TorchDistributedConfig (gloo). Loops and the functions workers run live
in `tests/test_torch_dist_workers.py` (torch and ray_tpu_torch only)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import ray_tpu_torch as rt
from ray_tpu.models import configs as j_configs
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models import loss_fn as j_loss_fn
from ray_tpu.models import param_logical_axes as j_param_logical_axes
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu_torch.models import configs
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchDistributedConfig, Trainer)
from tests import test_torch_dist_workers as W


@pytest.fixture(scope="module")
def port_rt():
    """One port runtime for the module (4 CPUs, a 128 MiB arena)."""
    rt.init(num_cpus=4, object_store_memory=128 << 20)
    yield rt
    rt.shutdown()


def simple_loop(config):
    from ray_tpu_torch.train import session
    for step in range(config["steps"]):
        session.report({"step": step,
                        "rank": session.get_world_rank(),
                        "world_size": session.get_world_size()},
                       checkpoint={"step": step})


def flaky_loop(config):
    from ray_tpu_torch.train import session
    ckpt = session.get_checkpoint()
    start = (ckpt.to_dict()["step"] + 1) if ckpt else 0
    marker = os.path.join(config["marker_dir"], "crashed_once")
    for step in range(start, config["steps"]):
        session.report({"step": step}, checkpoint={"step": step})
        if step == 2 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)  # hard crash mid-run


def local_rank_loop(config):
    from ray_tpu_torch import train
    ctx = train.get_context()
    train.report({"rank": ctx.get_world_rank(),
                  "local_rank": ctx.get_local_rank(),
                  "local_world": ctx.get_local_world_size()})


def test_fit_reports_and_checkpoints(port_rt, tmp_path):
    result = Trainer(
        simple_loop, train_loop_config={"steps": 4},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="basic", storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert result.metrics["world_size"] == 2
    assert result.checkpoint is not None
    assert result.checkpoint.is_committed()
    assert result.checkpoint.to_dict()["step"] == 3
    assert len(result.metrics_history) == 4  # rank-0 reports


def test_failure_restart_resumes_from_checkpoint(port_rt, tmp_path):
    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir, exist_ok=True)
    result = Trainer(
        flaky_loop, train_loop_config={"steps": 6, "marker_dir": marker_dir},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="flaky", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None
    assert os.path.exists(os.path.join(marker_dir, "crashed_once"))
    assert result.metrics["step"] == 5
    # The restart resumed at step 3 (checkpointed 2 before the crash).
    steps = [m["step"] for m in result.metrics_history]
    assert steps.count(2) >= 1 and steps[-1] == 5


def test_load_shard_reads_the_arena_object_first(port_rt, tmp_path,
                                                 monkeypatch):
    """The arena restore: a committed manifest that records an arena
    object for the shard gives that object under the port's runtime; with
    no runtime, or once the object is freed, the disk shard."""
    import gc
    import time

    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.train.checkpoint import (Checkpoint, commit_manifest,
                                                step_dir, write_shard)
    path = step_dir(str(tmp_path), 3)
    name = write_shard({"from": "disk"}, path, 0, 1)
    ref = rt.put({"from": "arena"})
    commit_manifest(path, step=3, world_size=1, shards=[name],
                    arena={"0": ref.hex()})
    ckpt = Checkpoint(path)
    assert ckpt.load_shard(0) == {"from": "arena"}
    assert ckpt.load_shard(1, world=2) == {"from": "arena"}  # 1 % 1 = 0
    with monkeypatch.context() as m:
        m.setattr(runtime_mod, "current_runtime", lambda: None)
        assert ckpt.load_shard(0) == {"from": "disk"}
    del ref
    gc.collect()
    deadline = time.monotonic() + 30
    while (ckpt.load_shard(0) != {"from": "disk"}
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert ckpt.load_shard(0) == {"from": "disk"}


def test_local_ranks_assigned(port_rt, tmp_path):
    """Co-located workers get distinct local ranks (torch LOCAL_RANK
    semantics); one host => local_world == world."""
    result = Trainer(
        local_rank_loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="lranks", storage_path=str(tmp_path))).fit()
    assert result.error is None
    seen = {(m["rank"], m["local_rank"], m["local_world"])
            for m in result.metrics_history}
    assert (0, 0, 2) in seen


def torch_loop_single(config):
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train import torch as train_torch
    torch.manual_seed(0)
    model = train_torch.prepare_model(torch.nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    X = torch.randn(256, 4)
    y = X @ torch.tensor([[1.0], [2.0], [-1.0], [0.5]]) + 0.1
    for epoch in range(config["epochs"]):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()
        opt.step()
        train.report({"loss": float(loss), "epoch": epoch,
                      "device": str(train_torch.get_device())},
                     checkpoint={"state": {k: v.tolist() for k, v in
                                           model.state_dict().items()}})


def torch_loop_ddp(config):
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.train import torch as train_torch
    ctx = train.get_context()
    assert ctx.get_world_size() == 2
    assert dist.is_initialized()
    torch.manual_seed(0)  # same init on both ranks
    model = train_torch.prepare_model(torch.nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    g = torch.Generator().manual_seed(ctx.get_world_rank())
    X = torch.randn(128, 4, generator=g)
    y = X @ torch.tensor([[1.0], [2.0], [-1.0], [0.5]])
    for _ in range(config["epochs"]):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()  # DDP allreduces grads here
        opt.step()
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    gathered = [torch.zeros_like(flat) for _ in range(2)]
    dist.all_gather(gathered, flat)
    in_sync = bool(torch.allclose(gathered[0], gathered[1], atol=1e-6))
    train.report({"loss": float(loss), "in_sync": float(in_sync)})


def test_torch_trainer_single_worker(port_rt, tmp_path):
    from ray_tpu_torch.train.torch import TorchTrainer
    result = TorchTrainer(
        torch_loop_single, train_loop_config={"epochs": 30},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="torch1", storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.metrics["loss"] < 0.05
    assert result.metrics["device"] == "cpu"  # the worker holds no GPU
    assert "weight" in result.checkpoint.to_dict()["state"]


def test_torch_trainer_ddp_gradients_sync(port_rt, tmp_path):
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
    result = TorchTrainer(
        torch_loop_ddp, train_loop_config={"epochs": 10},
        torch_config=TorchConfig(init_timeout_s=60),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="torchddp", storage_path=str(tmp_path),
            # a restart re-mints the rendezvous address should another
            # process take its port first
            failure_config=FailureConfig(max_failures=2))).fit()
    assert result.error is None, result.error
    assert result.metrics["in_sync"] == 1.0  # DDP kept replicas identical
    assert result.metrics["loss"] < 1.0


# ---- the port's train step through the Trainer against the JAX step ----


def _weights(seed):
    return jax.tree.map(np.asarray, j_init_params(
        j_configs.tiny(), jax.random.PRNGKey(seed)))


def _jax_losses(w, batch, steps, lr, fsdp):
    """The JAX make_train_step + optax.adamw on a (dp=1, fsdp, tp=1) mesh
    of the CPU devices (the conftest makes 8)."""
    cfg = j_configs.tiny(attn_impl="reference")
    mesh = Mesh(np.array(jax.devices()[:fsdp]).reshape(1, fsdp, 1),
                ("dp", "fsdp", "tp"))
    init_fn, _, compile_for, _ = j_make_train_step(
        lambda p, b: j_loss_fn(p, b, cfg, mesh), optax.adamw(lr), mesh,
        j_param_logical_axes(cfg))
    state = init_fn(jax.tree.map(jnp.asarray, w))
    jb = jax.tree.map(jnp.asarray, batch)
    step = compile_for(state, jb)
    out = []
    for _ in range(steps):
        state, loss = step(state, jb)
        out.append(float(loss))
    return out


def _loop_config(w, batch, steps, **kw):
    return dict(cfg=dataclasses.asdict(configs.tiny()), params=w,
                batch=batch, lr=1e-3, steps=steps, **kw)


def test_trainer_losses_match_jax_train_step(port_rt, tmp_path):
    """One worker: 5 AdamW steps of the port's step (configs.tiny(), fp32)
    through Trainer.fit() against the JAX make_train_step + optax.adamw
    on the same params and batch: losses to 1e-5 relative, the tolerance
    of test_torch_train.py's trajectory test (fp32 sums in another
    order)."""
    w = _weights(7)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, 256, (2, 33)).astype(np.int32)}
    result = Trainer(
        W.trainer_loop, train_loop_config=_loop_config(w, batch, 5),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="parity1", storage_path=str(tmp_path))
    ).fit()
    assert result.error is None, result.error
    got = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(got, _jax_losses(w, batch, 5, 1e-3, 1),
                               rtol=1e-5)
    assert got[-1] < got[0]


def test_trainer_restart_resumes_bit_equal(port_rt, tmp_path):
    """A worker that hard-exits right after step 3's checkpoint commits is
    restarted by FailureConfig(max_failures=1) from the manifest
    (save_state / restore_state: params, both moments and the step), and
    its losses equal an uninterrupted fit's bit for bit."""
    w = _weights(9)
    rng = np.random.default_rng(10)
    batch = {"tokens": rng.integers(0, 256, (2, 33)).astype(np.int32)}
    conf = _loop_config(w, batch, 6, ckpt_step=3)
    plain = Trainer(W.trainer_loop, train_loop_config=conf,
                    scaling_config=ScalingConfig(num_workers=1),
                    run_config=RunConfig(name="plain",
                                         storage_path=str(tmp_path))).fit()
    marker = str(tmp_path / "crashed")
    crashed = Trainer(
        W.trainer_loop, train_loop_config=dict(conf, crash_marker=marker),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="crashed", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert plain.error is None and crashed.error is None
    assert os.path.exists(marker)
    assert crashed.checkpoint.path.endswith("000003")
    want = [m["loss"] for m in plain.metrics_history]
    assert [m["step"] for m in crashed.metrics_history] == list(range(6))
    assert [m["loss"] for m in crashed.metrics_history] == want


def test_trainer_fsdp2_gang_matches_jax_sharded_step(port_rt, tmp_path):
    """Two ranks under TorchDistributedConfig (gloo on the CPU) run the
    port's sharded step over a (dp=1, fsdp=2, tp=1) mesh built on the
    Trainer's group: 3 steps against the JAX sharded step on 2 CPU
    devices, losses to 1e-5 relative (test_torch_parallel.py's
    tolerance: fp32 sums in another order and over other shards)."""
    w = _weights(21)
    rng = np.random.default_rng(22)
    batch = {"tokens": rng.integers(0, 256, (4, 33)).astype(np.int32)}
    result = Trainer(
        W.trainer_loop, train_loop_config=_loop_config(
            w, batch, 3, mesh=dict(dp=1, fsdp=2, tp=1)),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="fsdp2", storage_path=str(tmp_path)),
        torch_config=TorchDistributedConfig()).fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert {m["world_size"] for m in hist} == {2}
    np.testing.assert_allclose([m["loss"] for m in hist],
                               _jax_losses(w, batch, 3, 1e-3, 2), rtol=1e-5)
