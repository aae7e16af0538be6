"""Multi-process runners for the port's sharded tests (imported by the
spawned workers, so it imports torch and ray_tpu_torch only —
never jax or ray_tpu).

`run_group(fn, world, *args)` spawns `world` processes on the CPU, joins
them in one gloo process group over localhost, calls `fn(rank, world,
*args)` in each and returns the results by rank. It waits at most
`timeout` seconds and kills every worker still alive then, so a hung
collective fails the test instead of the suite.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def run_group(fn, world: int, *args, timeout: float = 120.0) -> list:
    """fn(rank, world, *args) in `world` gloo processes; results by rank.
    Raises with the workers' tracebacks on a failure, or on the timeout
    (after killing the workers)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__} on {world} ranks: no "
                                   f"result within {timeout} s")
            try:
                rank, status, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if errors or any(p.exitcode not in (None, 0) for p in procs):
                    if not out.empty():
                        continue
                    break
                continue
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors or len(results) < world:
        raise RuntimeError(f"{fn.__name__} on {world} ranks failed:\n"
                           + "\n".join(errors or ["a worker died"]))
    return [results[r] for r in range(world)]


# ---- the sharded train step ----


def _numpy_tree(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return t.detach().float().numpy().copy()


def sharded_steps(rank, world, cfg_kw, mesh_kw, params_np, batch_np,
                  steps, lr):
    """`steps` AdamW steps of the sharded train step on a mesh of
    `mesh_kw`: ([loss per step], full params as numpy) on every rank."""
    import torch
    from ray_tpu_torch.models import (ModelConfig, loss_fn,
                                      param_logical_axes, params_from_numpy)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import adamw, make_train_step
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg, mesh), adamw(lr), mesh,
        param_logical_axes(cfg), device="cpu")
    state = init_fn(params_from_numpy(params_np, device="cpu"))
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, batch)
        losses.append(loss.item())
    return losses, _numpy_tree(state.params)


def sharded_grads(rank, world, cfg_kw, mesh_kw, params_np, batch_np):
    """The loss and the gradients (gathered, as numpy) of one backward of
    the sharded loss on a mesh of `mesh_kw`, with no optimizer step."""
    import torch
    from ray_tpu_torch.models import (ModelConfig, loss_fn,
                                      param_logical_axes, params_from_numpy)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import ShardingRules, local_shard
    from ray_tpu_torch.train.optim import tree_map
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
    params = shard_params(params_from_numpy(params_np, device="cpu"),
                          param_logical_axes(cfg), ShardingRules.default(),
                          mesh)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    batch = {k: local_shard(torch.tensor(v), mesh, (("dp", "fsdp"),))
             for k, v in batch_np.items()}
    loss = loss_fn(params, batch, cfg, mesh)
    loss.backward()
    return loss.item(), _numpy_tree(tree_map(lambda t: t.grad, params))


# ---- the tensor-parallel engines ----


def tp_engines(rank, world, cfg_kw, params_np, prompts, n_new,
               handoff_prompt):
    """Engines over a tp mesh of `world`: the greedy tokens of the plain
    engine and of the ngram speculative engine for `prompts`, and of a
    PrefillEngine export of `handoff_prompt` imported into a decode engine
    (import_kv + resume_token), with the kv heads each rank holds."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, PrefillEngine
    from ray_tpu_torch.models import ModelConfig, params_from_numpy
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(MeshConfig(fsdp=1, tp=world), device="cpu")
    params = params_from_numpy(params_np, device="cpu")
    ec = dict(max_slots=2, max_len=48, prompt_buckets=(16,), eos_token=-1)
    out = {}
    eng = InferenceEngine(cfg, EngineConfig(**ec), params=params, mesh=mesh,
                          device="cpu")
    out["plain"] = eng.generate(prompts, max_new_tokens=n_new,
                                temperature=0.0)
    out["kv_heads"] = eng.cache_k.shape[1]
    spec = InferenceEngine(
        cfg, EngineConfig(**ec, page_size=16, speculation="ngram", spec_k=4),
        params=params, mesh=mesh, device="cpu")
    out["spec"] = spec.generate(prompts, max_new_tokens=n_new,
                                temperature=0.0)
    out["spec_verify_steps"] = spec.verify_steps
    paged = dict(ec, page_size=8)
    pre = PrefillEngine(cfg, EngineConfig(**paged), params=params,
                        mesh=mesh, device="cpu")
    first, ks, vs = pre.prefill_export(handoff_prompt)
    dec = InferenceEngine(cfg, EngineConfig(**paged), params=params,
                          mesh=mesh, device="cpu")
    out["imported_pages"] = dec.import_kv(handoff_prompt, ks, vs)
    rid = dec.add_request(handoff_prompt, max_new_tokens=n_new,
                          resume_token=first)
    while dec.has_work():
        dec.step_window()
    out["handoff"] = dec.finished[rid].generated
    out["handoff_kv_heads"] = ks.shape[2]
    return out


def reshard_params(rank, world, cfg_kw, params_np):
    """Params placed on an fsdp=`world` mesh moved onto a tp=`world` mesh
    by `reshard` (through the full tensor: another mesh): for each leaf,
    whether its full tensor is unchanged, and its local shape before and
    after."""
    import torch
    from ray_tpu_torch.models import (ModelConfig, param_logical_axes,
                                      params_from_numpy)
    from ray_tpu_torch.parallel import (MeshConfig, NamedSharding,
                                        ShardingRules, make_mesh, reshard,
                                        shard_params)
    from ray_tpu_torch.parallel.sharding import declared_param_specs, tree_map
    cfg = ModelConfig(**cfg_kw)
    full = params_from_numpy(params_np, device="cpu")
    axes = param_logical_axes(cfg)
    placed = shard_params(full, axes, ShardingRules.default(),
                          make_mesh(MeshConfig(fsdp=world), device="cpu"))
    tp_mesh = make_mesh(MeshConfig(fsdp=1, tp=world), device="cpu")
    target = tree_map(lambda s: NamedSharding(tp_mesh, s),
                      declared_param_specs(axes))
    moved = reshard(placed, target)
    leaf = lambda t: not isinstance(t, dict)  # noqa: E731
    return tree_map(
        lambda a, b, f: (torch.equal(b.full_tensor(), f),
                         tuple(a.to_local().shape), tuple(b.to_local().shape)),
        placed, moved, full, is_leaf=leaf)


def two_rank_suite(rank, world, cfg_kw, params_np, prompts, n_new,
                   handoff_prompt, train_cfg_kw, train_params_np, batch_np):
    """The 2-rank cases in one process group: the tp engines, the loss
    and gathered gradients of the fsdp=2 sharded loss, and a reshard of
    fsdp=2 params onto a tp=2 mesh."""
    return {"engines": tp_engines(rank, world, cfg_kw, params_np, prompts,
                                  n_new, handoff_prompt),
            "grads": sharded_grads(rank, world, train_cfg_kw,
                                   dict(fsdp=world), train_params_np,
                                   batch_np),
            "reshard": reshard_params(rank, world, train_cfg_kw,
                                      train_params_np)}


# ---- sharded checkpoints ----


def checkpoint_roundtrip(rank, world, cfg_kw, params_np, batch_np, lr,
                         storage):
    """Train 2 steps at fsdp=`world`, commit a checkpoint, take 2 more
    steps (the uninterrupted run's next losses: the second one reads the
    restored moments); then restore into a fresh state on a tp=`world`
    mesh in the same processes and take those steps; then, on rank 0
    alone, in a process group of one, restore at world 1 and take them
    again. Returns the three runs' next losses and the manifest seen."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import (ModelConfig, loss_fn,
                                      param_logical_axes, params_from_numpy)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import (adamw, load_manifest, latest_committed,
                                     make_train_step, restore_state,
                                     save_checkpoint)
    cfg = ModelConfig(**cfg_kw)
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}

    def state_on(mesh):
        init_fn, step_fn, _, _ = make_train_step(
            lambda p, b: loss_fn(p, b, cfg, mesh), adamw(lr), mesh,
            param_logical_axes(cfg), device="cpu")
        return init_fn(params_from_numpy(params_np, device="cpu")), step_fn

    out = {}
    mesh = make_mesh(MeshConfig(fsdp=world), device="cpu")
    state, step_fn = state_on(mesh)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    ckpt = save_checkpoint(state, storage, 2, mesh=mesh)
    out["manifest"] = load_manifest(ckpt.path)
    out["latest"] = latest_committed(storage)

    def next_losses(state, step):
        return [step(state, batch)[1].item() for _ in range(2)]

    out["uninterrupted"] = next_losses(state, step_fn)

    tp_mesh = make_mesh(MeshConfig(fsdp=1, tp=world), device="cpu")
    fresh, tp_step = state_on(tp_mesh)
    restore_state(out["latest"], fresh)
    out["restored_step"] = int(fresh.step)
    out["tp"] = next_losses(fresh, tp_step)

    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        solo = make_mesh(MeshConfig(fsdp=1), device="cpu")
        fresh, solo_step = state_on(solo)
        restore_state(out["latest"], fresh)
        out["world1"] = next_losses(fresh, solo_step)
    return out




# ---- Trainer loops and runtime tasks (run in the port's runtime workers) ----


def trainer_loop(config):
    """A Trainer loop: `steps` AdamW steps of the port's train step on the
    given params and batch, one device, or the sharded step over a mesh
    of `config["mesh"]` when the gang has more than one rank (the group
    TorchDistributedConfig formed). Reports the loss of every step; at
    `ckpt_step` saves the state (save_state, rank 0) into that step's
    directory and reports it as the checkpoint; with `crash_marker`, the
    first run hard-exits once that checkpoint has committed. A run that
    finds a checkpoint resumes from it."""
    import os

    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import (ModelConfig, loss_fn,
                                      param_logical_axes, params_from_numpy)
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.checkpoint import (Checkpoint, is_committed,
                                                restore_state, save_state,
                                                step_dir)
    torch.set_num_threads(1)
    ctx = train.get_context()
    cfg = ModelConfig(**config["cfg"])
    mesh = None
    if ctx.get_world_size() > 1:
        from ray_tpu_torch.parallel import MeshConfig, make_mesh
        mesh = make_mesh(MeshConfig(**config["mesh"]), device="cpu")
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg, mesh), adamw(config["lr"]), mesh,
        param_logical_axes(cfg) if mesh is not None else None,
        device="cpu")
    state = init_fn(params_from_numpy(config["params"], device="cpu"))
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        restore_state(os.path.join(ckpt.path, "state.pt"), state)
    batch = {k: torch.tensor(v) for k, v in config["batch"].items()}
    for step in range(int(state.step), config["steps"]):
        state, loss = step_fn(state, batch)
        metrics = {"step": step, "loss": loss.item(),
                   "rank": ctx.get_world_rank(),
                   "world_size": ctx.get_world_size()}
        if step != config.get("ckpt_step"):
            train.report(metrics)
            continue
        path = step_dir(ctx.get_trial_dir(), step)
        if ctx.get_world_rank() == 0:
            save_state(state, os.path.join(path, "state.pt"))
        train.report(metrics, checkpoint=Checkpoint(path))
        marker = config.get("crash_marker")
        if marker and not os.path.exists(marker):
            deadline = time.monotonic() + 60
            while not is_committed(path) and time.monotonic() < deadline:
                time.sleep(0.05)
            open(marker, "w").close()
            os._exit(1)  # a hard crash right after the commit


def cuda_visible_devices():
    """This worker's CUDA_VISIBLE_DEVICES (None when unset)."""
    import os
    return os.environ.get("CUDA_VISIBLE_DEVICES")


class VisibleDevices:
    """An actor that reports the CUDA_VISIBLE_DEVICES it got."""

    def get(self):
        return cuda_visible_devices()


def add_one(x):
    return x + 1


def worker_pid():
    import os
    return os.getpid()


def imports_fail(names):
    """The names of `names` this process cannot import."""
    import importlib
    out = []
    for n in names:
        try:
            importlib.import_module(n)
        except ImportError:
            out.append(n)
    return out


class Counter:
    """An actor with state, for the runtime tests."""

    def __init__(self, start=0):
        self.n = start

    def add(self, k=1):
        self.n += k
        return self.n

    def pid(self):
        import os
        return os.getpid()

    def die(self):
        import os
        os._exit(1)
