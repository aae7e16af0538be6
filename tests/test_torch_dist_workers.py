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


def sharded_steps_each(rank, world, runs):
    """`sharded_steps` for each (cfg_kw, mesh_kw, params_np, batch_np,
    steps, lr) of `runs` in turn, in one process group."""
    return [sharded_steps(rank, world, *run) for run in runs]


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



# ---- sequence, expert and pipeline parallelism ----


def _meshes(mesh_kws) -> dict:
    """One CPU mesh per distinct degrees of `mesh_kws` (each mesh makes its
    process groups once), keyed by their sorted items."""
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    out = {}
    for kw in mesh_kws:
        key = tuple(sorted(kw.items()))
        if key not in out:
            out[key] = make_mesh(MeshConfig(**kw), device="cpu")
    return out


def _cut(a, mesh, axis: str, dim: int):
    """This rank's block of numpy array `a` along `dim` over `axis`, a
    leaf tensor that requires grad."""
    import torch
    from ray_tpu_torch.parallel.mesh import axis_rank, mesh_degrees
    n = mesh_degrees(mesh)[axis]
    t = torch.tensor(a).chunk(n, dim=dim)[axis_rank(mesh, axis)]
    return t.clone().requires_grad_(True)


def sp_attention_cases(rank, world, cases):
    """For each (mesh_kw, kind, impl, causal, (q, k, v)) of `cases`: this
    rank's sp block of the global [B, S, H, D] inputs through
    `ring_attention` (kind "ring", its `impl`) or `ulysses_attention`
    (kind "ulysses"), then the backward of the sum of its squared output:
    (sp rank, out, dq, dk, dv) of the rank's block, as numpy."""
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel.mesh import axis_rank
    meshes = _meshes([c[0] for c in cases])
    out = []
    for mesh_kw, kind, impl, causal, arrays in cases:
        mesh = meshes[tuple(sorted(mesh_kw.items()))]
        q, k, v = (_cut(a, mesh, "sp", 1) for a in arrays)
        if kind == "ring":
            o = ring_attention(q, k, v, mesh, causal=causal, impl=impl)
        else:
            o = ulysses_attention(q, k, v, mesh, causal=causal)
        (o ** 2).sum().backward()
        out.append((axis_rank(mesh, "sp"), o.detach().numpy(),
                    q.grad.numpy(), k.grad.numpy(), v.grad.numpy()))
    return out


def sp_attention_and_steps(rank, world, cases, runs):
    """`sp_attention_cases` of `cases`, then `sharded_steps` of each run
    of `runs`, in one process group."""
    return (sp_attention_cases(rank, world, cases),
            [sharded_steps(rank, world, *run) for run in runs])


def pipeline_cases(rank, world, gpipe_cases, scatter_cases):
    """For each (mesh_kw, ws [S, F, F], mbs [M, b, F]) of `gpipe_cases`:
    `gpipe` of tanh(x @ w) stages on this rank's block of ws and the
    gradient of the sum of its squared output: (pp rank, out, this
    stage's dws). For each (mesh_kw, axis, xs [n, ...], dim) of
    `scatter_cases`: `reduce_scatter` over `axis` of this rank's xs[i]
    (i its place on the axis): (i, the result)."""
    import torch
    from ray_tpu_torch.parallel.collectives import reduce_scatter
    from ray_tpu_torch.parallel.mesh import axis_group, axis_rank
    from ray_tpu_torch.parallel.pipeline import gpipe
    meshes = _meshes([c[0] for c in gpipe_cases + scatter_cases])
    key = lambda kw: tuple(sorted(kw.items()))  # noqa: E731
    piped = []
    for mesh_kw, ws, mbs in gpipe_cases:
        mesh = meshes[key(mesh_kw)]
        stage = axis_rank(mesh, "pp")
        w = torch.tensor(ws[stage:stage + 1]).requires_grad_(True)
        out = gpipe(lambda w, x: torch.tanh(x @ w), w, torch.tensor(mbs),
                    mesh)
        (out ** 2).sum().backward()
        piped.append((stage, out.detach().numpy(), w.grad[0].numpy()))
    scattered = []
    for mesh_kw, axis, xs, dim in scatter_cases:
        mesh = meshes[key(mesh_kw)]
        i = axis_rank(mesh, axis)
        got = reduce_scatter(torch.tensor(xs[i]), axis_group(mesh, axis),
                             dim)
        scattered.append((i, got.numpy()))
    return piped, scattered


class BarrierMember:
    """An actor that enters the named `parallel.collectives.Barrier` of
    `world` members `rounds` times."""

    def go(self, name, world, rounds):
        from ray_tpu_torch.parallel.collectives import Barrier
        b = Barrier(name, world)
        for _ in range(rounds):
            b.wait(timeout=60)
        return b._round


# ---- tensor-parallel LLM replicas as gangs (llm/_tp_gang.py) ----


def llm_config(cfg_kw, engine_kw, **kw):
    """The port's LLMConfig of the gang tests: on the CPU, the byte
    tokenizer, random weights from seed 0, rank-2 adapters."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LoraConfig
    from ray_tpu_torch.models import ModelConfig
    return LLMConfig(model_id="tiny", model=ModelConfig(**cfg_kw),
                     engine=EngineConfig(**engine_kw), tokenizer="byte",
                     num_gpus_per_replica=0, device="cpu",
                     lora=LoraConfig(rank=2), **kw)


def _quiet(impl, timeout=30.0):
    """Wait until the replica holds no request: none queued or decoding,
    none finished and unread, no stream open and, on the port's server,
    no mutation its pump has yet to apply and no discarded rid whose
    record has yet to land (the JAX server strands one when a stream
    stops as its request ends: F19 in ROADMAP)."""
    import time
    deadline = time.monotonic() + timeout
    e = impl.engine
    port = hasattr(impl, "_log")
    while (e.finished or impl._token_subs or e.active.any() or e.queue
           or (port and (impl._log or impl._discard))):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"the replica did not go quiet: finished {list(e.finished)}"
                f", discard {impl._discard}, streams {list(impl._token_subs)}"
                f", active {e.active}, queued {[r.request_id for r in e.queue]}"
                f", log {getattr(impl, '_log', None)}")
        time.sleep(0.02)


def serve_scenario(impl, guide_regex, lora_np):
    """The requests the gang tests hold a tp = 2 `_LLMServerImpl` to tp =
    1's and to the JAX package's with: one greedy completion; then, from
    six threads at once while the pump steps, four completions of mixed
    lengths, a stream cut by a stop string (its request cancelled) and a
    stream abandoned after its first delta; a guided completion; one with
    logprobs; one on the adapter `lora_np` (alpha 16) as "tiny-ft",
    materialized on every rank; and, on the port's server, every rank's
    engine state at the end (`gang_state`)."""
    import asyncio
    import threading

    def text(prompt, n, **kw):
        out = asyncio.run(impl.completions(prompt, max_tokens=n,
                                           temperature=0.0, **kw))
        return out["choices"][0]["text"]
    out = {"hello": text("hello tp", 5)}
    full = "".join(impl.completions_stream("stop here", 12, 0.0))
    stop_at = full[2:4]
    asks = [("a", 3), ("concurrent b", 9), ("cc", 14), ("dddd dddd", 6)]
    got = [None] * 6

    def ask(i):
        if i < 4:
            got[i] = text(*asks[i])
        elif i == 4:
            got[i] = "".join(impl.completions_stream(
                "stop here", 12, 0.0, stop=[stop_at]))
        else:
            stream = impl.completions_stream("abandon me", 30, 0.0)
            got[i] = next(stream)
            stream.close()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    _quiet(impl)
    out.update(full=full, stop_at=stop_at, concurrent=got,
               guided=text("json:", 10, guided_regex=guide_regex),
               logprobs=asyncio.run(impl.completions(
                   "lp", max_tokens=4, temperature=0.0,
                   logprobs=True))["choices"][0]["logprobs"])
    gang_call = getattr(impl, "gang_call", None)
    if gang_call is None:           # the JAX package's server
        impl._materialize("tiny-ft", lora_np, 16.0)
    else:
        gang_call("_materialize", "tiny-ft", lora_np, 16.0)
    out["adapter"] = text("hello tp", 5, model="tiny-ft")
    _quiet(impl)
    if gang_call is not None:
        out["states"] = gang_call("gang_state")
    return out


def tp_serve_suite(rank, world, cfg_kw, engine_kw, guide_regex, params_np,
                   lora_np, prompts, disagg_kw, handoff_prompts, resume):
    """The gang cases in one process group of `world` ranks; rank 0's
    results. `_LLMServerImpl` at tp = `world` through `serve_scenario`;
    a direct tp engine given an adapter's deltas cut by its
    `local_blocks` (greedy tokens of `prompts`); the prefill gang's export of
    each of `handoff_prompts` (prefill(): its first token and sealed
    handoff); and the decode gang's streams from those handoffs, and of
    `resume` = (prompt, generated, max_new) with the handoff and without
    (re-prefill) at 1 and 3 tokens held, with logprobs."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.llm import _tp_gang
    from ray_tpu_torch.llm import serve as S
    from ray_tpu_torch.llm.lora import add_deltas, lora_deltas
    from ray_tpu_torch.models import ModelConfig, params_from_numpy
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    def gang(cls, cfg, work):
        if rank:
            _tp_gang.follow(cls, cfg)
            return None
        impl = cls(cfg)
        try:
            return work(impl)
        finally:
            impl._stop = True
            impl._gang.stop()
    out = {"serve": gang(
        S._LLMServerImpl, llm_config(cfg_kw, engine_kw,
                                     tensor_parallelism=world),
        lambda impl: serve_scenario(impl, guide_regex, lora_np))}

    mesh = make_mesh(MeshConfig(fsdp=1, tp=world), device="cpu")
    eng = InferenceEngine(ModelConfig(**cfg_kw), EngineConfig(**engine_kw),
                          params=params_from_numpy(params_np, device="cpu"),
                          mesh=mesh, device="cpu")
    eng.params = add_deltas(eng.params, eng.local_blocks(
        lora_deltas(lora_np, 16.0)))
    out["adapter"] = eng.generate(prompts, max_new_tokens=6,
                                  temperature=0.0)

    dcfg = llm_config(cfg_kw, disagg_kw, tensor_parallelism=world)
    out["prefill"] = gang(S._PrefillWorkerImpl, dcfg, lambda w: [
        w.prefill(p, 0.0, want_logp=True) for p in handoff_prompts])

    def decode(rep):
        got = {"handoff": [[t for c in rep.decode_stream(
            p, [pre["first"]], pre["kv"], 8, 0.0) for t in c]
            for p, pre in zip(handoff_prompts, out["prefill"])]}
        prompt, held, max_new = resume     # prompt: the last handoff's
        sealed = out["prefill"][-1]["kv"]
        for n in (1, 3):
            for kv in (sealed, None):
                got[(n, kv is not None)] = [x for c in rep.decode_stream(
                    prompt, held[:n], kv, max_new, 0.0, chunk_tokens=2,
                    want_logp=True) for x in c]
        _quiet(rep)
        got["states"] = rep.gang_call("gang_state")
        return got
    out["decode"] = gang(S._DecodeReplicaImpl, dcfg, decode)
    return out


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


# ---- serve deployments ----


def _serve_batch(**kw):
    from ray_tpu_torch import serve
    return serve.batch(**kw)


class BatchedDoubler:
    """A serve deployment whose concurrent calls `@serve.batch` gathers
    into one: each caller gets its own element, with the size of the
    batch it rode in."""

    @_serve_batch(max_batch_size=4, batch_wait_timeout_s=0.5)
    async def __call__(self, xs):
        return [(2 * x, len(xs)) for x in xs]


# ---- data UDFs (run by both packages' workers, on numpy rows/batches) ----


def double_id(row):
    return {"id": row["id"] * 2, "name": f"row-{row['id']}"}


def id_div3(row):
    return row["id"] % 3 != 0


def twice(row):
    return [row, {"id": -row["id"], "name": row["name"] + "!"}]


def square_batch(batch):
    return {"id": batch["id"], "sq": batch["id"] ** 2,
            "half": batch["id"] / 2.0}


def float_batch(batch):
    import numpy as np
    return {"x": np.asarray(batch["id"], np.float64) * 2}


def id_times_ten(batch):
    return batch["id"] * 10


def double_data(batch):
    return {"data": batch["data"] * 2}


def with_b(row):
    return {"b": row["id"] * 10 + 1}


def group_extremes(batch):
    return {"k": batch["k"][:1], "mx": [batch["v"].max()],
            "n": [len(batch["v"])]}


class Scaler:
    """A class UDF: constructed once per actor."""

    def __init__(self, k):
        self.k = k

    def __call__(self, batch):
        return {"id": batch["id"] * self.k}


def ingest_loop(config):
    """A Trainer loop that reads its dataset shard as torch batches and
    writes the ids it saw to `seen_dir/rank<r>.txt`."""
    from ray_tpu_torch import train
    shard = train.get_dataset_shard("train")
    seen = []
    for batch in shard.iter_torch_batches(batch_size=config["batch_size"],
                                          device="cpu"):
        seen += batch["idx"].tolist()
    rank = train.get_context().get_world_rank()
    with open(f"{config['seen_dir']}/rank{rank}.txt", "w") as f:
        f.write(",".join(map(str, seen)))
    train.report({"n": len(seen), "rank": rank})


def key_of_four(batch):
    return {"id": batch["id"], "k": batch["id"] % 4,
            "s": [f"s{i % 3}" for i in batch["id"]]}


def tiny_llm_config(**kw):
    """configs.tiny() at the byte tokenizer's vocab, fp32, on the CPU."""
    import dataclasses

    from ray_tpu_torch.llm import EngineConfig, LLMConfig
    from ray_tpu_torch.models import configs
    return LLMConfig(model_id="tiny", model=dataclasses.replace(
        configs.tiny(), vocab=300), engine=EngineConfig(
            max_slots=2, max_len=64, prompt_buckets=(32,), eos_token=-1),
        tokenizer="byte", num_gpus_per_replica=0, device="cpu", **kw)


def data_scenario():
    """A pipeline through every exchange and the tiny processor, on the
    port's runtime (the caller's): its rows, and the modules the runtime's
    workers cannot import."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import get, remote
    from ray_tpu_torch.llm import build_llm_processor
    ds = rd.range(40, override_num_blocks=4).map_batches(
        key_of_four, batch_size=7).random_shuffle(seed=3)
    prompts = rd.from_items([{"idx": i, "prompt": p} for i, p in enumerate(
        ["hello", "a batch of prompts", "x"])], override_num_blocks=2)
    proc = build_llm_processor(tiny_llm_config(), max_new_tokens=4,
                               temperature=0.0, batch_size=2)
    return dict(
        sorted=ds.sort("k").take_all(), sorted_s=ds.sort("s").take_all(),
        counts=ds.groupby("k").count().take_all(),
        generated=proc(prompts).take_all(),
        missing=get(remote(imports_fail).remote(
            ["cloudpickle", "pyarrow", "pandas"]), timeout=60))


# ---- compiled graphs, channels and collectives (both packages' workers) ----


class DagStage:
    """A compiled-graph stage actor: scalar steps, a numpy or torch pytree
    scaled, and torch leaves (fp32, bf16, int64) through exact ops."""

    def __init__(self, add):
        self.add = add
        self.calls = 0

    def step(self, x):
        self.calls += 1
        return x + self.add

    def twice(self, x):
        return x * 2

    def num_calls(self):
        return self.calls

    def scale(self, batch):
        return {"x": batch["x"] * self.add, "hops": batch["hops"] + 1}

    def torch_step(self, v):
        import torch
        return {"f": v["f"] * 2.0 + self.add,
                "b": (v["b"].float() * 2.0).to(torch.bfloat16),
                "n": v["n"] + 1, "tag": v["tag"]}


def channel_reader(path, n):
    """Read `n` values from the tensor channel at `path` (reader 0) in a
    worker: each value's leaf types and the bytes of its torch leaves."""
    from ray_tpu_torch.experimental.channel import TensorChannel
    r = TensorChannel(path)
    out = []
    try:
        for _ in range(n):
            v = r.read(timeout=60)
            out.append({k: (type(x).__name__, str(getattr(x, "dtype", "")),
                            _bits(x)) for k, x in v.items()})
            r.release()
    finally:
        r.close()
    return out


def _bits(x):
    """The bytes of an array leaf (a bf16 tensor's as its int16 view)."""
    import numpy as np
    if hasattr(x, "detach"):
        import torch
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    if isinstance(x, np.ndarray):
        return x.tobytes()
    return x


def cuda_leaf_reader(path):
    """Read one value from the tensor channel at `path` in a worker that
    sees no card: the error it raises (a CUDA leaf must be refused)."""
    from ray_tpu_torch.experimental.channel import TensorChannel
    r = TensorChannel(path)
    try:
        r.read(timeout=60)
    except RuntimeError as e:
        return str(e)
    finally:
        r.close()
    return "no error"


def _col_tensor(values, dtype: str, as_torch: bool):
    """One rank's tensor: numpy (ml_dtypes for bfloat16, as the JAX
    package's arrays are) or, with as_torch, a torch tensor of the same
    values."""
    import numpy as np
    arr = np.asarray(values, np.float64)
    if as_torch:
        import torch
        return torch.tensor(arr).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        import ml_dtypes
        return arr.astype(np.float32).astype(ml_dtypes.bfloat16)
    return arr.astype(dtype)


def _col_read(x):
    """A tensor as plain numpy (bfloat16 as its uint16 bits)."""
    import numpy as np
    if hasattr(x, "detach"):
        import torch
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x


class CollectiveMember:
    """A member of a host collective group of `pkg` ("ray_tpu" or
    "ray_tpu_torch"): each op runs on this rank's tensor (numpy, or a
    torch tensor of the same values with as_torch) and reports the tensor
    after the op, what the op returned, and whether that was the tensor
    itself (in place)."""

    def __init__(self, pkg, rank, world, group="g"):
        import importlib
        self.col = importlib.import_module(pkg + ".util.collective")
        self.col.init_collective_group(world, rank, group_name=group)
        self.rank, self.world, self.group = rank, world, group

    def run(self, what, values, dtype="float32", as_torch=False, **kw):
        col, g = self.col, self.group
        t = _col_tensor(values[self.rank], dtype, as_torch)
        if what == "allgather":
            out = []
            col.allgather(out, t, group_name=g)
            return [_col_read(x) for x in out]
        if what == "reducescatter":
            chunks = [_col_tensor(values[self.rank][i], dtype, as_torch)
                      for i in range(self.world)]
            t = _col_tensor(values[self.rank][0], dtype, as_torch) * 0
            out = col.reducescatter(t, chunks, group_name=g, **kw)
        elif what == "broadcast":
            out = col.broadcast(t, group_name=g, **kw)
        elif what == "allreduce":
            out = col.allreduce(t, group_name=g, **kw)
        elif what == "reduce":
            out = col.reduce(t, group_name=g, **kw)
        elif what == "sendrecv":
            if self.rank == 0:
                col.send(t, 1, group_name=g)
                return None
            if self.rank != 1:
                return None
            out = col.recv(t * 0, 0, group_name=g)
            return dict(out=_col_read(out), inplace=None, same=None)
        elif what == "barrier":
            col.barrier(group_name=g)
            return self.rank
        else:
            raise ValueError(what)
        return dict(out=_col_read(out), inplace=_col_read(t),
                    same=out is t)

    def p2p_route(self, nbytes):
        """Whether a large contribution takes the peer-to-peer transport:
        the rendezvous' verdict (None: the KV path)."""
        import numpy as np
        g = self.col.collective._group(self.group)
        return g.p2p_for(np.zeros(nbytes, np.uint8))


def join_collective(pkg, name, world):
    import importlib
    return importlib.import_module(pkg + ".util.collective").join_group(
        name, world)


def internal_kv_from_worker(pkg):
    import importlib
    kv = importlib.import_module(pkg + ".experimental.internal_kv")
    kv._internal_kv_put(b"wk:x", b"99")
    return kv._internal_kv_get(b"wk:x"), sorted(kv._internal_kv_list(b"wk:"))


class TorchRows:
    """A torch map-style dataset over numpy rows: item i is row i as a
    tensor (with `pair`, a (tensor, label) tuple)."""

    def __init__(self, rows, pair=False):
        self.rows = rows
        self.pair = pair

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        import torch
        t = torch.from_numpy(self.rows[i].copy())
        return (t, torch.tensor(i % 3)) if self.pair else t


def numpy_half_scenario(root):
    """The data library's numpy half and a compiled DAG over tensor
    channels, on the port's runtime (the caller's), with files under
    `root`: what each gives, as JSON-able lists."""
    import io
    import os
    import tarfile

    import numpy as np
    import torch
    from PIL import Image

    from ray_tpu_torch import data as rd
    from ray_tpu_torch import kill, remote
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.data import preprocessors as pp
    os.makedirs(root, exist_ok=True)
    rows = [{"idx": i, "name": f"r{i % 3}", "x": i * 0.25} for i in range(12)]
    ds = rd.from_items(rows, override_num_blocks=2)
    ds.write_tfrecord(os.path.join(root, "tfr"))
    ds.write_avro(os.path.join(root, "avro"))
    with tarfile.open(os.path.join(root, "s.tar"), "w") as tf:
        for i in range(3):
            info = tarfile.TarInfo(name=f"k{i}.a")
            info.size = 2
            tf.addfile(info, io.BytesIO(b"a%d" % i))
    Image.fromarray(np.full((4, 3, 3), 9, np.uint8)).save(
        os.path.join(root, "p.png"))
    chain = pp.Chain(pp.StandardScaler(["x"]), pp.OneHotEncoder(["name"]),
                     pp.Concatenator(["x", "name_r0", "name_r1", "name_r2"],
                                     "f"))
    feats = chain.fit(ds).transform(ds).take_batch(12)["f"]
    a = remote(DagStage).remote(1.5)
    b = remote(DagStage).remote(-4.0)
    with InputNode() as inp:
        dag = b.torch_step.bind(a.torch_step.bind(inp))
    compiled = dag.experimental_compile(buffer_size_bytes=1 << 20)
    try:
        out = compiled.execute({
            "f": torch.arange(8, dtype=torch.float32),
            "b": torch.arange(8, dtype=torch.float32).to(torch.bfloat16),
            "n": torch.arange(3), "tag": "z"}).get(timeout=60)
    finally:
        compiled.teardown()
    for h in (a, b):
        kill(h)
    img = rd.read_images(os.path.join(root, "p.png")).take_all()[0]
    return dict(
        tfrecord=sorted([r["idx"], r["name"].decode(), r["x"]] for r in
                        rd.read_tfrecord(os.path.join(root, "tfr"))
                        .take_all()),
        avro=sorted([r["idx"], r["name"], r["x"]] for r in
                    rd.read_avro(os.path.join(root, "avro")).take_all()),
        webdataset=[[r["__key__"], r["a"].decode()] for r in
                    rd.read_webdataset(os.path.join(root, "s.tar"))
                    .take_all()],
        image=rd.decode_image(img).tolist(),
        chain=feats.tolist(),
        from_torch=rd.from_torch(TorchRows(np.arange(24, dtype=np.int32)
                                           .reshape(6, 4)))
        .take_batch(6)["item"].tolist(),
        dag=[out["f"].tolist(), out["b"].float().tolist(),
             out["n"].tolist(), out["tag"], str(out["b"].dtype)])
