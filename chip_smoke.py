#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --serve-ab ../parent --pairs 10
                                     # only the serve phase, this checkout
                                     # against another, in alternation
    python3 chip_smoke.py --head-dim-times ../parent
                                     # only the kernels' times at head_dims
                                     # 12-520, of the package at ../parent

Phases (each raises on failure, so the script exits non-zero and prints
no result line):
 1. device  — name, power limit, torch and CUDA versions;
 2. build   — every hand-written kernel source from the checkout (one
              nvcc per source, all started together), with ptxas's
              register, shared-memory and spill report, and (where the
              toolkit has cuobjdump) each flash kernel's count of
              tensor-core instructions in its SASS: the bf16 K2 and K4
              bodies must have wgmma (HGMMA) in every instantiation;
 3. kernels — each kernel against its plain PyTorch version on the card
              (bf16 and fp32, stated tolerances; the backward kernels also
              against autograd of the plain forward in fp32; the fused
              verify-insert kernel also by the pool bytes it writes), then
              its time (CUDA events, warmed, launches queued behind a
              device sleep so the host's launch cost is not timed), the
              plain version's time, the least time the card could take
              (bound), the achieved TFLOP/s and share of the bound and,
              where one PyTorch call computes the same function, that
              call's time; K1 (the split-KV cluster kernel) over g = 1-16
              and its chunk and split edges, two calls bit-equal, timed at
              the serving shape and at a long context, and under each
              split count at 1-32 slots beside its plan's; K1'/K5 up to 48
              query rows per kv head (two row groups); K2 and K3/K4 also
              at S = 1, 63, 65, 129 and 1000 (the edges of their 64-row
              tiles) in bf16; then every kernel at head_dims 16, 32, 80,
              8, 120, 136, 192, 256, 12, 100, 264, 384 and 520 (the
              wrappers pad a head_dim to a multiple of 8; past 256 the
              wide bodies run), bf16 and fp32;
 4. serve   — the engine at full Llama-125M width (bf16, seeded random
              weights): 32 requests of 127 tokens plus 4 sharing a
              128-token prefix, 64 greedy tokens each; the paged-decode
              kernel must have run 12 times per decode step and the plain
              path never; then where the serve path's time goes (host
              clock of admission and of one decode window, and a
              torch.profiler trace: device busy time, idle share, device
              time by kernel);
 5. spec-serve — the same requests through the speculative engine
              (`speculation="ngram"`, spec_k 4): every request must finish
              with 64 tokens and the fused verify-insert kernel must have
              run 12 times per verify step and its plain version never;
              tokens/s beside the serve phase's, the acceptance rate, the
              token agreement with the serve phase (bf16, printed only),
              and a torch.profiler trace;
 6. exact   — the same width in fp32: the engine's greedy tokens must
              equal an argmax loop over the port's `forward`, which runs
              the flash-forward kernel;
 7. spec-exact — fp32 again: the speculative engine's greedy tokens must
              equal the plain engine's and the argmax loop's, with drafts
              accepted; then a 2-iteration speculative window with mixed
              temperatures under CUDA sync debug mode "error"; then the
              same equalities for a 2-layer model with 8 query heads per
              kv head at spec_k 5 (48 verify rows per kv head);
 8. train   — the train step (`make_train_step` + `loss_fn` + `adamw`)
              at full Llama-125M width and depth in bf16 on a fixed
              16 x 1024 batch: 3 warm-up and 10 timed steps; the forward
              (with lse), dQ and dK/dV kernels must each run 12 times per
              step and their plain versions never, every loss must be
              finite and the last below the first; step time, tokens/s,
              MFU, peak memory, the loss head's time, a torch.profiler
              trace of one step and the synchronizing calls of one step;
 9. train-exact — the same width in fp32 at 2 x 256: loss and every
              gradient leaf of the kernel path against the plain path
              (dense attention differentiated by autograd), and a 3-step
              AdamW trajectory of both, within stated tolerances;
10. tiny    — configs.tiny() (head_dim 16) in fp32 and bf16 through the
              plain engine (K1), the speculative engine (K5) and 3 train
              steps (K2-K4), launch counts held, no plain version run;
11. guided  — the serve phase's prompts at llama-125m width in bf16, half
              under a JSON-schema guide: every guided answer parses, K1
              runs 12 times per decode step; tokens/s, the guide table's
              bytes and uploads per window; in fp32 the engine's guided
              greedy tokens equal a masked-argmax loop over `forward` (K2)
              walking the same DFA; one guided window under sync debug
              mode "error";
12. handoff — PrefillEngine.prefill_export, then import_kv + resume_token
              in a decode engine: in fp32 (300-token prompts) the tokens
              equal the monolithic engine's, with prefix hits; in bf16 32
              such requests timed;
13. dense   — kv_layout="dense": fp32 greedy tokens equal the paged
              engine's; the serve phase's requests in bf16 timed;
14. sharded-train — the train phase's step through the sharded code
              (`make_train_step(mesh=...)`, params as DTensors, each layer
              gathered over the data axes) over a mesh of one CUDA device
              (fsdp = 1, a process group of one): bf16 16 x 1024, 3
              warm-up and 10 timed steps beside the unsharded step, K2-K4
              12 launches a step each and no plain run; fp32 2 x 256, 3
              AdamW steps held to the unsharded step's losses (1e-5) and
              params (2e-4);
15. checkpoint — that bf16 state after step 5 saved through the
              manifest path (torch.distributed.checkpoint, MANIFEST.json),
              found by latest_committed, restored into a fresh state: the
              next 3 losses equal the uninterrupted run's bit for bit; an
              uncommitted directory stays until gc_uncommitted removes it;
16. tp-serve — tp = 2 as two processes on the one card over gloo:
              llama-125m, 6 heads and 6 kv heads a rank; fp32 greedy
              tokens equal the tp = 1 engine's and a forward argmax, plain
              and speculative; bf16, the serve phase's 32 requests x 64
              tokens timed; K1 12 launches per decode step on each rank.
17. trainer — the port's runtime (`ray_tpu_torch.init()`, which counts
              the card as torch does, its native head core and object
              store built from the checkout) and `Trainer.fit()`: a
              num_gpus=0 task sees no device, a
              num_gpus=1 actor one; 10 bf16 llama-125m steps (16 x 1024)
              on a worker holding the card, K2-K4 12 launches a step in
              the worker and no plain run, a checkpoint committed at step
              5; fp32 (2 x 256) losses bit-equal to the same steps in this
              process; a worker hard-exiting after step 5's commit,
              resumed from the manifest with bit-equal fp32 losses; two
              ranks at gpus_per_worker=0.5 under TorchDistributedConfig
              (gloo) whose all-reduce of a CUDA tensor sums.
18. serve-runtime — `serve.run(build_openai_app(...))` on the port's
              runtime: the LLM replica an actor reserving the card (its
              class the probe `ProbeServer`, which reads the replica's
              launch counts), the OpenAI router and the HTTP proxy on a
              free port. llama-125m bf16 at the serve phase's engine
              shape: the serve phase's traffic as text through
              /v1/completions from 36 client threads, tokens/s beside
              the serve phase's, the boot (serve.run to the first
              answer), K1 12 launches per replica decode step and no
              plain run, a streamed request with logprobs (time to its
              first chunk), /v1/models, the replica's peak memory; fp32
              tokens through HTTP == the in-process engine's == a
              forward argmax, a LoRA adapter registered through the
              handle == an engine built with the merged params, then
              the base tokens again; no runtime process outlives it.
19. disagg  — `serve.run(build_disagg_openai_app(...))` on the port's
              runtime: a prefill worker and two decode replicas sharing
              the card by fractional GPU shares (their classes the probes
              `ProbePrefill` and `ProbeDecode`), the coordinator and the
              router holding none. llama-125m bf16, the decode replicas
              at the serve phase's engine shape (bucket 256 added for the
              prefill worker, which prefills a prompt whole): phase 18's
              traffic through /v1/completions from 36 client threads,
              tokens/s beside phases 4 and 18, the coordinator's stats,
              the handoff's bytes, the export time, each replica's peak,
              the boot; K1 12 launches per decode step summed over the
              decode replicas and no plain paged run anywhere; fp32
              tokens through HTTP == the in-process engine's == a forward
              argmax, the handoff after the store bit-equal to an
              engine's own prefill pages, a decode replica SIGKILLed
              mid-stream (every stream still exact, the replica respawned
              on its share) and a burst past max_ongoing_requests shed
              with HTTP 429 while the admitted finish exact.
20. tp-gang — replicas with tensor_parallelism=2 as gangs of two
              processes in lockstep through the port's runtime (rank 0
              the replica actor, the follower in its placement group,
              gloo on the one card). `build_openai_app` at
              num_gpus_per_replica=1.0 (two ranks at 0.5 GPU): 12 of
              phase 18's requests (8 of its 127-token prompts and the 4
              sharing a page), tokens/s beside phases 16 and 18, the boot,
              each rank's decode steps (equal) and peak, K1 12 launches
              a step on each rank and no plain run; fp32 tokens through
              HTTP == the tp = 1 engine's == a forward argmax, a LoRA
              adapter through the handle == an engine on the merged
              params, a follower SIGKILLed and the whole gang replaced
              on the card, the next requests exact. Then both
              disaggregated pools as gangs (four processes at 0.25
              GPU): a bf16 burst of those 12 requests at 16 tokens
              each timed, K1 on both
              decode ranks, each one-page handoff as many bytes as
              phase 19's; fp32 tokens of a 300-token prompt == the
              monolithic engine's, its sealed handoff full width and
              within 1e-4 of the tp = 1 export; no runtime process
              outlives the phase.
21. data    — the data library (`ray_tpu_torch.data`, numpy column
              blocks) on the port's runtime. `build_llm_processor`
              (tokenize, engine, detokenize stages) over `from_items` of
              256 byte-tokenizer prompts of 127 tokens in 4 blocks:
              llama-125m bf16 at the serve phase's engine shape, 64 greedy
              tokens each, its engine stage one actor reserving the card
              (its class the probe `ProbeEngine`, which puts the actor's
              launch counts into the runtime's KV): every row back in
              input order with its prompt, K1 12 launches per decode step
              of the actor and no plain run, tokens/s over the
              processor's wall beside phases 4 and 18, the time to the
              first output row; fp32 through two actors at 0.5 GPU over
              uneven blocks: tokens == the in-process engine's == a
              forward argmax; a config reserving no GPU and one at tp = 2
              refused before any actor starts; the Trainer fed by
              `datasets={"train": from_numpy(tokens)}` through
              `iter_torch_batches(device="cuda")`: 6 bf16 steps of
              16 x 1024 beside phase 17's, K2-K4 12 launches a step in the
              worker and no plain run, every row seen once, fp32 losses
              through the dataset bit-equal to the same batches in this
              process; no runtime process outlives the phase.
22. parallel — sequence, expert and pipeline parallelism
              (`parallel.ring_attention`, `ulysses`, `pipeline.gpipe`, the
              model under sp and ep). (a) the kernel ring on one process
              at bench_sp_ring's shape (1 x 32768 x 8 x 128 bf16 causal,
              forward and backward of sum(out**2), a ring of one): one
              launch each of K2, K3 and K4 a call and no plain run, ms a
              call, TFLOP/s by bench_tpu.py's count, peak; held to the
              plain ring at 4096 tokens (bf16 and fp32). Then two
              processes over gloo on the one card: (b) the kernel ring
              (causal and full, fp32 and bf16, 2 x 4096 x 8 x 128) and
              Ulysses against the dense reference, outputs and
              gradients, K2-K4 launches per rank (causal: rank r r + 1;
              full: 2), and (a)'s shape split over the two; (c) the
              llama-125m bf16 train step with attn_impl="ring" at sp = 2
              on 1 x 32768 tokens (1 warm-up, 2 timed steps): ms/step,
              tokens/s, MFU, each rank's peak, K2-K4 12 and 24 a step on
              ranks 0 and 1 and no plain run, beside the same tokens on
              one process (a ring of one); fp32 2 x 512, 3 AdamW steps,
              ring and Ulysses at sp = 2 == the one-process step (1e-5
              losses, 2e-4 params); (d) ep = 2: mixtral_8x7b at depth 2
              bf16 (4 experts a rank), 2 x 1024 tokens, 3 steps, finite
              falling losses, each rank's peak; tiny_moe fp32 == the
              one-process step (1e-5); (e) GPipe at pp = 2: fp32 tanh
              stages at F = 768 == the sequential stages (1e-5 out, 1e-4
              grads); bf16 llama-125m's 12 layers as 2 stages of 6 over 8
              microbatches of 2 x 1024, forward and backward timed
              beside the 12 layers on one process.
23. dag     — compiled graphs, channels and collectives
              (`ray_tpu_torch.dag`, `experimental.channel`,
              `util.collective`) through the port's runtime, two stage
              actors at 0.5 GPU each: (a) one CUDA tensor hop through a
              `TensorChannel` (bf16 16 x 1024 x 768 and an int64 tensor),
              bytes equal, ms and GB/s; (b) the compiled two-stage
              llama-125m forward (embed and layers 0-5, then layers 6-11,
              the final norm and the fp32 head), the bf16 hidden states
              over a 48 MB tensor channel: last-position logits and every
              argmax bit-equal to this process's `forward` on 11
              executes, K2 6 launches per stage per execute and no plain
              run, ms per execute beside plain `.remote()` chains and the
              in-process forward; (c) an in-place allreduce of a 64 MB
              fp32 CUDA tensor (== this process's sum), the bf16 params
              broadcast into zeroed tensors (bit-equal, then equal
              forwards), a barrier; (d) phase 21's fp32 ingest fed by
              `from_torch` (losses == this process's) and the rows
              through `write_tfrecord` / `read_tfrecord`, equal.
24. rl      — RLlib's on-policy half (`ray_tpu_torch.rllib`), within
              120 s, each part under its own limit: (a) PPO on
              MinAtarBreakout-v0 at bench_rl_ppo's shape (one local runner
              of 16 envs acting on the CPU, fragments of 64, batch 1024,
              minibatch 256, 2 epochs, lr 3e-4), the learner on the card:
              env-steps/s, train_iter_ms, sample_ms, learner_update_ms,
              the learner's peak; learner params on CUDA, the acting copy
              on the CPU, losses finite; (b) PPO with the env on the card
              (JaxAtariClassBreakout-v0, the nature CNN over 84x84x4, 16
              envs, T 64): env-steps/s, ms an iteration, peak, the
              trajectory on CUDA, at most one synchronizing call (the
              metrics read) in an iteration; (c) IMPALA on the card at
              bench_rl_impala's shape, 6 iterations; (d) the on-card PPO
              iteration learns JaxMinAtarBreakout-v0 in 120 iterations
              (the last window's return per episode > 0.4); (e) one PPO
              and one IMPALA update of the nature CNN on the card against
              the CPU with TF32 switched on globally (losses 1e-5, params
              2e-4 with the entries past it counted and none past 2 lr);
              (f) IMPALA and APPO over two runner actors on the port's
              runtime with the learner on the card, a runner SIGKILLed
              and replaced, then two learner actors at 0.5 GPU == the
              local learner (1e-4 / 1e-5); no runtime process outlives it.
25. rl-offpolicy — RLlib's off-policy, offline, multi-agent and
              model-based half, within 150 s, each part under its own
              limit: (a) DQN on MinAtarBreakout-v0 at the config's
              defaults, one local runner of 8 envs: env-steps/s, ms an
              update, the learner's peak; one update card vs CPU with
              TF32 switched on globally (loss 1e-5, gradients 1e-5 of
              each leaf's largest, params 2 lr); (b) SAC on a numpy twin
              of Pendulum-v1 (`PendulumTwin`; the card's machine has no
              gymnasium) at the JAX test's config: the best mean of the
              last 10 returns > -900 within 220 iterations, ms a fused
              update, one fused update card vs CPU on fed normals; (c)
              offline: both policies recorded to JSON lines, CQL from the
              twin's file (a BC warm-up iteration, then critic_loss >
              bellman_loss), BC and MARWIL from the MinAtar file (BC's
              greedy actions match the recorded ones on >= 0.9 of the
              rows); (d) MultiAgentPPO on the cooperative env
              (`TargetMatchEnv`) over two runner actors, the learners on
              the card: return > 9 after 25 iterations, no runtime
              process left; (e) DreamerV3 on MinAtarFreeway-v0: the late
              return above max(1.25 x random, random + 0.3) within 90
              iterations, then one update at the default width timed and
              its synchronizing calls counted.
It prints the card's name and power limit, then one JSON line with the
kernels' numbers, then the result line
{"ok": true, "device": {"platform": "gpu", ...}} last.

It imports nothing of JAX or of the JAX package `ray_tpu`.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
TRAIN_BATCH, TRAIN_SEQ = 16, 1024   # the JAX train bench's shape


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls: the
    launches queue up behind a device-side sleep, so the events bracket
    device work only."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate(flops: float, ms: float, b_ms: float) -> str:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f} % of "
            f"the bound")


def tensor_core_counts(_build) -> dict | None:
    """{kernel: (HGMMA, HMMA)}: the tensor-core instructions (wgmma,
    mma.sync) in the SASS of each kernel of the built flash libraries, by
    `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = next((c for c in (os.path.join(home, "bin", "cuobjdump"),
                             shutil.which("cuobjdump"))
                 if c and os.path.exists(c)), None)
    if tool is None:
        return None
    counts = {}
    for src in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build._paths(src)[0])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                mangled = line.split("Function :", 1)[1].strip()
                name = re.search(r"(flash_[a-z_]+_kernel)I", mangled)
                width = re.search(r"Li(\d+)E", mangled)
                pad = re.search(r"Lb1E", mangled)
                fn = (f"{name.group(1) if name else mangled} "
                      f"{'bf16' if '__nv_bfloat16' in mangled else 'fp32'} "
                      f"D={width.group(1) if width else '?'}"
                      f"{' padded' if pad else ''}")
                counts[fn] = [0, 0]
            elif fn is not None:
                if "HGMMA" in line:
                    counts[fn][0] += 1
                elif "HMMA" in line:
                    counts[fn][1] += 1
    return {k: tuple(v) for k, v in counts.items()}


def flops_per_token(c, seq: int) -> float:
    """Analytic train FLOPs/token (a copy of bench_tpu.py's): 3x forward
    (fwd + 2x bwd), causal attention at average context S/2."""
    d, ff, L = c.d_model, c.d_ff, c.n_layers
    attn_proj = (d * (c.n_heads * c.head_dim)
                 + 2 * d * (c.n_kv_heads * c.head_dim)
                 + (c.n_heads * c.head_dim) * d)
    if c.moe_experts:
        mlp = 3 * d * ff * c.moe_top_k
    else:
        mlp = 3 * d * ff
    per_fwd = (2 * (attn_proj + mlp) * L
               + 2 * d * c.vocab                       # lm head
               + 2 * 2 * (seq / 2) * d * L)            # causal attention
    return 3 * per_fwd


def trace_summary(torch, prof, wall_us: float, label: str, smi: str,
                  top: int = 12, groups=()) -> dict:
    """Device busy time (union of device activity spans), idle share of
    the wall time and the device time by kernel, from a torch.profiler
    run; with `groups` ((label, name substrings), ...), also the device
    time of each group of kernels, a kernel counting in the first group
    one of whose substrings its name holds, the rest in "other"."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    log(f"  profiled {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
        f"device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {len(spans)} device activities [{smi}]")
    cuda = torch.autograd.DeviceType.CUDA
    rows = [r for r in prof.key_averages()
            if getattr(r, "device_type", None) == cuda
            and getattr(r, "self_device_time_total", 0) > 0]
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    for r in rows[:top]:
        log(f"    {r.self_device_time_total / 1e3:9.3f} ms  {r.count:6d}x  "
            f"{r.key[:90]}")
    sums = {}
    for r in rows:
        name = next((g for g, subs in groups
                     if any(x in r.key for x in subs)), "other")
        ms, n = sums.get(name, (0.0, 0))
        sums[name] = (ms + r.self_device_time_total / 1e3, n + r.count)
    if groups:
        log("  device time by group: " + "; ".join(
            f"{g} {ms:.3f} ms ({n} launches, {100e3 * ms / busy:.1f} % of "
            f"busy)" for g, (ms, n) in sums.items()))
    return dict(busy_us=busy, wall_us=wall_us, activities=len(spans),
                groups=sums)


# ---------------- phase 3: kernels ----------------


def k1_case(torch, B, h, hkv, hd, page, P, lengths, dtype, seed, layers=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = B * P + 1
    shape = (layers, hkv, N, page, hd)
    pk = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pv = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, h, hd, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
    tables = perm.reshape(B, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = (lens + page - 1) // page
    cols = torch.arange(P, device="cuda")[None]
    tables = torch.where(cols < used[:, None], tables, 0)  # scratch
    tables[1::7, 0] = 0          # a few used entries point at scratch too
    return q, pk, pv, lens, tables.contiguous()


def check_k1(torch, results):
    """K1 against its plain version at llama-125m (12/12), a tp = 2
    gang rank's half of it (6/6) and llama3-1b GQA (32/8) widths, g = 7
    and 8 at head_dim 128 (qwen2-7b's and
    llama3-70b's groups: 8 query heads in one block) and g = 16 at 64 (two
    row groups), bf16 and fp32, over lengths 0, 1, 63-65 and 127-129
    (chunk and split edges), page edges, 1024 and past the 8-page table;
    then the serving plan (P = 2) and 16-token pages (a two-stage ring of
    16-token chunks), both at 12/12 and at a tp = 2 rank's 6/6; each
    case under the plan `decode_plan` picks and,
    where that is another, under 8 splits; two calls must give the same
    bytes. Then the times at the serving shape and at a long context,
    beside the verify body's (K1') at S = 1, and every split count timed
    at the shapes the split rule is set from (`time_k1_plans`)."""
    from ray_tpu_torch.ops import paged_attention as PA
    errs = []
    rng_l = [0, 1, 63, 64, 65, 127, 128, 129, 1024, 255, 256, 257, 1100]
    g = torch.Generator().manual_seed(1)
    rng_l += torch.randint(1, 1025, (24,), generator=g).tolist()
    lens_serve = torch.randint(120, 200, (32,), generator=g).tolist()
    cases = [(label, h, hkv, hd, 128, 8, rng_l, dtype)
             for label, h, hkv, hd in (("llama-125m", 12, 12, 64),
                                       ("llama-125m tp=2 rank", 6, 6, 64),
                                       ("llama3-1b GQA", 32, 8, 64),
                                       ("g 7 hd 128", 28, 4, 128),
                                       ("g 8 hd 128", 64, 8, 128),
                                       ("g 16 hd 64", 32, 2, 64))
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(label, h, hkv, 64, 128, 2, lens_serve, dtype)
              for label, h, hkv in (("serving plan P 2", 12, 12),
                                    ("serving plan P 2, tp=2 rank", 6, 6))
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [("16-token pages", 16, 4, 128, 16, 16, [0, 1, 15, 16, 17, 63,
                                                       64, 65, 200, 255,
                                                       256, 300], dtype)
              for dtype in (torch.bfloat16, torch.float32)]
    for label, h, hkv, hd, page, P, lens_l, dtype in cases:
        q, pk, pv, lens, tables = k1_case(torch, len(lens_l), h, hkv, hd,
                                          page, P, lens_l, dtype, seed=2)
        want = PA.paged_decode_attention_reference(q, pk[0], pv[0], lens,
                                                   tables)
        dn = str(dtype).split(".")[1]
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        rule = PA.decode_plan(P, page, hd, q.element_size(), h // hkv,
                              len(lens_l) * hkv)
        eight = PA.decode_plan(P, page, hd, q.element_size(), h // hkv,
                               len(lens_l) * hkv, splits=8)
        outs = {}
        for pl in dict.fromkeys((rule, eight)):
            got = PA._paged_decode_cuda(q, pk[0], pv[0], lens, tables, pl)
            again = PA._paged_decode_cuda(q, pk[0], pv[0], lens, tables, pl)
            torch.cuda.synchronize()
            same = torch.equal(got.view(bits), again.view(bits))
            err = (got.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dn] and same
            log(f"  K1 paged_decode {label} ({h}/{hkv}, hd {hd}, page "
                f"{page}, P {P}: {pl.splits} splits of {pl.split_len}"
                f"{' (the rule)' if pl == rule else ''}, chunk {pl.chunk}, "
                f"{pl.stages} stage(s), {pl.row_groups} row group(s) of "
                f"{pl.rows}) {dn}: max_abs_err {err:.3e} (tol {TOL[dn]}), "
                f"two calls {'bit-equal' if same else 'DIFFER'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {label} {dn} disagrees: {err}, "
                                     f"deterministic {same}")
            errs.append(err)
            outs[pl] = got
        # the public entry point takes the rule's plan
        got = PA.paged_decode_attention(q, pk[0], pv[0], lens, tables)
        if not torch.equal(got.view(bits), outs[rule].view(bits)):
            raise AssertionError(f"K1 {label} {dn}: the entry point's output "
                                 f"differs from decode_plan's plan's")
        del q, pk, pv, got, again, want, outs
    # times at the serving path's shape (32 slots at lengths 128-191, a
    # 2-page table bucket) and at a long context (lengths 896-1023, 8
    # pages); 12 layers' pools visited in turn (a layer's working set,
    # 15.6 MB at the serving shape, would otherwise sit in L2)
    times = {}
    for label, lo, hi, P in (("lengths 128-191", 128, 192, 2),
                             ("long context, lengths 896-1023", 896, 1024,
                              8)):
        g = torch.Generator().manual_seed(3)
        lens_l = torch.randint(lo, hi, (32,), generator=g).tolist()
        q, pk, pv, lens, tables = k1_case(torch, 32, 12, 12, 64, 128, P,
                                          lens_l, torch.bfloat16, seed=4,
                                          layers=12)
        kern = lambda i: PA.paged_decode_attention(  # noqa: E731
            q, pk[i % 12], pv[i % 12], lens, tables)
        plain = lambda i: PA.paged_decode_attention_reference(  # noqa: E731
            q, pk[i % 12], pv[i % 12], lens, tables)
        ms = device_ms(torch, kern, 240)
        plain_ms = device_ms(torch, plain, 24)
        tokens = sum(min(x, P * 128) for x in lens_l)
        isz = 2
        nbytes = (tokens * 12 * 64 * 2 * isz          # K and V rows, once
                  + 2 * q.numel() * isz               # q in, out
                  + lens.numel() * 4 + tables.numel() * 4)
        flops = 4 * 12 * 64 * tokens                  # QK and PV
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        # the yardstick K1's design was chosen against: the verify body
        # (K1', one body for both modes as in the TPU kernel) at S = 1
        q1 = q[:, None].contiguous()
        k1p_ms = device_ms(torch, lambda i: PA.paged_verify_attention(
            q1, pk[i % 12], pv[i % 12], lens, tables), 240)
        log(f"  K1 time at 32x12x64 bf16, {label}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, the verify body (K1') at S = 1 "
            f"{k1p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{nbytes / 1e6:.1f} MB); {rate(flops, ms, b_ms)}")
        times[label] = (ms, plain_ms, b_ms, b_by)
        del q, q1, pk, pv
    time_k1_plans(torch)
    ms, plain_ms, b_ms, b_by = times["lengths 128-191"]
    results["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/paged_attention.py:78", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


def time_k1_plans(torch):
    """K1 under each split count (1, 2, 4, 8) beside the plan
    `decode_plan` picks, at the serving shape, a long context, few slots
    (1 and 4) and 32-page tables, at llama-125m's heads (12/12, hd 64),
    a tp = 2 gang rank's half of them at the serving shape (6/6) and
    llama3-8b's (32/8, hd 128), bf16: the measurements the split rule is
    set from. Each plan is held against the plain version before it is
    timed. Enough layers' pools are visited in turn that the K/V a run of
    calls reads is twice the card's 50 MB L2."""
    from ray_tpu_torch.ops import paged_attention as PA
    for label, B, h, hkv, hd, P, lo, hi in (
            ("serving", 32, 12, 12, 64, 2, 128, 192),
            ("serving, tp=2 rank", 32, 6, 6, 64, 2, 128, 192),
            ("long", 32, 12, 12, 64, 8, 896, 1024),
            ("4 slots", 4, 12, 12, 64, 2, 128, 192),
            ("4 slots long", 4, 12, 12, 64, 8, 896, 1024),
            ("1 slot", 1, 12, 12, 64, 2, 128, 192),
            ("1 slot long", 1, 12, 12, 64, 8, 896, 1024),
            ("1 slot 4k", 1, 12, 12, 64, 32, 3968, 4096),
            ("4 slots 4k", 4, 12, 12, 64, 32, 3968, 4096),
            ("llama3-8b 4 slots long", 4, 32, 8, 128, 8, 896, 1024),
            ("llama3-8b 32 slots long", 32, 32, 8, 128, 8, 896, 1024)):
        g = torch.Generator().manual_seed(5)
        lens_l = torch.randint(lo, hi, (B,), generator=g).tolist()
        tokens = sum(min(x, P * 128) for x in lens_l)
        nbytes = (tokens * hkv * hd * 2 * 2 + 2 * B * h * hd * 2
                  + B * 4 * (1 + P))
        layers = min(256, max(12, math.ceil(100e6 / nbytes)))
        q, pk, pv, lens, tables = k1_case(torch, B, h, hkv, hd, 128, P,
                                          lens_l, torch.bfloat16, seed=6,
                                          layers=layers)
        want = PA.paged_decode_attention_reference(q, pk[0], pv[0], lens,
                                                   tables)
        rule = PA.decode_plan(P, 128, hd, 2, h // hkv, B * hkv)
        cells = []
        for n in (1, 2, 4, 8):
            pl = PA.decode_plan(P, 128, hd, 2, h // hkv, B * hkv, splits=n)
            got = PA._paged_decode_cuda(q, pk[0], pv[0], lens, tables, pl)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL["bfloat16"]:
                raise AssertionError(f"K1 plan {pl} at {label}: {err}")
            ms = device_ms(torch, lambda i: PA._paged_decode_cuda(  # noqa: B023
                q, pk[i % layers], pv[i % layers], lens, tables, pl), 240)
            cells.append(f"{pl.splits}{'*' if pl == rule else ''} "
                         f"{ms * 1e3:.2f}")
        b_ms, _ = bound_ms(nbytes, 4 * h * hd * tokens, "bfloat16")
        log(f"  K1 splits at {label} (B {B}, {h}/{hkv}, hd {hd}, P {P}, "
            f"lengths {lo}-{hi - 1}; {layers} layers): us by splits "
            f"{'; '.join(cells)} (* the rule's); bound {b_ms * 1e3:.2f} us")
        del q, pk, pv, want, got


def verify_case(torch, B, S, h, hkv, hd, page, P, lengths, dtype, seed,
                layers=1, scratch_entries=True, zero_rows=()):
    """q [B, S, h, hd], pools [layers, hkv, N, page, hd], the new tokens'
    K/V [B, S, hkv, hd] and page tables covering every position a slot
    reads or writes (< lengths + S - 1, capped at P pages)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = B * P + 1
    shape = (layers, hkv, N, page, hd)
    pk = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pv = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, S, h, hd, generator=g, device="cuda").to(dtype)
    kn = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dtype)
    vn = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
    tables = perm.reshape(B, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = (lens + S - 1 + page - 1) // page
    cols = torch.arange(P, device="cuda")[None]
    tables = torch.where(cols < used[:, None], tables, 0)  # scratch
    if scratch_entries:
        tables[1::7, 0] = 0      # a few used entries point at scratch too
    for b in zero_rows:
        tables[b] = 0            # an inactive slot's row
    return q, pk, pv, kn, vn, lens, tables.contiguous()


def verify_work(lengths, S, page, P, h, hkv, hd, isz, insert):
    """(bytes, flops) a verify call must move and do: each attended K/V
    row read once per kv head (K5: rows below lengths-1 from the pool, the
    S new rows from knew/vnew, and the new rows written where they fall
    inside the P pages), q in, out written, lengths and tables; 4*hd
    flops per (query head, position) pair."""
    cap = P * page
    row = hkv * hd * 2 * isz                     # one token's K and V
    nbytes = 2 * len(lengths) * S * h * hd * isz + 4 * len(lengths) * (1 + P)
    pairs = 0
    for n in lengths:
        pairs += sum(min(n + j, cap) for j in range(S))
        if insert:
            base = n - 1
            nbytes += (min(max(base, 0), cap) + S) * row
            nbytes += sum(0 <= base + j < cap for j in range(S)) * row
        else:
            nbytes += min(n + S - 1, cap) * row
    return nbytes, 4 * hd * h * pairs


def check_verify(torch, results):
    """K1' (paged verify) and K5 (fused verify-insert) against their
    plain versions at llama-125m (12/12), llama3-1b GQA (32/8) and a
    head_dim 128 GQA (16/8) shape, S = 5, lengths at page edges and a
    slot whose queries and writes run past the 8-page table. K5 works on
    layer 1 of 2 with one all-zero table row (an inactive slot, which
    writes scratch page 0: its attention reads scratch that other slots'
    writes race with, so it is left out of the attention comparison); its
    written pools must equal the plain insert's bit for bit on every page
    but scratch. Also 40 query rows per kv head (32/4: one row group),
    42 (28/4 at hd 128, S 6: qwen2-7b's g at spec_k 5) and 48 (64/8 at hd
    128, S 6: llama3-70b's) in two row groups. Then the times at the
    serving shape and at a long context."""
    from ray_tpu_torch.ops import paged_attention as PA
    errs = {"k1p": [], "k5": []}
    rng_l = [1, 127, 128, 129, 1024, 255, 256, 257]
    g = torch.Generator().manual_seed(1)
    rng_l += torch.randint(1, 1025, (24,), generator=g).tolist()
    for label, h, hkv, hd, S in (("llama-125m", 12, 12, 64, 5),
                                 ("llama3-1b GQA", 32, 8, 64, 5),
                                 ("hd 128 GQA", 16, 8, 128, 5),
                                 ("40 rows per kv head", 32, 4, 64, 5),
                                 ("42 rows per kv head", 28, 4, 128, 6),
                                 ("48 rows per kv head", 64, 8, 128, 6)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, pk, pv, _kn, _vn, lens, tables = verify_case(
                torch, 32, S, h, hkv, hd, 128, 8, rng_l, dtype, seed=2)
            got = PA.paged_verify_attention(q, pk[0], pv[0], lens, tables)
            want = PA.paged_verify_attention_reference(q, pk[0], pv[0],
                                                       lens, tables)
            torch.cuda.synchronize()
            e1 = (got.float() - want.float()).abs().max().item()
            del q, pk, pv, got, want

            q, pk, pv, kn, vn, lens, tables = verify_case(
                torch, 32, S, h, hkv, hd, 128, 8, rng_l, dtype, seed=3,
                layers=2, scratch_entries=False, zero_rows=(5,))
            rk, rv = pk.clone(), pv.clone()
            got, ok_k, ok_v = PA.paged_verify_insert_attention(
                q, pk, pv, kn, vn, lens, tables, 1)
            want, _, _ = PA.paged_verify_insert_reference(
                q, rk, rv, kn, vn, lens, tables, 1)
            torch.cuda.synchronize()
            keep = torch.arange(32, device="cuda") != 5
            e5 = (got[keep].float() - want[keep].float()).abs().max().item()
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = all(torch.equal(a[:, :, 1:].view(bits),
                                   b[:, :, 1:].view(bits))
                       for a, b in ((pk, rk), (pv, rv)))
            aliased = ok_k is pk and ok_v is pv
            ok = all(math.isfinite(x) and x <= TOL[dn] for x in (e1, e5))
            log(f"  K1' paged_verify {label} hd {hd} S {S} "
                f"({PA.verify_plan(h // hkv, S)[0]} row group(s)) {dn}: "
                f"max_abs_err "
                f"{e1:.3e}; K5 paged_verify_insert: max_abs_err {e5:.3e} "
                f"(tol {TOL[dn]}), pool bytes on pages 1-{pk.shape[2] - 1} "
                f"of both layers {'equal' if same else 'DIFFER'} to the "
                f"plain insert's {'ok' if ok and same and aliased else 'FAIL'}")
            if not (ok and same and aliased):
                raise AssertionError(f"K1'/K5 {label} {dn} disagree: "
                                     f"{e1} {e5} bytes equal {same}")
            errs["k1p"].append(e1)
            errs["k5"].append(e5)
            del q, pk, pv, kn, vn, rk, rv, got, want

    # times at the spec serving path's shape (32 slots x S = 5, lengths
    # 128-191, a 2-page table bucket) and at a long context (lengths
    # 896-1023, 8 pages); 12 layers' pools visited in turn
    times = {}
    for label, lo, hi, P in (("lengths 128-191", 128, 192, 2),
                             ("long context, lengths 896-1023", 896, 1024,
                              8)):
        times[label] = time_verify(torch, PA, 5, lo, hi, P, label,
                                   unfused=P == 2)
    for name, line, key in (
            ("paged_verify", "ray_tpu/ops/paged_attention.py:504", "k1p"),
            ("paged_verify_insert", "ray_tpu/ops/paged_attention.py:211",
             "k5")):
        ms, plain_ms, b_ms, b_by = times["lengths 128-191"][key]
        results[name] = dict(
            name=name, route="cuda",
            source="ray_tpu_torch/ops/csrc/paged_verify.cu", replaces=line,
            launches=None, max_abs_err=max(errs[key]), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)


def time_verify(torch, PA, S, lo, hi, P, label, unfused):
    """K1' and K5 device times at 32 slots x S x 12 x 64 bf16 with lengths
    in [lo, hi) and P-page tables, beside their plain versions and
    bounds; with `unfused`, also the unfused pair (insert scatter, then
    K1'). Returns {"k1p" | "k5": (ms, plain_ms, bound_ms, bound_by)}."""
    g = torch.Generator().manual_seed(3)
    lens_l = torch.randint(lo, hi, (32,), generator=g).tolist()
    q, pk, pv, kn, vn, lens, tables = verify_case(
        torch, 32, S, 12, 12, 64, 128, P, lens_l, torch.bfloat16, seed=4,
        layers=12, scratch_entries=False)
    k1p_ms = device_ms(torch, lambda i: PA.paged_verify_attention(
        q, pk[i % 12], pv[i % 12], lens, tables), 240)
    k1p_plain = device_ms(torch, lambda i: PA.paged_verify_attention_reference(
        q, pk[i % 12], pv[i % 12], lens, tables), 24)
    k5_ms = device_ms(torch, lambda i: PA.paged_verify_insert_attention(
        q, pk, pv, kn, vn, lens, tables, i % 12), 240)
    k5_plain = device_ms(torch, lambda i: PA.paged_verify_insert_reference(
        q, pk, pv, kn, vn, lens, tables, i % 12), 24)
    out = {}
    for name, src, ms, plain_ms, insert, key in (
            ("paged_verify", "K1'", k1p_ms, k1p_plain, False, "k1p"),
            ("paged_verify_insert", "K5", k5_ms, k5_plain, True, "k5")):
        nbytes, flops = verify_work(lens_l, S, 128, P, 12, 12, 64, 2, insert)
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        log(f"  {src} {name} time at 32 x {S} x 12 x 64 bf16, {label}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP); {rate(flops, ms, b_ms)}")
        out[key] = (ms, plain_ms, b_ms, b_by)
    if unfused:
        def pair(i):      # the insert as a scatter, then K1'
            PA.insert_tokens_reference(pk, pv, kn, vn, lens, tables, i % 12)
            return PA.paged_verify_attention(q, pk[i % 12], pv[i % 12],
                                             lens, tables)
        pair_ms = device_ms(torch, pair, 120)
        log(f"  unfused pair (index_put_ insert of the {S} rows, then K1'): "
            f"{pair_ms:.4f} ms vs K5 {k5_ms:.4f} ms; no single PyTorch call "
            f"computes either kernel's function")
    return out


def check_k2(torch, results):
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as A
    cases = [  # (B, S, H, Hkv, D, causal, dtypes)
        (8, 1024, 12, 12, 64, True, (torch.bfloat16, torch.float32)),
        (8, 1024, 12, 12, 64, False, (torch.bfloat16,)),
        (2, 1000, 12, 4, 64, True, (torch.bfloat16, torch.float32)),
        (2, 1000, 12, 4, 64, False, (torch.float32,)),
        (2, 1000, 16, 8, 128, True, (torch.bfloat16,)),
        (2, 1000, 16, 8, 128, False, (torch.float32,)),
    ]
    # the bf16 (tensor-core) body at the edges of its 64-row tiles
    cases += [(2, S, H, Hkv, D, causal, (torch.bfloat16,))
              for S in (1, 63, 65, 129, 1000)
              for H, Hkv, D in ((12, 4, 64), (16, 8, 128))
              for causal in (True, False)]
    errs = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for B, S, H, Hkv, D, causal, dtypes in cases:
        for dtype in dtypes:
            q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
            v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
            got = A.flash_attention(q, k, v, causal=causal, impl="pallas")
            want = A.flash_attention(q, k, v, causal=causal,
                                     impl="reference")
            torch.cuda.synchronize()
            dn = str(dtype).split(".")[1]
            err = (got.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dn]
            log(f"  K2 flash_fwd [{B},{S},{H}/{Hkv},{D}] "
                f"{'causal' if causal else 'full'} {dn}: max_abs_err "
                f"{err:.3e} (tol {TOL[dn]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 case disagrees: {err}")
            errs.append(err)
            del q, k, v, got, want
    # lse output: flat [B*H, S], equal to the plain logsumexp
    q = torch.randn(2, 300, 4, 64, generator=g, device="cuda")
    k = torch.randn(2, 300, 2, 64, generator=g, device="cuda")
    _, lse = A.flash_attention_fwd(q, k, k, True, 0.125, with_lse=True)
    kk = k.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 0.125
    s = s.masked_fill(~torch.ones(300, 300, dtype=torch.bool,
                                  device="cuda").tril(), float("-inf"))
    lse_err = (lse - torch.logsumexp(s, -1).reshape(8, 300)).abs().max()
    log(f"  K2 lse [2,300,4/2,64] causal fp32: max_abs_err "
        f"{lse_err.item():.3e} (tol 1e-4)")
    if not lse_err.item() <= 1e-4:
        raise AssertionError("K2 lse disagrees")

    B, S, H, D = 8, 1024, 12, 64
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = device_ms(torch, lambda i: A.flash_attention_fwd(
        q, k, v, True, D ** -0.5), 20)
    plain_ms = device_ms(torch, lambda i: A.flash_attention(
        q, k, v, causal=True, impl="reference"), 5)
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    nbytes = 4 * B * S * H * D * 2
    flops = 4 * B * H * D * S * (S + 1) // 2
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"  K2 time at [8,1024,12,64] causal bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); {rate(flops, ms, b_ms)}")
    results["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:34", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)


def attn_case(torch, g, B, S, H, Hkv, D, dtype, grad_scale=1.0):
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    do = (torch.randn(B, S, H, D, generator=g, device="cuda")
          * grad_scale).to(dtype)
    return q, k, v, do


def scaled_err(got, want, abs_errs: list) -> float:
    """max |got - want| over max(1, max |want|): the error relative to
    the reference's scale. Appends the absolute error to `abs_errs`."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    abs_errs.append(err)
    return err / max(1.0, want.abs().max().item())


def check_k3_k4(torch, results):
    """The dQ (K3) and dK/dV (K4) kernels against the plain backward on
    the same (o, lse) from the forward kernel, over causal/full, bf16/fp32,
    the 125M shape, a ragged S with GQA 12/4, head_dim 128 with GQA 16/8
    and S = 1 (one key per row: no row may come out NaN); in fp32 also
    against autograd of the plain forward; in bf16 also at S = 1, 63, 65
    and 129 (the edges of the 64-key tile and of K4's 64- or 32-query
    tiles) with GQA 12/4 at head_dim 64 and 16/8 at 128. Then the times
    at the train shape."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(6)
    errs = {"dq": [], "dk": [], "dv": []}     # absolute, for the JSON line
    cases = [(B, S, H, Hkv, D, (torch.bfloat16, torch.float32))
             for B, S, H, Hkv, D in ((8, 1024, 12, 12, 64),
                                     (2, 1000, 12, 4, 64),
                                     (2, 1000, 16, 8, 128), (2, 1, 4, 2, 64))]
    cases += [(2, S, H, Hkv, D, (torch.bfloat16,)) for S in (1, 63, 65, 129)
              for H, Hkv, D in ((12, 4, 64), (16, 8, 128))]
    for B, S, H, Hkv, D, dtypes in cases:
        for causal in (True, False):
            for dtype in dtypes:
                dn = str(dtype).split(".")[1]
                scale = D ** -0.5
                q, k, v, do = attn_case(torch, g, B, S, H, Hkv, D, dtype)
                o, lse = A.flash_attention_fwd(q, k, v, causal, scale,
                                               with_lse=True)
                dq, dk, dv = A.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal, scale)
                want = A.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                       causal, scale)
                torch.cuda.synchronize()
                e = [scaled_err(a, b, errs[n]) for a, b, n in
                     zip((dq, dk, dv), want, errs)]
                line = (f"dq {e[0]:.3e}, dk {e[1]:.3e}, dv {e[2]:.3e}")
                if dtype == torch.float32:
                    # independent: autograd of the plain dense forward
                    leaves = [x.detach().requires_grad_(True)
                              for x in (q, k, v)]
                    out = A.flash_attention(*leaves, causal=causal,
                                            scale=scale, impl="reference")
                    auto = torch.autograd.grad(out, leaves, do)
                    ea = [scaled_err(a, b, errs[n]) for a, b, n in
                          zip((dq, dk, dv), auto, errs)]
                    e += ea
                    line += f"; vs autograd {max(ea):.3e}"
                    del leaves, out, auto
                ok = all(math.isfinite(x) and x <= TOL[dn] for x in e)
                log(f"  K3/K4 flash_bwd [{B},{S},{H}/{Hkv},{D}] "
                    f"{'causal' if causal else 'full'} {dn}: {line} "
                    f"(tol {TOL[dn]} of the reference's scale) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"K3/K4 case disagrees: {e}")
                del q, k, v, do, o, lse, dq, dk, dv, want

    # times at the train shape, causal bf16
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    scale = D ** -0.5
    q, k, v, do = attn_case(torch, g, B, S, H, H, D, torch.bfloat16)
    o, lse = A.flash_attention_fwd(q, k, v, True, scale, with_lse=True)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, S).contiguous())
    fwd_ms = device_ms(torch, lambda i: A.flash_attention_fwd(
        q, k, v, True, scale, with_lse=True), 10)
    dq_ms = device_ms(torch, lambda i: A.flash_bwd_dq(
        q, k, v, do, lse, delta, True, scale), 10)
    dkv_ms = device_ms(torch, lambda i: A.flash_bwd_dkv(
        q, k, v, do, lse, delta, True, scale), 10)
    plain_ms = device_ms(torch, lambda i: A.flash_attention_bwd_reference(
        q, k, v, o, lse, do, True, scale), 3)
    # The library yardstick: scaled_dot_product_attention's backward
    # (dQ, dK and dV in one call), timed as forward + backward minus
    # forward.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    sdpa_fwd = device_ms(torch, lambda i: sdpa(), 20)
    sdpa_fb = device_ms(torch, lambda i: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), 20)
    lib_ms = sdpa_fb - sdpa_fwd
    pairs = B * H * S * (S + 1) // 2
    isz, row_bytes = 2, 2 * B * H * S * 4           # lse + delta, fp32
    tensor = B * S * H * D * isz
    fwd_b = bound_ms(4 * tensor + B * H * S * 4, 2 * 2 * D * pairs,
                     "bfloat16")
    dq_b = bound_ms(5 * tensor + row_bytes, 3 * 2 * D * pairs, "bfloat16")
    dkv_b = bound_ms(6 * tensor + row_bytes, 4 * 2 * D * pairs, "bfloat16")
    log(f"  K2 with lse at [{B},{S},{H},{D}] causal bf16: kernel "
        f"{fwd_ms:.4f} ms, bound {fwd_b[0]:.4f} ms ({fwd_b[1]}); "
        f"sdpa forward {sdpa_fwd:.4f} ms; "
        f"{rate(2 * 2 * D * pairs, fwd_ms, fwd_b[0])}")
    log(f"  K3 dq at [{B},{S},{H},{D}] causal bf16: kernel {dq_ms:.4f} ms, "
        f"bound {dq_b[0]:.4f} ms ({dq_b[1]}; "
        f"{3 * 2 * D * pairs / 1e9:.2f} GFLOP, "
        f"{(5 * tensor + row_bytes) / 1e6:.1f} MB); "
        f"{rate(3 * 2 * D * pairs, dq_ms, dq_b[0])}")
    log(f"  K4 dkv at [{B},{S},{H},{D}] causal bf16: kernel {dkv_ms:.4f} ms, "
        f"bound {dkv_b[0]:.4f} ms ({dkv_b[1]}; "
        f"{4 * 2 * D * pairs / 1e9:.2f} GFLOP, "
        f"{(6 * tensor + row_bytes) / 1e6:.1f} MB); "
        f"{rate(4 * 2 * D * pairs, dkv_ms, dkv_b[0])}")
    log(f"  plain backward (dq, dk, dv together) {plain_ms:.4f} ms; sdpa "
        f"backward {lib_ms:.4f} ms (forward+backward {sdpa_fb:.4f} ms minus "
        f"forward {sdpa_fwd:.4f} ms; one call for dq, dk and dv)")
    results["flash_fwd_lse_train"] = dict(ms=fwd_ms, bound_ms=fwd_b[0],
                                          library_ms=sdpa_fwd)
    for name, src_line, ms, (b_ms, b_by), key in (
            ("flash_bwd_dq", "ray_tpu/ops/attention.py:139", dq_ms, dq_b,
             "dq"),
            ("flash_bwd_dkv", "ray_tpu/ops/attention.py:177", dkv_ms, dkv_b,
             "dkv")):
        results[name] = dict(
            name=name, route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_bwd.cu", replaces=src_line,
            launches=None,
            max_abs_err=max(errs["dq"] if key == "dq"
                            else errs["dk"] + errs["dv"]), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms)


HEAD_DIMS = (16, 32, 80, 8, 120, 136, 192, 256, 12, 100, 264, 384, 520)


def check_head_dims(torch, results, hds=HEAD_DIMS):
    """Every kernel at head_dims other than 64 and 128: hd 16 and 32
    (configs.tiny() and the engine tests' models), 80 (not a power of
    two), 8 and 120 (the ends of the two narrow instantiations), 136, 192
    and 256 (the D = 256 bodies, 256 the head width of Gemma-2-class
    models), 12 and 100 (no multiple of 8: the wrappers zero-pad q to 16
    and 104; the paged kernels read pools allocated at the padded width,
    as the engines allocate them) and 264, 384 and 520 (past 256:
    the chunked flash bodies, the paged bodies with their PV sums in
    shared memory; 520 past K1's 512 columns of one turn), bf16 and fp32,
    against the plain versions within TOL: K1 under its plan and under 8
    splits, K1' and K5 (K5's written pools bit-equal to the plain
    insert's), K2 causal and
    full at S = 1, 65 and 300, K3/K4 at S = 65 and 300. Their errors join
    each kernel's max_abs_err."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import paged_attention as PA
    from ray_tpu_torch.ops._build import padded_head_dim
    errs = {k: [] for k in ("paged_decode", "paged_verify",
                            "paged_verify_insert", "flash_fwd",
                            "flash_bwd_dq", "flash_bwd_dkv")}
    lens_l = [0, 1, 15, 16, 17, 127, 128, 129, 300, 511, 512, 600]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for hd in hds:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            line = []
            d8 = padded_head_dim(hd)
            # the pools at the padded width with zero columns, as the
            # engines allocate them (the plain versions read them at hd)
            widen = lambda t: F.pad(t, (0, d8 - hd))  # noqa: E731
            # K1: 8 query heads over 4 kv heads, 16-token pages x 32 and
            # 128-token pages x 5
            e = 0.0
            for page, P in ((16, 32), (128, 5)):
                q, pk, pv, lens, tables = k1_case(torch, len(lens_l), 8, 4,
                                                  hd, page, P, lens_l, dtype,
                                                  seed=12)
                want = PA.paged_decode_attention_reference(q, pk[0], pv[0],
                                                           lens, tables)
                pk, pv = widen(pk), widen(pv)
                for splits in (0, 8):
                    pl = PA.decode_plan(P, page, d8, q.element_size(), 2,
                                        len(lens_l) * 4, splits=splits)
                    got = PA._paged_decode_cuda(q, pk[0], pv[0], lens,
                                                tables, pl)
                    e = max(e, (got.float() - want.float()).abs().max()
                            .item())
                del q, pk, pv, want, got
            errs["paged_decode"].append(e)
            line.append(f"K1 {e:.2e}")
            # K1' and K5: S = 5, 128-token pages, 8-page tables; a verify
            # step always has its pending token: lengths >= 1
            vlens = [max(x, 1) for x in lens_l]
            q, pk, pv, _kn, _vn, lens, tables = verify_case(
                torch, len(vlens), 5, 8, 4, hd, 128, 8, vlens, dtype,
                seed=13)
            want = PA.paged_verify_attention_reference(q, pk[0], pv[0],
                                                       lens, tables)
            pk, pv = widen(pk), widen(pv)
            got = PA.paged_verify_attention(q, pk[0], pv[0], lens, tables)
            e = (got.float() - want.float()).abs().max().item()
            q, pk, pv, kn, vn, lens, tables = verify_case(
                torch, len(vlens), 5, 8, 4, hd, 128, 8, vlens, dtype,
                seed=14, layers=2, scratch_entries=False, zero_rows=(5,))
            pk, pv = widen(pk), widen(pv)
            rk, rv = pk.clone(), pv.clone()
            got, _, _ = PA.paged_verify_insert_attention(
                q, pk, pv, kn, vn, lens, tables, 1)
            want, _, _ = PA.paged_verify_insert_reference(
                q, rk, rv, kn, vn, lens, tables, 1)
            keep = torch.arange(len(vlens), device="cuda") != 5
            e5 = (got[keep].float() - want[keep].float()).abs().max().item()
            same = all(torch.equal(a[:, :, 1:].view(bits),
                                   b[:, :, 1:].view(bits))
                       for a, b in ((pk, rk), (pv, rv)))
            del q, pk, pv, kn, vn, rk, rv, got, want
            errs["paged_verify"].append(e)
            line.append(f"K1' {e:.2e}")
            errs["paged_verify_insert"].append(e5)
            line.append(f"K5 {e5:.2e} (pools "
                        f"{'equal' if same else 'DIFFER'})")
            # K2, K3/K4: GQA 4/2
            e2, e34 = 0.0, [0.0, 0.0, 0.0]
            for S in (1, 65, 300):
                for causal in (True, False):
                    q, k, v, do = attn_case(torch, gen, 2, S, 4, 2, hd, dtype)
                    got = A.flash_attention(q, k, v, causal=causal,
                                            impl="pallas")
                    want = A.flash_attention(q, k, v, causal=causal,
                                             impl="reference")
                    e2 = max(e2, (got.float() - want.float()).abs().max()
                             .item())
                    if S > 1:
                        scale = hd ** -0.5
                        o, lse = A.flash_attention_fwd(q, k, v, causal, scale,
                                                       with_lse=True)
                        grads = A.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal, scale)
                        ref = A.flash_attention_bwd_reference(
                            q, k, v, o, lse, do, causal, scale)
                        for j in range(3):
                            e34[j] = max(e34[j], scaled_err(grads[j], ref[j],
                                                            []))
                    del q, k, v, do, got, want
            errs["flash_fwd"].append(e2)
            errs["flash_bwd_dq"].append(e34[0])
            errs["flash_bwd_dkv"].append(max(e34[1:]))
            line.append(f"K2 {e2:.2e}; K3 {e34[0]:.2e}, K4 {max(e34[1:]):.2e} "
                        f"(of the reference's scale)")
            torch.cuda.synchronize()
            worst = max(x[-1] for x in errs.values())
            ok = math.isfinite(worst) and worst <= TOL[dn] and same
            log(f"  head_dim {hd} {dn}: {'; '.join(line)} (tol {TOL[dn]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"head_dim {hd} {dn}: a kernel "
                                     f"disagrees ({line})")
    for name, e in errs.items():
        if name in results:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               max(e))


# ---------------- phases 4-5: the main path ----------------


def reset_counts():
    from ray_tpu_torch.ops import attention, paged_attention
    for d in (attention.launches, attention.bwd_dq_launches,
              attention.bwd_dkv_launches, paged_attention.launches,
              paged_attention.verify_launches,
              paged_attention.verify_insert_launches):
        for key in d:
            d[key] = 0


def serve_phase(torch, results, smi):
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = configs.bench_125m()
    ecfg = EngineConfig(max_slots=32, max_len=1024, prompt_buckets=(128,),
                        eos_token=-1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    eng = InferenceEngine(cfg, ecfg, params=params, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 127).tolist() for _ in range(32)]
    shared = rng.integers(1, cfg.vocab, 128).tolist()
    prompts += [shared + rng.integers(1, cfg.vocab, 16).tolist()
                for _ in range(4)]
    eng.generate(prompts[:2], max_new_tokens=4)    # warm library handles
    torch.cuda.synchronize()
    steps0 = eng.decode_steps
    hits0 = eng.kv_stats()["prefix_hits"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=64, temperature=0.0)
            for p in prompts]
    while eng.has_work():
        eng.step_window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(PA.launches)
    steps = eng.decode_steps - steps0
    gen = [eng.finished[r].generated for r in rids]
    n_tok = sum(len(x) for x in gen)
    stats = eng.kv_stats()
    peak = torch.cuda.max_memory_allocated()
    log(f"  served {len(rids)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s; {steps} decode steps; prefix hits "
        f"{stats['prefix_hits'] - hits0}; peak device memory "
        f"{peak / 2**30:.3f} GiB; K1 launches {launches['cuda']}, plain "
        f"{launches['plain']} [{smi}]")
    if any(len(x) != 64 for x in gen):
        raise AssertionError("a request did not finish with 64 tokens")
    if any(not 0 <= t < cfg.vocab for x in gen for t in x):
        raise AssertionError("token out of vocabulary range")
    if stats["prefix_hits"] - hits0 < 4:
        raise AssertionError(f"expected prefix hits, got {stats}")
    if launches["cuda"] != cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"K1 launches {launches['cuda']} != "
                             f"{cfg.n_layers} x {steps} decode steps")
    if launches["plain"] != 0:
        raise AssertionError("the plain paged path ran on the card")
    results["paged_decode"]["launches"] = launches["cuda"]
    return dict(tokens_per_s=n_tok / wall, wall_s=wall, decode_steps=steps,
                peak_bytes=peak, tokens=gen, prompts=prompts), eng, \
        prompts[:32]


def profile_phase(torch, eng, prompts, smi):
    """Where the serve path's time goes: a host-clock split of admission
    (batched prefill of 32 prompts + one decode step) and one 64-step
    decode window, then a torch.profiler trace of a shorter run for the
    device's busy time and its time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    rids = [eng.add_request(p, max_new_tokens=65, temperature=0.0)
            for p in prompts]
    torch.cuda.synchronize()
    s0 = eng.decode_steps
    t0 = time.perf_counter()
    eng.step()                       # admission + one decode step
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.step_window()                # one window
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    win = eng.decode_steps - s0 - 1
    while eng.has_work():
        eng.step_window()
    if any(len(eng.finished[r].generated) != 65 for r in rids):
        raise AssertionError("profile run: a request did not finish")
    log(f"  admission (32 x 127-token prefill + 1 decode step) "
        f"{(t1 - t0) * 1e3:.2f} ms; decode window of {win} steps "
        f"{(t2 - t1) * 1e3:.2f} ms = {(t2 - t1) * 1e3 / win:.3f} ms/step, "
        f"{32 * win / (t2 - t1):.1f} tokens/s [{smi}]")

    for p in prompts:
        eng.add_request(p, max_new_tokens=17, temperature=0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step_window()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace_summary(torch, prof, wall_us, "32 x 17 tokens", smi, groups=(
        ("K1 decode", ("paged_decode",)),
        ("fp32 products (logits heads)", ("sgemm", "f32f32")),
        ("bf16 products", ("gemm", "nvjet"))))


def no_sync_check(torch, eng):
    """A decode window never waits for the device: one 4-step window with
    sampling, top-k/top-p and logprobs on, run with CUDA sync debugging
    set to raise on any synchronizing call. (Writes pages 1-32 of the
    engine's pool: run it last on that engine.)"""
    from ray_tpu_torch.llm.engine import decode_weights, decode_window
    dev, B = eng.device, eng.e.max_slots
    fused = decode_weights(eng.params, eng.c)
    gen = torch.Generator(device=dev).manual_seed(0)
    args = dict(
        tokens=torch.arange(1, B + 1, dtype=torch.int32, device=dev),
        lengths=torch.full((B,), 10, dtype=torch.int32, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        page_tables=torch.arange(1, B + 1, dtype=torch.int32,
                                 device=dev)[:, None],
        temps=torch.full((B,), 0.7, device=dev),
        top_ps=torch.full((B,), 0.9, device=dev),
        top_ks=torch.full((B,), 50, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _t, lens, _a, out, logps = decode_window(
            eng.params, eng.cache_k, eng.cache_v, gtables=None,
            gstates=None, generator=gen, config=eng.c, eos_token=-1,
            n_steps=4, trunc=True, guided=False, want_logp=True,
            fused=fused, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out, logps, lens = out.cpu(), logps.cpu(), lens.cpu()
    if (out.shape != (4, B) or not ((out >= 0) & (out < eng.c.vocab)).all()
            or not (logps <= 0).all() or not (lens == 14).all()):
        raise AssertionError("no-sync window returned bad tokens/state")
    log("  decode window: 4 steps with top-k/top-p sampling and logprobs, "
        "no host synchronization (CUDA sync debug mode 'error')")


def spec_serve_phase(torch, results, smi, params, serve):
    """The serve phase's requests and weights through the speculative
    engine: every request finishes, K5 runs 12 times per verify step (K1
    12 times per step of any plain fallback window) and no plain version
    runs; then a torch.profiler trace of the speculative serve path."""
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = configs.bench_125m()
    ecfg = EngineConfig(max_slots=32, max_len=1024, prompt_buckets=(128,),
                        eos_token=-1, speculation="ngram", spec_k=4)
    eng = InferenceEngine(cfg, ecfg, params=params, seed=0, device="cuda")
    prompts = serve["prompts"]
    eng.generate(prompts[:2], max_new_tokens=4)    # warm library handles
    torch.cuda.synchronize()
    st0 = eng.kv_stats()
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=64, temperature=0.0)
            for p in prompts]
    while eng.has_work():
        eng.step_window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k1p, k5 = (dict(PA.launches), dict(PA.verify_launches),
                   dict(PA.verify_insert_launches))
    st = eng.kv_stats()
    vsteps = st["verify_steps"] - st0["verify_steps"]
    dsteps = st["decode_steps"] - st0["decode_steps"]
    drafted = st["spec_drafted"] - st0["spec_drafted"]
    accepted = st["spec_accepted"] - st0["spec_accepted"]
    gen = [eng.finished[r].generated for r in rids]
    n_tok = sum(len(x) for x in gen)
    same_req = sum(a == b for a, b in zip(gen, serve["tokens"]))
    same_tok = sum(x == y for a, b in zip(gen, serve["tokens"])
                   for x, y in zip(a, b))
    log(f"  served {len(rids)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s (plain serve phase "
        f"{serve['tokens_per_s']:.1f}); {vsteps} verify steps, {dsteps} "
        f"plain decode steps; acceptance {accepted}/{drafted} = "
        f"{accepted / max(drafted, 1):.3f}; K5 launches {k5['cuda']}, plain "
        f"{k5['plain']}; K1 {k1}; K1' {k1p} [{smi}]")
    log(f"  bf16 agreement with the plain serve phase: {same_req}/"
        f"{len(gen)} requests identical, {same_tok}/{n_tok} tokens equal "
        f"position by position (printed, not held: bf16 products over "
        f"[B*5, d] and [B, d] may round differently)")
    if any(len(x) != 64 for x in gen):
        raise AssertionError("a speculative request did not finish with 64 "
                             "tokens")
    if any(not 0 <= t < cfg.vocab for x in gen for t in x):
        raise AssertionError("token out of vocabulary range")
    if vsteps == 0 or k5["cuda"] != cfg.n_layers * vsteps:
        raise AssertionError(f"K5 launches {k5['cuda']} != {cfg.n_layers} x "
                             f"{vsteps} verify steps")
    if k1["cuda"] != cfg.n_layers * dsteps:
        raise AssertionError(f"K1 launches {k1['cuda']} != {cfg.n_layers} x "
                             f"{dsteps} decode steps")
    if k5["plain"] or k1["plain"] or k1p["plain"]:
        raise AssertionError("a plain paged path ran on the card")
    results["paged_verify_insert"]["launches"] = k5["cuda"]
    results["paged_verify"]["launches"] = k1p["cuda"]

    for p in prompts[:32]:
        eng.add_request(p, max_new_tokens=17, temperature=0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step_window()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = trace_summary(torch, prof, wall_us, "speculative 32 x 17 tokens",
                          smi, groups=(
                              ("K5 verify-insert", ("paged_verify_insert",)),
                              ("K1 decode", ("paged_decode",)),
                              ("fp32 products (logits heads)",
                               ("sgemm", "f32f32")),
                              ("bf16 products", ("gemm", "nvjet"))))
    return dict(tokens_per_s=n_tok / wall, wall_s=wall, verify_steps=vsteps,
                acceptance=accepted / max(drafted, 1), **trace)


def spec_exact_phase(torch):
    """fp32 llama-125m: the speculative engine's greedy tokens equal the
    plain engine's and an argmax loop over `forward`, with drafts
    accepted; then the speculative window stays free of host syncs; then
    the same at 48 verify rows per kv head (`spec_rows_check`)."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    rng = np.random.default_rng(2)
    pattern = rng.integers(1, cfg.vocab, 6).tolist()
    prompts = [rng.integers(1, cfg.vocab, 20).tolist(),
               rng.integers(1, cfg.vocab, 57).tolist(),
               pattern * 8, pattern[:3] * 10]    # two repeating prompts
    n_new = 24
    ecfg = dict(max_slots=4, max_len=256, prompt_buckets=(128,),
                eos_token=-1)
    plain = InferenceEngine(cfg, EngineConfig(**ecfg), params=params,
                            device="cuda").generate(prompts, n_new, 0.0)
    eng = InferenceEngine(cfg, EngineConfig(**ecfg, speculation="ngram",
                                            spec_k=4),
                          params=params, device="cuda")
    reset_counts()
    got = eng.generate(prompts, n_new, 0.0)
    k5 = dict(PA.verify_insert_launches)
    st = eng.kv_stats()
    want = forward_argmax(torch, params, cfg, prompts, n_new)
    log(f"  fp32 greedy, {len(prompts)} prompts x {n_new} tokens: spec == "
        f"plain {got == plain}, spec == forward argmax {got == want}; "
        f"accepted {st['spec_accepted']}/{st['spec_drafted']} drafts over "
        f"{st['verify_steps']} verify steps; K5 launches {k5}")
    if got != plain or got != want:
        raise AssertionError(f"spec {got} != plain {plain} / forward {want}")
    if st["spec_accepted"] == 0:
        raise AssertionError("no draft was accepted")
    if k5 != {"cuda": cfg.n_layers * st["verify_steps"], "plain": 0}:
        raise AssertionError(f"K5 launches {k5} for {st['verify_steps']} "
                             f"verify steps")
    spec_no_sync_check(torch, eng)
    spec_rows_check(torch)


def forward_argmax(torch, params, cfg, prompts, n_new):
    """Greedy tokens of an argmax loop over the port's `forward`."""
    from ray_tpu_torch.models import forward
    want = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(n_new):
                logits = forward(params, torch.tensor([seq], device="cuda"),
                                 cfg)
                seq.append(int(logits[0, -1].argmax()))
            want.append(seq[len(p):])
    return want


def spec_rows_check(torch):
    """More than 40 verify rows through the engine: a 2-layer fp32 model
    with 8 query heads per kv head (16/2, head_dim 64) at spec_k 5
    verifies 8 x 6 = 48 query rows per kv head (K5 in two row groups).
    Its speculative greedy tokens must equal the plain engine's and an
    argmax loop over `forward`, with drafts accepted, K5 launched 2 times
    per verify step and no plain paged path run."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import ModelConfig, init_params
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = ModelConfig(vocab=32000, d_model=1024, n_layers=2, n_heads=16,
                      n_kv_heads=2, d_ff=2816, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cuda")
    rng = np.random.default_rng(3)
    pattern = rng.integers(1, cfg.vocab, 5).tolist()
    prompts = [rng.integers(1, cfg.vocab, 33).tolist(), pattern * 9,
               pattern[:2] * 12]                 # two repeating prompts
    n_new, spec_k = 24, 5
    ecfg = dict(max_slots=4, max_len=256, prompt_buckets=(128,),
                eos_token=-1)
    reset_counts()
    plain = InferenceEngine(cfg, EngineConfig(**ecfg), params=params,
                            device="cuda").generate(prompts, n_new, 0.0)
    k1 = dict(PA.launches)
    eng = InferenceEngine(cfg, EngineConfig(**ecfg, speculation="ngram",
                                            spec_k=spec_k),
                          params=params, device="cuda")
    reset_counts()
    got = eng.generate(prompts, n_new, 0.0)
    k5, k1p = dict(PA.verify_insert_launches), dict(PA.verify_launches)
    st = eng.kv_stats()
    want = forward_argmax(torch, params, cfg, prompts, n_new)
    rows = cfg.n_heads // cfg.n_kv_heads * (spec_k + 1)
    log(f"  fp32 greedy at g 8, spec_k {spec_k} ({rows} verify rows per kv "
        f"head, {PA.verify_plan(8, spec_k + 1)[0]} row groups): spec == "
        f"plain {got == plain}, spec == forward argmax {got == want}; "
        f"accepted {st['spec_accepted']}/{st['spec_drafted']} drafts over "
        f"{st['verify_steps']} verify steps; K5 launches {k5}; plain "
        f"engine's K1 launches {k1}")
    if got != plain or got != want:
        raise AssertionError(f"g 8 spec {got} != plain {plain} / forward "
                             f"{want}")
    if st["spec_accepted"] == 0:
        raise AssertionError("g 8: no draft was accepted")
    if k5 != {"cuda": cfg.n_layers * st["verify_steps"], "plain": 0}:
        raise AssertionError(f"g 8: K5 launches {k5} for "
                             f"{st['verify_steps']} verify steps")
    if k1p["plain"] or k1["plain"] or k1["cuda"] == 0:
        raise AssertionError(f"g 8: paged paths ran {k1} / {k1p}")


def spec_no_sync_check(torch, eng):
    """A speculative window never waits for the device: a 2-iteration
    `decode_window_spec` over greedy and temperature-0.7 rows under CUDA
    sync debug mode "error". (Writes pages 1-4 of the engine's pool.)"""
    from ray_tpu_torch.llm.engine import decode_weights, decode_window_spec
    dev, B, K = eng.device, eng.e.max_slots, eng.e.spec_k
    g = torch.Generator(device=dev).manual_seed(0)
    hist = torch.randint(1, 50, (B, eng.e.max_len), generator=g, device=dev,
                         dtype=torch.int32)      # a small vocabulary: matches
    lens = torch.full((B,), 10, dtype=torch.int32, device=dev)
    args = dict(tokens=hist[:, 10].contiguous(), lengths=lens,
                active=torch.ones(B, dtype=torch.bool, device=dev),
                hist=hist,
                page_tables=torch.arange(1, B + 1, dtype=torch.int32,
                                         device=dev)[:, None],
                temps=torch.tensor([0.0, 0.7] * (B // 2), device=dev))
    fused = decode_weights(eng.params, eng.c)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _t, lens2, _a, _h, out = decode_window_spec(
            eng.params, eng.cache_k, eng.cache_v, generator=g, config=eng.c,
            eos_token=-1, n_steps=2, spec_k=K, fused=fused, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out, lens2 = out.cpu(), lens2.cpu()
    emitted = (out >= 0).sum(dim=(0, 2))
    prefix = ((out >= 0).int().diff(dim=2) <= 0).all()   # no gaps
    if (out.shape != (2, B, K + 1) or not (out < eng.c.vocab).all()
            or not prefix or not ((out >= 0).sum(2) >= 1).all()
            or not torch.equal(lens2 - 10, emitted.int())):
        raise AssertionError(f"speculative no-sync window returned bad "
                             f"tokens/state: {out} {lens2}")
    log(f"  speculative window: 2 iterations, temperatures 0 and 0.7, "
        f"{emitted.tolist()} tokens per slot, no host synchronization "
        f"(CUDA sync debug mode 'error')")


def exact_phase(torch, results):
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, forward, init_params
    from ray_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (20, 57, 100)]
    reset_counts()
    eng = InferenceEngine(cfg, EngineConfig(max_slots=4, max_len=256,
                                            prompt_buckets=(128,),
                                            eos_token=-1),
                          params=params, device="cuda")
    got = eng.generate(prompts, max_new_tokens=16, temperature=0.0)
    want = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(16):
                logits = forward(params, torch.tensor([seq], device="cuda"),
                                 cfg)
                if not torch.isfinite(logits).all():
                    raise AssertionError("non-finite logits")
                seq.append(int(logits[0, -1].argmax()))
            want.append(seq[len(p):])
    launches = dict(A.launches)
    log(f"  fp32 greedy: engine == forward argmax for {len(prompts)} "
        f"prompts x 16 tokens: {got == want}; K2 launches "
        f"{launches['cuda']}, plain {launches['plain']}")
    if got != want:
        raise AssertionError(f"engine {got} != forward {want}")
    if launches["cuda"] == 0 or launches["plain"] != 0:
        raise AssertionError("forward did not run the flash kernel")
    results["flash_fwd"]["launches"] = launches["cuda"]


# ---------------- phases 6-7: the train path ----------------


def bwd_counts():
    from ray_tpu_torch.ops import attention as A
    return {"fwd": dict(A.launches), "dq": dict(A.bwd_dq_launches),
            "dkv": dict(A.bwd_dkv_launches)}


def train_phase(torch, results, smi):
    """The train step at full llama-125m width and depth, bf16, on the JAX
    bench's 16 x 1024 batch, through the entry points a user calls."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.models.transformer import lm_head, log_likelihood
    from ray_tpu_torch.train import adamw, make_train_step
    cfg = configs.bench_125m()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in params["layers"].values())
    n_params += params["embed"].numel() + params["final_norm"].numel()
    init_fn, _step, compile_for, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(3e-4), device="cuda")
    state = init_fn(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                                    dtype=torch.int32, device="cuda")}
    step = compile_for(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, first = step(state, batch)
    first = first.item()
    log(f"  {n_params / 1e6:.1f} M params; first step "
        f"{time.perf_counter() - t0:.3f} s (library handles, allocator), "
        f"loss {first:.4f}")
    for _ in range(2):
        state, _loss = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    n = 10
    t0 = time.perf_counter()
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(loss)
    losses = torch.stack(losses).tolist()     # the one readback: a fence
    wall = time.perf_counter() - t0
    counts = bwd_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / n * 1e3
    tps = B * S / (wall / n)
    fpt = flops_per_token(cfg, S)
    mfu = fpt * tps / PEAK_FLOPS["bfloat16"]
    log(f"  {n} steps of {B} x {S} tokens: {step_ms:.2f} ms/step, "
        f"{tps:.1f} tokens/s, MFU {100 * mfu:.2f} % ({fpt / 1e9:.3f} "
        f"GFLOP/token over 989 TFLOP/s dense bf16); peak device memory "
        f"{peak / 2**30:.3f} GiB [{smi}]")
    log(f"  losses: first {first:.4f}, timed " +
        ", ".join(f"{x:.4f}" for x in losses))
    log(f"  launches over the {n} steps: K2 {counts['fwd']}, K3 "
        f"{counts['dq']}, K4 {counts['dkv']}")
    want = cfg.n_layers * n
    for key in ("fwd", "dq", "dkv"):
        if counts[key] != {"cuda": want, "plain": 0}:
            raise AssertionError(f"train step ran {key} {counts[key]}, "
                                 f"want {want} kernel launches, 0 plain")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < first:
        raise AssertionError(f"loss did not fall: {first} -> {losses[-1]}")
    results["flash_fwd"]["launches"] = counts["fwd"]["cuda"]
    results["flash_bwd_dq"]["launches"] = counts["dq"]["cuda"]
    results["flash_bwd_dkv"]["launches"] = counts["dkv"]["cuda"]

    # the fp32 loss head alone: chunked logits, logsumexp and their
    # backward (with the chunk recompute), as one step runs it
    x = torch.randn(B, S, cfg.d_model, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    head = lm_head(state.params, cfg)
    tgt = batch["tokens"][:, 1:].long()
    head_ms = device_ms(torch, lambda i: torch.autograd.grad(
        -log_likelihood(x, head, tgt).mean(), (x, head)), 3)
    log(f"  loss head (fp32 logits product, chunked, forward + backward): "
        f"{head_ms:.2f} ms = {100 * head_ms / step_ms:.1f} % of the step")
    del x

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # In a bf16 step the only fp32 matrix products are the loss head's.
    trace = trace_summary(torch, prof, wall_us, "one train step", smi,
                          top=16, groups=(
                              ("fp32 products (loss head)",
                               ("sgemm", "f32f32")),
                              ("flash kernels K2-K4", ("flash_",)),
                              ("bf16 products", ("gemm", "nvjet"))))

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, loss = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    log(f"  one step under CUDA sync debug mode 'warn': {len(syncs)} "
        f"synchronizing calls" + (f" ({syncs[0][:100]})" if syncs else ""))
    if not math.isfinite(loss.item()):
        raise AssertionError("non-finite loss after the profiled steps")
    return dict(step_ms=step_ms, tokens_per_s=tps, mfu=mfu, peak_bytes=peak,
                head_ms=head_ms, syncs=len(syncs), **trace)


def train_exact_phase(torch):
    """fp32 llama-125m at 2 x 256: loss and gradients through the kernels
    against the plain path, then 3 AdamW steps of each."""
    import numpy as np
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.optim import tree_leaves
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (2, 257)),
                                    dtype=torch.int32, device="cuda")}

    def weights():
        return init_params(cfg, torch.Generator().manual_seed(1), "cuda")

    def value_and_grad(c):
        params = weights()
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        reset_counts()
        loss = loss_fn(params, batch, c)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads, bwd_counts()

    lk, gk, ck = value_and_grad(cfg)
    lp, gp, cp = value_and_grad(plain_cfg)
    # fp32 both ways, attention summed in another order: loss to 1e-5
    # relative, each gradient leaf to 2e-4 of its largest entry
    worst = max((a - b).abs().max().item()
                / max(b.abs().max().item(), 1e-12) for a, b in zip(gk, gp))
    log(f"  loss kernel {lk:.6f} vs plain {lp:.6f}; gradients: worst leaf "
        f"max|diff|/max|plain| {worst:.3e} (tol 2e-4); launches kernel "
        f"path {ck}, plain path {cp}")
    if not abs(lk - lp) <= 1e-5 * abs(lp) or not worst <= 2e-4:
        raise AssertionError("train-exact: kernel path disagrees")
    want = cfg.n_layers
    kernels = {"cuda": want, "plain": 0}
    if (ck != {"fwd": kernels, "dq": kernels, "dkv": kernels}
            or cp != {"fwd": {"cuda": 0, "plain": want},
                      "dq": {"cuda": 0, "plain": 0},
                      "dkv": {"cuda": 0, "plain": 0}}):
        raise AssertionError("train-exact: the paths did not run as meant")

    lr, steps = 3e-4, 3
    runs = []
    for c in (cfg, plain_cfg):
        init_fn, step, _, _ = make_train_step(
            lambda p, b, c=c: loss_fn(p, b, c), adamw(lr), device="cuda")
        state = init_fn(weights())
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(loss)
        runs.append((torch.stack(losses).tolist(), tree_leaves(state.params)))
    (lk, pk), (lp, pp) = runs
    # Losses to 1e-5 relative. Params: all but 0.1 % of each leaf's
    # entries to 1e-6. AdamW divides each gradient by its own RMS, so an
    # entry whose gradient sits at the fp32 noise level moves in a
    # direction the rounding decides; the largest difference is printed,
    # not held to a bound.
    frac = max(((a - b).abs() > 1e-6).float().mean().item()
               for a, b in zip(pk, pp))
    far = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    log(f"  {steps} AdamW steps: losses kernel {lk}, plain {lp}; params: "
        f"largest share of a leaf's entries off by > 1e-6 {frac:.2e} "
        f"(tol 1e-3), largest difference {far:.3e}")
    if (any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(lk, lp))
            or frac > 1e-3 or not all(math.isfinite(x) for x in lk)):
        raise AssertionError("train-exact: trajectories disagree")


# ---------------- phases 10-13: the slice's serving surfaces ----------------

# The guided phases' JSON schema: every field bounded (a string of at most
# 8 characters, an integer 0-999, a boolean), so a guided answer is at most
# 38 bytes and ends within 64 tokens.
GUIDE_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8},
    "n": {"type": "integer", "minimum": 0, "maximum": 999},
    "ok": {"type": "boolean"}}}


def parses_to_schema(text: str) -> bool:
    try:
        obj = json.loads(text)
    except ValueError:
        return False
    return (isinstance(obj, dict) and list(obj) == ["name", "n", "ok"]
            and isinstance(obj["name"], str) and len(obj["name"]) <= 8
            and type(obj["n"]) is int and 0 <= obj["n"] <= 999
            and isinstance(obj["ok"], bool))


def tiny_phase(torch):
    """configs.tiny() (head_dim 16) on the card, in fp32 and bf16: the
    plain engine (K1), the speculative engine (K5) and 3 train steps (K2
    with lse, K3, K4), each with its launch count and no plain version
    run; in fp32 the engines' greedy tokens equal an argmax loop over
    `forward` (K2)."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import paged_attention as PA
    from ray_tpu_torch.train import adamw, make_train_step
    rng = np.random.default_rng(7)
    for dtype in ("float32", "bfloat16"):
        cfg = configs.tiny(dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(7), "cuda")
        pattern = rng.integers(1, cfg.vocab, 4).tolist()
        prompts = [rng.integers(1, cfg.vocab, 9).tolist(), pattern * 5,
                   rng.integers(1, cfg.vocab, 30).tolist()]
        ecfg = dict(max_slots=4, max_len=128, prompt_buckets=(32,),
                    eos_token=-1, page_size=16)
        reset_counts()
        eng = InferenceEngine(cfg, EngineConfig(**ecfg), params=params,
                              device="cuda")
        plain = eng.generate(prompts, 20, 0.0)
        k1 = dict(PA.launches)
        steps = eng.kv_stats()["decode_steps"]
        reset_counts()
        spec_eng = InferenceEngine(cfg, EngineConfig(**ecfg,
                                                     speculation="ngram",
                                                     spec_k=4),
                                   params=params, device="cuda")
        spec = spec_eng.generate(prompts, 20, 0.0)
        k5 = dict(PA.verify_insert_launches)
        st = spec_eng.kv_stats()
        line = (f"  tiny {dtype} (hd {cfg.head_dim}): engine {steps} decode "
                f"steps, K1 {k1}; spec engine {st['verify_steps']} verify "
                f"steps, K5 {k5}, spec == plain {spec == plain}")
        if dtype == "float32":
            reset_counts()
            want = forward_argmax(torch, params, cfg, prompts, 20)
            k2 = dict(A.launches)
            line += f", == forward argmax {plain == want} (K2 {k2})"
            if plain != want or spec != plain or k2["plain"]:
                raise AssertionError(f"tiny fp32: engine {plain}, spec "
                                     f"{spec}, forward {want}")
        if (k1 != {"cuda": cfg.n_layers * steps, "plain": 0} or steps == 0
                or k5 != {"cuda": cfg.n_layers * st["verify_steps"],
                          "plain": 0} or st["verify_steps"] == 0):
            raise AssertionError(f"tiny {dtype}: launches {k1} {k5}")
        init_fn, step, _, _ = make_train_step(
            lambda p, b, c=cfg: loss_fn(p, b, c), adamw(1e-3), device="cuda")
        state = init_fn(params)
        batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (4, 65)),
                                        dtype=torch.int32, device="cuda")}
        reset_counts()
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(loss)
        losses = torch.stack(losses).tolist()
        counts = bwd_counts()
        want = {"cuda": 3 * cfg.n_layers, "plain": 0}
        log(f"{line}; 3 train steps, losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, launches {counts}")
        if (any(counts[k] != want for k in counts)
                or not all(math.isfinite(x) for x in losses)
                or not losses[-1] < losses[0]):
            raise AssertionError(f"tiny {dtype} train: {losses} {counts}")


def guided_phase(torch, smi, params, serve):
    """The serve phase's 32 prompts and llama-125m bf16 weights, half of
    the requests under a JSON-schema guide (temperature 0.7), half free
    (greedy), 64 tokens at most: every guided answer parses to the schema,
    K1 runs 12 times per decode step; tokens/s beside the serve phase's,
    the guide table's bytes and uploads per window, peak memory."""
    from ray_tpu_torch.llm import ByteTokenizer, EngineConfig, InferenceEngine
    from ray_tpu_torch.llm.guided import compile_json_guide
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = configs.bench_125m()
    tok = ByteTokenizer()
    guide = compile_json_guide(GUIDE_SCHEMA, tok, vocab=cfg.vocab,
                               eos_id=tok.eos_id)
    eng = InferenceEngine(cfg, EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128,),
                                            eos_token=tok.eos_id),
                          params=params, seed=0, device="cuda")
    prompts = serve["prompts"][:32]
    eng.generate(prompts[:2], max_new_tokens=4)    # warm library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st0 = eng.kv_stats()
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=64,
                            temperature=0.7 if i % 2 == 0 else 0.0,
                            guide=guide if i % 2 == 0 else None)
            for i, p in enumerate(prompts)]
    windows = 0
    while eng.has_work():
        eng.step_window()
        windows += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = dict(PA.launches)
    st = eng.kv_stats()
    steps = st["decode_steps"] - st0["decode_steps"]
    uploads = st["guide_uploads"] - st0["guide_uploads"]
    gen = [eng.finished.pop(r).generated for r in rids]
    texts = [tok.decode([t for t in g if t != tok.eos_id])
             for g in gen[0::2]]
    good = sum(map(parses_to_schema, texts))
    n_tok = sum(len(g) for g in gen)
    table_bytes = eng._dev_gtables.numel() * eng._dev_gtables.element_size()
    peak = torch.cuda.max_memory_allocated()
    log(f"  guided: {len(rids)} requests ({len(texts)} guided), {n_tok} "
        f"tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s (serve phase "
        f"{serve['tokens_per_s']:.1f}); {steps} decode steps in {windows} "
        f"windows; guide table {table_bytes} B ({guide.n_states} states x "
        f"{cfg.vocab} int32 x 32 slots), {uploads} upload(s), "
        f"{uploads / max(windows, 1):.3f} per window; {good}/{len(texts)} "
        f"guided answers parse to the schema; peak device memory "
        f"{peak / 2**30:.3f} GiB; K1 {k1} [{smi}]")
    log(f"  a guided answer: {texts[0]!r}")
    if good != len(texts):
        raise AssertionError(f"guided answers that do not parse: "
                             f"{[t for t in texts if not parses_to_schema(t)]}")
    if any(not 0 <= t < cfg.vocab for g in gen for t in g):
        raise AssertionError("token out of vocabulary range")
    if k1 != {"cuda": cfg.n_layers * steps, "plain": 0} or steps == 0:
        raise AssertionError(f"guided: K1 {k1} for {steps} decode steps")
    guided_exact(torch, guide, tok)
    guided_no_sync_check(torch, eng, guide)
    return dict(tokens_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak,
                table_bytes=table_bytes, uploads=uploads, windows=windows)


def guided_exact(torch, guide, tok):
    """llama-125m in fp32: the engine's greedy tokens under the JSON guide
    equal a masked-argmax loop over the port's `forward` (K2) that walks
    the same DFA and stops at the EOS the guide allows."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, forward, init_params
    from ray_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (20, 57, 100)]
    eng = InferenceEngine(cfg, EngineConfig(max_slots=4, max_len=256,
                                            prompt_buckets=(128,),
                                            eos_token=tok.eos_id),
                          params=params, device="cuda")
    rids = [eng.add_request(p, max_new_tokens=48, temperature=0.0,
                            guide=guide) for p in prompts]
    while eng.has_work():
        eng.step_window()
    got = [eng.finished.pop(r).generated for r in rids]
    table = torch.tensor(guide.table, device="cuda")
    reset_counts()
    want = []
    with torch.no_grad():
        for p in prompts:
            seq, state, out = list(p), 0, []
            while len(out) < 48:
                logits = forward(params, torch.tensor([seq], device="cuda"),
                                 cfg)[0, -1]
                row = table[state]
                t = int(torch.where(row >= 0, logits, -1e30).argmax())
                out.append(t)
                if t == tok.eos_id:
                    break
                state = max(int(row[t]), 0)
                seq.append(t)
            want.append(out)
    k2 = dict(A.launches)
    log(f"  fp32 guided greedy, {len(prompts)} prompts: engine == masked "
        f"forward argmax {got == want}; K2 launches {k2}; answers "
        f"{[tok.decode(g[:-1]) for g in got]}")
    if got != want:
        raise AssertionError(f"guided engine {got} != forward {want}")
    if k2["cuda"] == 0 or k2["plain"]:
        raise AssertionError(f"guided forward loop: K2 {k2}")


def guided_no_sync_check(torch, eng, guide):
    """A guided window never waits for the device: a 4-step
    `decode_window` with the guide on every other slot (its state
    advancing on the device) and temperature 0.7, under CUDA sync debug
    mode "error"; every emitted token is one the guide allowed. (Writes
    pages 1-32 of the engine's pool.)"""
    import numpy as np
    from ray_tpu_torch.llm.engine import decode_weights, decode_window
    dev, B = eng.device, eng.e.max_slots
    fused = decode_weights(eng.params, eng.c)
    tab = np.zeros((B, guide.n_states, eng.c.vocab), np.int32)
    tab[0::2] = guide.table
    args = dict(
        tokens=torch.arange(1, B + 1, dtype=torch.int32, device=dev),
        lengths=torch.full((B,), 10, dtype=torch.int32, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        page_tables=torch.arange(1, B + 1, dtype=torch.int32,
                                 device=dev)[:, None],
        temps=torch.full((B,), 0.7, device=dev),
        top_ps=torch.ones(B, device=dev),
        top_ks=torch.zeros(B, dtype=torch.int64, device=dev),
        gtables=torch.tensor(tab, device=dev),
        gstates=torch.zeros(B, dtype=torch.int32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _t, _l, _a, out, _lp = decode_window(
            eng.params, eng.cache_k, eng.cache_v, generator=gen,
            config=eng.c, eos_token=-1, n_steps=4, trunc=False, guided=True,
            fused=fused, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = out.cpu().numpy()
    for b in range(0, B, 2):
        s = 0
        for t in out[:, b]:
            s = int(guide.table[s, t])
            if s < 0:
                raise AssertionError(f"guided window: slot {b} emitted "
                                     f"disallowed {out[:, b]}")
    log(f"  guided window: 4 steps, 16 guided and 16 free slots at "
        f"temperature 0.7, every guided token allowed, no host "
        f"synchronization (CUDA sync debug mode 'error')")


def handoff_phase(torch, smi):
    """Prefill engine -> KV handoff -> decode engine at llama-125m width:
    in fp32, 3 prompts of 300 tokens (2 full pages of 128, bucket 512)
    through `PrefillEngine.prefill_export`, then `add_request` with the
    export as `kv_handoff` and the first token as `resume_token`: the
    tokens equal the monolithic engine's, every handed-off prompt
    prefix-hits, K1 runs. Then in bf16, 32 such requests x 64 tokens
    timed (exports, then the decode engine), with prefix hits and peak
    memory."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, PrefillEngine
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops import paged_attention as PA
    ecfg = EngineConfig(max_slots=32, max_len=1024, prompt_buckets=(512,),
                        eos_token=-1)
    rng = np.random.default_rng(5)
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    prompts = [rng.integers(1, cfg.vocab, 300).tolist() for _ in range(3)]
    mono = InferenceEngine(cfg, ecfg, params=params,
                           device="cuda").generate(prompts, 16, 0.0)
    pe = PrefillEngine(cfg, ecfg, params=params, device="cuda")
    dec = InferenceEngine(cfg, ecfg, params=params, device="cuda")
    reset_counts()
    rids = []
    for p in prompts:
        first, ks, vs = pe.prefill_export(p, temperature=0.0)
        if tuple(ks.shape) != (cfg.n_layers, 256, cfg.n_kv_heads,
                               cfg.head_dim) or ks.device.type != "cpu":
            raise AssertionError(f"export shape {tuple(ks.shape)} on "
                                 f"{ks.device}")
        rids.append(dec.add_request(p, 16, 0.0, resume_token=first,
                                    kv_handoff=(ks, vs)))
    while dec.has_work():
        dec.step_window()
    got = [dec.finished.pop(r).generated for r in rids]
    k1 = dict(PA.launches)
    hits = dec.kv_stats()["prefix_hits"]
    log(f"  fp32 handoff, 3 x 300-token prompts: export + import + resume "
        f"== monolithic engine {got == mono}; prefix hits {hits}; K1 {k1}")
    if got != mono:
        raise AssertionError(f"handoff {got} != monolithic {mono}")
    if hits < len(prompts) or k1["cuda"] == 0 or k1["plain"]:
        raise AssertionError(f"handoff: prefix hits {hits}, K1 {k1}")
    del pe, dec, params

    cfg = configs.bench_125m()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    prompts = [rng.integers(1, cfg.vocab, 300).tolist() for _ in range(32)]
    pe = PrefillEngine(cfg, ecfg, params=params, device="cuda")
    dec = InferenceEngine(cfg, ecfg, params=params, device="cuda")
    pe.prefill_export(prompts[0])                  # warm library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    exports = [pe.prefill_export(p) for p in prompts]
    t1 = time.perf_counter()
    rids = [dec.add_request(p, 64, 0.0, resume_token=f, kv_handoff=(k, v))
            for p, (f, k, v) in zip(prompts, exports)]
    while dec.has_work():
        dec.step_window()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k1 = dict(PA.launches)
    st = dec.kv_stats()
    n_tok = sum(len(dec.finished.pop(r).generated) for r in rids)
    peak = torch.cuda.max_memory_allocated()
    log(f"  bf16 handoff, 32 x 300-token prompts x 64 tokens: exports "
        f"{(t1 - t0) * 1e3:.1f} ms ({(t1 - t0) * 1e3 / 32:.2f} ms each, "
        f"device -> host included); decode engine (import, suffix prefill, "
        f"decode) {t2 - t1:.3f} s, {n_tok / (t2 - t1):.1f} tokens/s; end to "
        f"end {n_tok / (t2 - t0):.1f} tokens/s; prefix hits "
        f"{st['prefix_hits']}; {st['decode_steps']} decode steps; peak "
        f"device memory {peak / 2**30:.3f} GiB; K1 {k1} [{smi}]")
    if n_tok != 32 * 64 or st["prefix_hits"] < 32:
        raise AssertionError(f"bf16 handoff: {n_tok} tokens, {st}")
    if k1 != {"cuda": cfg.n_layers * st["decode_steps"], "plain": 0}:
        raise AssertionError(f"bf16 handoff: K1 {k1}")
    return dict(tokens_per_s=n_tok / (t2 - t1),
                e2e_tokens_per_s=n_tok / (t2 - t0),
                export_ms=(t1 - t0) * 1e3 / 32, prefix_hits=st["prefix_hits"],
                peak_bytes=peak)


def dense_phase(torch, smi, serve):
    """kv_layout="dense" at llama-125m width: in fp32 its greedy tokens
    must equal the paged engine's (3 prompts x 16 tokens); then the serve
    phase's 32 prompts x 64 tokens in bf16 through the dense engine,
    timed. Its attention is plain PyTorch, as the JAX engine's dense path
    is plain jnp: no kernel runs."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops import paged_attention as PA
    cfg = dataclasses.replace(configs.bench_125m(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (20, 57, 100)]
    ecfg = dict(max_slots=4, max_len=256, prompt_buckets=(128,),
                eos_token=-1)
    dense = InferenceEngine(cfg, EngineConfig(kv_layout="dense", **ecfg),
                            params=params, device="cuda").generate(
        prompts, 16, 0.0)
    paged = InferenceEngine(cfg, EngineConfig(**ecfg), params=params,
                            device="cuda").generate(prompts, 16, 0.0)
    diff = [(i, j, a, b) for i, (x, y) in enumerate(zip(dense, paged))
            for j, (a, b) in enumerate(zip(x, y)) if a != b]
    log(f"  fp32 greedy, 3 prompts x 16 tokens: dense == paged "
        f"{dense == paged}" + (f"; first differences (prompt, position, "
                                f"dense, paged) {diff[:4]}" if diff else ""))
    if dense != paged:
        raise AssertionError(f"dense {dense} != paged {paged}")
    del params

    cfg = configs.bench_125m()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    eng = InferenceEngine(cfg, EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128,),
                                            eos_token=-1, kv_layout="dense"),
                          params=params, device="cuda")
    eng.generate(serve["prompts"][:2], max_new_tokens=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(serve["prompts"][:32], 64, 0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(x) for x in out)
    peak = torch.cuda.max_memory_allocated()
    same = sum(a == b for a, b in zip(out, serve["tokens"][:32]))
    log(f"  bf16 dense, 32 requests x 64 tokens: {n_tok / wall:.1f} tokens/s "
        f"(wall {wall:.3f} s, one host readback per step; paged serve phase "
        f"{serve['tokens_per_s']:.1f}); {same}/32 requests equal to the "
        f"paged serve phase's (bf16, printed only); peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches K1 {dict(PA.launches)} "
        f"[{smi}]")
    if n_tok != 32 * 64 or PA.launches["cuda"] or PA.launches["plain"]:
        raise AssertionError(f"dense: {n_tok} tokens, K1 {PA.launches}")
    return dict(tokens_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak)


# ---------------- phases 14-16: the sharded slice ----------------


def _sharded_step(torch, cfg, lr, mesh):
    """(init_fn, step) of the sharded train step on `mesh`."""
    from ray_tpu_torch.models import loss_fn, param_logical_axes
    from ray_tpu_torch.train import adamw, make_train_step
    init_fn, step, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg, mesh), adamw(lr), mesh,
        param_logical_axes(cfg), device="cuda")
    return init_fn, step


def sharded_train_phase(torch, smi, train, mesh):
    """The train phase's step through the sharded code over a mesh of one
    CUDA device (fsdp = 1, a process group of one): the params are
    DTensors placed by the rules table, every layer is gathered over the
    data axes before use and its gradient comes back through the gather's
    backward. bf16 at 16 x 1024 timed beside the unsharded step; fp32 at
    2 x 256 held to the unsharded step."""
    import numpy as np
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.optim import tree_leaves
    cfg = configs.bench_125m()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    init_fn, step = _sharded_step(torch, cfg, 3e-4, mesh)
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0),
                                "cuda"))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                                    dtype=torch.int32, device="cuda")}
    for _ in range(3):
        state, first = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    n = 10
    t0 = time.perf_counter()
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    wall = time.perf_counter() - t0
    counts = bwd_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / n * 1e3
    tps = B * S / (wall / n)
    mfu = flops_per_token(cfg, S) * tps / PEAK_FLOPS["bfloat16"]
    log(f"  sharded, {n} steps of {B} x {S} tokens: {step_ms:.2f} ms/step, "
        f"{tps:.1f} tokens/s, MFU {100 * mfu:.2f} %, peak device memory "
        f"{peak / 2**30:.3f} GiB; unsharded (train phase): "
        f"{train['step_ms']:.2f} ms/step, {train['tokens_per_s']:.1f} "
        f"tokens/s, MFU {100 * train['mfu']:.2f} %, peak "
        f"{train['peak_bytes'] / 2**30:.3f} GiB [{smi}]")
    log(f"  launches over the {n} steps: K2 {counts['fwd']}, K3 "
        f"{counts['dq']}, K4 {counts['dkv']}; losses " +
        ", ".join(f"{x:.4f}" for x in losses))
    want = cfg.n_layers * n
    for key in ("fwd", "dq", "dkv"):
        if counts[key] != {"cuda": want, "plain": 0}:
            raise AssertionError(f"sharded step ran {key} {counts[key]}, "
                                 f"want {want} kernel launches, 0 plain")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < first:
        raise AssertionError(f"sharded losses {losses} (first {first})")
    del state

    # fp32, the train-exact shape: 3 AdamW steps sharded and unsharded
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (2, 257)),
                                    dtype=torch.int32, device="cuda")}
    runs = []
    for sharded in (True, False):
        params = init_params(cfg32, torch.Generator().manual_seed(1), "cuda")
        if sharded:
            init_fn, step = _sharded_step(torch, cfg32, 3e-4, mesh)
        else:
            init_fn, step, _, _ = make_train_step(
                lambda p, b: loss_fn(p, b, cfg32), adamw(3e-4),
                device="cuda")
        state = init_fn(params)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(loss)
        leaves = [x.full_tensor() if hasattr(x, "full_tensor") else x
                  for x in tree_leaves(state.params)]
        runs.append((torch.stack(losses).tolist(), leaves))
        del state
    (ls, ps), (lu, pu) = runs
    far = max((a - b).abs().max().item() for a, b in zip(ps, pu))
    log(f"  fp32 2 x 256, 3 AdamW steps: losses sharded {ls}, unsharded "
        f"{lu}; params: largest difference {far:.3e} (tol 2e-4)")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(ls, lu)) or far > 2e-4:
        raise AssertionError("sharded-train: the sharded step disagrees "
                             "with the unsharded one")
    return dict(step_ms=step_ms, tokens_per_s=tps, mfu=mfu, peak_bytes=peak)


def checkpoint_phase(torch, smi, mesh):
    """The full-width bf16 sharded state after step 5 saved through the
    manifest path (torch.distributed.checkpoint + MANIFEST.json), found by
    latest_committed and restored into a fresh state: its next 3 losses
    equal the uninterrupted run's bit for bit. An uncommitted directory is
    left in place until gc_uncommitted removes it."""
    import numpy as np
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.train import (gc_uncommitted, latest_committed,
                                     restore_state, save_checkpoint)
    from ray_tpu_torch.train.checkpoint import step_dir, write_shard
    cfg = configs.bench_125m()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    storage = os.path.join(ROOT, "tmp", "chip_smoke_ckpt")
    shutil.rmtree(storage, ignore_errors=True)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                                    dtype=torch.int32, device="cuda")}
    init_fn, step = _sharded_step(torch, cfg, 3e-4, mesh)

    def fresh():
        return init_fn(init_params(cfg, torch.Generator().manual_seed(2),
                                   "cuda"))

    state = fresh()
    for _ in range(5):
        state, _loss = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = save_checkpoint(state, storage, 5, mesh=mesh)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(os.path.getsize(os.path.join(ckpt.path, f))
                 for f in os.listdir(ckpt.path))
    straight = []
    for _ in range(3):
        state, loss = step(state, batch)
        straight.append(loss)
    straight = torch.stack(straight).tolist()
    del state
    found = latest_committed(storage)
    target = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_state(found, target)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    resumed = []
    for _ in range(3):
        target, loss = step(target, batch)
        resumed.append(loss)
    resumed = torch.stack(resumed).tolist()
    torn = step_dir(storage, 6)
    write_shard({"partial": np.zeros(4)}, torn, 0, 2)
    still = latest_committed(storage)
    removed = gc_uncommitted(storage)
    log(f"  saved step {ckpt.manifest()['step']} ({nbytes} bytes in "
        f"{len(os.listdir(ckpt.path))} files) in {save_ms:.1f} ms, restored "
        f"in {restore_ms:.1f} ms [{smi}]; next 3 losses uninterrupted "
        f"{straight}, restored {resumed}; latest_committed "
        f"{os.path.basename(found)}, with an uncommitted step 6 beside it "
        f"{os.path.basename(still)}; gc_uncommitted removed "
        f"{[os.path.basename(p) for p in removed]}")
    if found != ckpt.path or still != ckpt.path or removed != [torn]:
        raise AssertionError("checkpoint: the manifest protocol misfired")
    if int(target.step) != 8 or resumed != straight:
        raise AssertionError(f"checkpoint: restored losses {resumed} != "
                             f"uninterrupted {straight}")
    shutil.rmtree(storage, ignore_errors=True)
    return dict(save_ms=save_ms, restore_ms=restore_ms, bytes=nbytes)


TP_SERVE_PROMPTS = 3   # fp32 exactness prompts (16 greedy tokens each)


def tp_serve_worker(rank, world, port, prompts, out):
    """One rank of the tp-serve phase: a gloo process group over
    localhost on the one card, a tp mesh, and the engines on this rank's
    heads (every rank draws the same seeded params and calls alike)."""
    import datetime
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        from ray_tpu_torch.llm import EngineConfig, InferenceEngine
        from ray_tpu_torch.models import configs, init_params
        from ray_tpu_torch.ops import paged_attention as PA
        from ray_tpu_torch.parallel import MeshConfig, make_mesh
        mesh = make_mesh(MeshConfig(fsdp=1, tp=world))
        res = {}
        cfg32 = dataclasses.replace(configs.bench_125m(), dtype="float32")
        p32 = init_params(cfg32, torch.Generator().manual_seed(1), "cuda")
        exact = prompts[:TP_SERVE_PROMPTS]
        ecfg = dict(max_slots=4, max_len=256, prompt_buckets=(128,),
                    eos_token=-1)
        eng = InferenceEngine(cfg32, EngineConfig(**ecfg), params=p32,
                              mesh=mesh, device="cuda")
        res["fp32"] = eng.generate(exact, 16, 0.0)
        res["kv_heads"] = eng.cache_k.shape[1]
        spec = InferenceEngine(cfg32, EngineConfig(**ecfg,
                                                   speculation="ngram",
                                                   spec_k=4),
                               params=p32, mesh=mesh, device="cuda")
        res["fp32_spec"] = spec.generate(exact, 16, 0.0)
        del eng, spec, p32
        cfg = configs.bench_125m()
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        eng = InferenceEngine(cfg, EngineConfig(
            max_slots=32, max_len=1024, prompt_buckets=(128,), eos_token=-1),
            params=params, mesh=mesh, seed=0, device="cuda")
        eng.generate(prompts[:2], max_new_tokens=4)
        torch.cuda.synchronize()
        dist.barrier()
        steps0 = eng.decode_steps
        reset_counts()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=64, temperature=0.0)
                for p in prompts]
        while eng.has_work():
            eng.step_window()
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        res["tokens"] = [eng.finished[r].generated for r in rids]
        res["decode_steps"] = eng.decode_steps - steps0
        res["k1"] = dict(PA.launches)
        dist.barrier()
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 — the parent reports it and fails
        import traceback
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_serve_phase(torch, smi, serve):
    """tp = 2 as two processes on the one card over gloo (NCCL refuses two
    ranks on one device; gloo's all-reduce and all-gather take CUDA
    tensors, through the host): llama-125m, 6 of the 12 heads and kv
    heads on each rank. fp32 greedy tokens equal the tp = 1 engine's and
    an argmax loop over `forward`, plain and speculative; bf16, the serve
    phase's 32 requests x 64 tokens timed (a correctness path: every
    collective goes through the host)."""
    import multiprocessing as mp
    import queue
    import socket
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, init_params
    world = 2
    prompts = serve["prompts"][:32]
    cfg32 = dataclasses.replace(configs.bench_125m(), dtype="float32")
    p32 = init_params(cfg32, torch.Generator().manual_seed(1), "cuda")
    exact = prompts[:TP_SERVE_PROMPTS]
    tp1 = InferenceEngine(cfg32, EngineConfig(
        max_slots=4, max_len=256, prompt_buckets=(128,), eos_token=-1),
        params=p32, device="cuda").generate(exact, 16, 0.0)
    argmax = forward_argmax(torch, p32, cfg32, exact, 16)
    del p32
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=tp_serve_worker,
                         args=(r, world, port, prompts, out))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, status, value = out.get(timeout=10)
            except queue.Empty:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("tp-serve: no result in 600 s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError("tp-serve: a rank died")
                continue
            (got.__setitem__(rank, value) if status == "ok"
             else errors.append(f"rank {rank}: {value}"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("tp-serve failed:\n" + "\n".join(errors))
    cfg = configs.bench_125m()
    r0 = got[0]
    n_tok = sum(len(x) for x in r0["tokens"])
    tps = n_tok / r0["wall_s"]
    log(f"  tp=2 on one card over gloo, {r0['kv_heads']} kv heads a rank; "
        f"fp32 {TP_SERVE_PROMPTS} prompts x 16 greedy tokens: tp2 == tp1 "
        f"{r0['fp32'] == tp1}, == forward argmax {r0['fp32'] == argmax}, "
        f"speculative tp2 == tp1 {r0['fp32_spec'] == tp1}")
    log(f"  bf16 {len(prompts)} requests x 64 tokens: {tps:.1f} tokens/s "
        f"({r0['wall_s']:.3f} s, {r0['decode_steps']} decode steps) vs the "
        f"serve phase's {serve['tokens_per_s']:.1f} tokens/s at tp=1; K1 "
        f"launches per rank {[got[r]['k1'] for r in range(world)]}; phase "
        f"wall {time.perf_counter() - t0:.1f} s [{smi}]")
    for r in range(world):
        g = got[r]
        if g["fp32"] != tp1 or g["fp32"] != argmax or g["fp32_spec"] != tp1:
            raise AssertionError(f"tp-serve rank {r}: fp32 tokens differ")
        if g["kv_heads"] != cfg.n_kv_heads // world:
            raise AssertionError(f"rank {r} holds {g['kv_heads']} kv heads")
        if g["tokens"] != r0["tokens"] or any(len(x) != 64
                                              for x in g["tokens"]):
            raise AssertionError(f"tp-serve rank {r}: bf16 streams differ")
        if (g["k1"] != {"cuda": cfg.n_layers * g["decode_steps"], "plain": 0}
                or g["decode_steps"] == 0):
            raise AssertionError(f"rank {r}: K1 launches {g['k1']} for "
                                 f"{g['decode_steps']} decode steps")
    return dict(tokens_per_s=tps)



# ---------------- phase 17: the runtime and the trainer ----------------


def trainer_loop(config):
    """The Trainer's loop (runs in the runtime's worker on the card):
    `steps` AdamW steps of the port's train step on llama-125m
    (`configs.bench_125m`, random weights from seed 0, the JAX bench's
    batch from numpy seed 0) in `config["dtype"]`. Each report carries the
    loss, the step's host-clock ms (ended by the loss readback), the
    worker's K2-K4 launch counts since the loop began, its peak device
    memory and its wall clock. At `ckpt_step` the state is saved into
    that step's directory and reported as the checkpoint; with
    `crash_marker` the first run hard-exits once it has committed. A run
    that finds a checkpoint resumes from it."""
    import numpy as np
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.checkpoint import (Checkpoint, is_committed,
                                                restore_state, save_state,
                                                step_dir)
    from ray_tpu_torch.train.torch import get_device
    ctx = train.get_context()
    dev = get_device()   # raises where the rank's card is not visible
    if dev.type != "cuda":
        raise RuntimeError(f"the trainer's rank runs on {dev}, not a card")
    cfg = dataclasses.replace(configs.bench_125m(), dtype=config["dtype"])
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(3e-4), device=dev)
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0), dev))
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        restore_state(os.path.join(ckpt.path, "state.pt"), state)
    B, S = config["batch"]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                                    dtype=torch.int32, device="cuda")}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for step in range(int(state.step), config["steps"]):
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        loss = loss.item()   # the step's fence
        metrics = dict(step=step, loss=loss,
                       ms=(time.perf_counter() - t0) * 1e3,
                       counts=bwd_counts(),
                       peak=torch.cuda.max_memory_allocated(),
                       wall=time.time(),
                       device=torch.cuda.get_device_name(0))
        if step != config.get("ckpt_step"):
            train.report(metrics)
            continue
        path = step_dir(ctx.get_trial_dir(), step)
        save_state(state, os.path.join(path, "state.pt"))
        train.report(metrics, checkpoint=Checkpoint(path))
        marker = config.get("crash_marker")
        if marker and not os.path.exists(marker):
            deadline = time.monotonic() + 120
            while not is_committed(path) and time.monotonic() < deadline:
                time.sleep(0.05)
            with open(marker, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)  # a hard crash right after the commit


def gang_loop(config):
    """Each rank of a TorchDistributedConfig gang: its rank, world size,
    local rank, the group's backend and the all-reduce of a CUDA tensor
    holding rank + 1."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    ctx = train.get_context()
    x = torch.full((4,), float(ctx.get_world_rank() + 1), device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    mine = (ctx.get_world_rank(), ctx.get_world_size(), ctx.get_local_rank(),
            dist.get_backend(), x.tolist(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))
    ranks = [None] * ctx.get_world_size()
    dist.all_gather_object(ranks, mine)   # rank 0's report carries all
    train.report(dict(ranks=ranks))


def _visibility():
    """(CUDA_VISIBLE_DEVICES, device count, device names) in a worker."""
    import torch
    n = torch.cuda.device_count()
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), n,
            [torch.cuda.get_device_name(i) for i in range(n)])


class _Visibility:
    def get(self):
        return _visibility()


def _driver_losses(torch, dtype: str, batch, steps: int) -> list:
    """The trainer loop's steps run in this process: its losses."""
    import numpy as np
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    cfg = dataclasses.replace(configs.bench_125m(), dtype=dtype)
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(3e-4), device="cuda")
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0),
                                "cuda"))
    B, S = batch
    rng = np.random.default_rng(0)
    tokens = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                                     dtype=torch.int32, device="cuda")}
    out = []
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
        out.append(loss.item())
    del state
    torch.cuda.empty_cache()
    return out


def trainer_phase(torch, smi, train) -> dict:
    """The port's runtime and Trainer on the card: init() counting the
    GPUs as torch does, with the native head core and object store built
    from the checkout; a
    num_gpus=0 task sees no device and a num_gpus=1 actor exactly one;
    Trainer.fit() of 10 bf16 llama-125m steps (16 x 1024) on one worker
    holding the card, K2-K4 12 launches a step each in the worker and no
    plain run, a checkpoint committed at step 5; fp32 (2 x 256) 3 steps
    bit-equal to the same steps in this process; a worker that hard-exits
    after step 5's commit, resumed by FailureConfig(max_failures=1) from
    the manifest with bit-equal fp32 losses; two ranks at
    gpus_per_worker=0.5 under TorchDistributedConfig (gloo: they share
    the card) whose all-reduce of a CUDA tensor sums."""
    import importlib
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._native import head_core
    from ray_tpu_torch.core import accelerators
    from ray_tpu_torch.core.runtime import current_runtime
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchDistributedConfig, Trainer)
    # by its module name: the workers import the loops (no pickled code)
    me = importlib.import_module("chip_smoke")
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    storage = tempfile.mkdtemp(prefix="trainer-",
                               dir=os.path.join(ROOT, "tmp"))
    out = {}
    try:
        t_boot = time.time()
        detected = accelerators.detect_gpus()
        if detected != torch.cuda.device_count():
            raise AssertionError(f"detect_gpus() counts {detected} GPUs, "
                                 f"torch {torch.cuda.device_count()}")
        rt.init(num_cpus=8, object_store_memory=4 << 30)
        head = current_runtime()
        if head._hnat is None or head_core._lib is None:
            raise AssertionError(f"the native head core did not build: "
                                 f"{head_core._lib_err!r}")
        init_s = time.time() - t_boot
        log(f"  init: {init_s:.2f} s (native head core and object store "
            f"built from the checkout); GPUs detected {detected}, as "
            f"torch counts them; init(): {rt.cluster_resources()}")
        if rt.cluster_resources().get("GPU") != detected:
            raise AssertionError(f"init() advertises "
                                 f"{rt.cluster_resources()}, not "
                                 f"{detected} GPU")
        cpu_vis = rt.get(rt.remote(num_gpus=0)(me._visibility).remote(),
                         timeout=120)
        act = rt.remote(num_gpus=1)(me._Visibility).remote()
        gpu_vis = rt.get(act.get.remote(), timeout=120)
        rt.kill(act)
        log(f"  num_gpus=0 task: CUDA_VISIBLE_DEVICES={cpu_vis[0]!r}, "
            f"{cpu_vis[1]} devices; num_gpus=1 actor: "
            f"CUDA_VISIBLE_DEVICES={gpu_vis[0]!r}, {gpu_vis[1]} device "
            f"{gpu_vis[2]}")
        if cpu_vis[:2] != ("", 0) or gpu_vis[:2] != ("0", 1):
            raise AssertionError(f"device visibility: task {cpu_vis}, "
                                 f"actor {gpu_vis}")

        # gpus_per_worker 0: all the host's GPUs, its one card
        one_gpu = ScalingConfig(num_workers=1, use_gpu=True)
        steps = 10
        t0 = time.time()
        res = Trainer(me.trainer_loop, train_loop_config=dict(
            dtype="bfloat16", batch=(TRAIN_BATCH, TRAIN_SEQ), steps=steps,
            ckpt_step=5), scaling_config=one_gpu,
            run_config=RunConfig(name="bf16", storage_path=storage)).fit()
        if res.error is not None:
            raise AssertionError(f"bf16 fit: {res.error}")
        hist = res.metrics_history
        first_wall = hist[0]["wall"]
        ms = [m["ms"] for m in hist]
        timed = ms[3:]
        counts = hist[-1]["counts"]
        log(f"  bf16 fit, {steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} on "
            f"{hist[-1]['device']}: losses " + ", ".join(
                f"{m['loss']:.4f}" for m in hist))
        log(f"  ms/step through the trainer " + ", ".join(
            f"{x:.2f}" for x in ms) + f"; steps 4-10 median "
            f"{sorted(timed)[len(timed) // 2]:.2f} against the train "
            f"phase's {train['step_ms']:.2f} ms/step in this process "
            f"(each trainer step also reads its loss back) [{smi}]")
        log(f"  runtime boot to the first report: {first_wall - t_boot:.2f} s "
            f"(init {init_s:.2f} s, the fit's worker spawn, CUDA init and "
            f"the first step); worker peak device memory "
            f"{hist[-1]['peak'] / 2**30:.3f} GiB [{smi}]")
        log(f"  worker launches over the {steps} steps: K2 {counts['fwd']}, "
            f"K3 {counts['dq']}, K4 {counts['dkv']}; checkpoint "
            f"{res.checkpoint}")
        want = 12 * steps
        for key in ("fwd", "dq", "dkv"):
            if counts[key] != {"cuda": want, "plain": 0}:
                raise AssertionError(f"trainer worker ran {key} "
                                     f"{counts[key]}, want {want} kernel "
                                     f"launches, 0 plain")
        if [m["step"] for m in hist] != list(range(steps)) or not all(
                math.isfinite(m["loss"]) for m in hist):
            raise AssertionError(f"bf16 fit reports: {hist}")
        if res.checkpoint is None or not res.checkpoint.path.endswith(
                "000005") or not res.checkpoint.is_committed():
            raise AssertionError(f"no committed step-5 checkpoint: "
                                 f"{res.checkpoint}")
        out.update(step_ms=sorted(timed)[len(timed) // 2],
                   boot_s=first_wall - t_boot, peak=hist[-1]["peak"],
                   counts=counts)

        fp32 = dict(dtype="float32", batch=(2, 256))
        want8 = _driver_losses(torch, "float32", fp32["batch"], 8)
        res = Trainer(me.trainer_loop, train_loop_config=dict(fp32, steps=3),
                      scaling_config=one_gpu,
                      run_config=RunConfig(name="fp32", storage_path=storage)
                      ).fit()
        got = [m["loss"] for m in res.metrics_history]
        log(f"  fp32 fit, 3 steps of 2 x 256: {got}; this process: "
            f"{want8[:3]}")
        if res.error is not None or got != want8[:3]:
            raise AssertionError(f"fp32 fit {got} (error {res.error}) != "
                                 f"this process's {want8[:3]}")

        marker = os.path.join(storage, "crashed")
        res = Trainer(me.trainer_loop, train_loop_config=dict(
            fp32, steps=8, ckpt_step=5, crash_marker=marker),
            scaling_config=one_gpu, run_config=RunConfig(
                name="restart", storage_path=storage,
                failure_config=FailureConfig(max_failures=1))).fit()
        hist = res.metrics_history
        got = [m["loss"] for m in hist]
        if res.error is not None or not os.path.exists(marker):
            raise AssertionError(f"restart fit: error {res.error}, crashed "
                                 f"{os.path.exists(marker)}")
        with open(marker) as f:
            crash_wall = float(f.read())
        resumed = [m for m in hist if m["wall"] > crash_wall]
        restart_s = resumed[0]["wall"] - crash_wall
        log(f"  restart: the worker hard-exited after step 5's commit; "
            f"resumed at step {resumed[0]['step']} from "
            f"{res.checkpoint}, first resumed report {restart_s:.2f} s "
            f"after the crash; losses {got} [{smi}]")
        if ([m["step"] for m in hist] != list(range(8))
                or resumed[0]["step"] != 6 or got != want8):
            raise AssertionError(f"restart losses {got} (steps "
                                 f"{[m['step'] for m in hist]}) != the "
                                 f"uninterrupted {want8}")
        out["restart_s"] = restart_s

        res = Trainer(me.gang_loop, scaling_config=ScalingConfig(
            num_workers=2, use_gpu=True, gpus_per_worker=0.5),
            run_config=RunConfig(name="gang", storage_path=storage),
            torch_config=TorchDistributedConfig()).fit()
        if res.error is not None:
            raise AssertionError(f"gang fit: {res.error}")
        ranks = sorted(tuple(r) for r in res.metrics["ranks"])
        log(f"  two ranks at gpus_per_worker=0.5: (rank, world, local "
            f"rank, backend, all-reduce of rank + 1, devices) {ranks}")
        if ranks != [(r, 2, r, "gloo", [3.0] * 4, "0") for r in (0, 1)]:
            raise AssertionError(f"gang: {ranks}")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return out


# ---------------- phase 18: serving through the runtime ----------------


def __getattr__(name):
    """The probes `ProbeServer`, `ProbePrefill`, `ProbeDecode` and
    `ProbeEngine`, made on first use: the runtime's workers unpickle a
    replica's or an engine stage's class by this module's name, and making them at import would import the port
    before main() has checked that it is this checkout's."""
    makers = {"ProbeServer": _make_probe_server,
              "ProbePrefill": _make_probe_prefill,
              "ProbeDecode": _make_probe_decode,
              "ProbeEngine": _make_probe_engine}
    if name not in makers:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    cls = makers[name]()
    cls.__module__ = __name__
    cls.__qualname__ = cls.__name__ = name
    globals()[name] = cls
    return cls


def _replica_reads(engine=None) -> dict:
    """What a probe reports of its own process: the paged kernels' launch
    counts, its peak device memory, the device, its pid, and the engine's
    decode steps."""
    import torch
    from ray_tpu_torch.ops import paged_attention as PA
    return dict(k1=dict(PA.launches), verify=dict(PA.verify_launches),
                verify_insert=dict(PA.verify_insert_launches),
                decode_steps=getattr(engine, "decode_steps", 0),
                peak=torch.cuda.max_memory_allocated(),
                device=torch.cuda.get_device_name(0), pid=os.getpid())


def _reset_replica_reads():
    import torch
    reset_counts()
    torch.cuda.reset_peak_memory_stats()


def _rank_reads(self, reset: bool = False) -> dict:
    """A probe's reads of this rank's process (`_replica_reads`), read by
    the replica's `gang_call` on every rank of a tp gang; then reset."""
    out = _replica_reads(self.engine)
    if reset:
        _reset_replica_reads()
    return out


def _make_probe_server():
    from ray_tpu_torch.llm.serve import _LLMServerImpl

    class ProbeServer(_LLMServerImpl):
        """The port's LLM replica, with reads of its own process: the
        paged-decode kernel's launch counts, the engine's decode steps,
        its peak device memory, and the prompt and generated token ids
        of each request it answered (an HTTP answer carries text only)."""

        def __init__(self, llm_config):
            super().__init__(llm_config)
            self.answered = []

        async def _submit(self, prompt_ids, *args, **kwargs):
            req = await super()._submit(prompt_ids, *args, **kwargs)
            self.answered.append((list(prompt_ids), list(req.generated)))
            return req

        def probe(self, reset: bool = False) -> dict:
            out = dict(_replica_reads(self.engine),
                       answered=list(self.answered))
            if reset:
                _reset_replica_reads()
                self.answered.clear()
            return out

        rank_reads = _rank_reads
    return ProbeServer


def _make_probe_prefill():
    from ray_tpu_torch.llm.serve import _PrefillWorkerImpl

    class ProbePrefill(_PrefillWorkerImpl):
        """The port's prefill worker, with reads of its own process (as
        `_replica_reads`) and the host clock's start and end of each
        export (prefill, first-token sampling, the copy to the host and
        the seal into the store; CLOCK_MONOTONIC, which every process of
        the host shares)."""

        def __init__(self, llm_config):
            super().__init__(llm_config)
            self.exports = []

        def prefill(self, prompt_ids, *args, **kwargs):
            t0 = time.monotonic()
            out = super().prefill(prompt_ids, *args, **kwargs)
            self.exports.append((t0, time.monotonic()))
            return out

        def probe(self, reset: bool = False) -> dict:
            out = dict(_replica_reads(), exports=list(self.exports))
            if reset:
                _reset_replica_reads()
                self.exports.clear()
            return out

        rank_reads = _rank_reads
    return ProbePrefill


def _make_probe_decode():
    from ray_tpu_torch.llm.serve import _DecodeReplicaImpl

    class ProbeDecode(_DecodeReplicaImpl):
        """The port's decode replica, with reads of its own process (as
        `_replica_reads`), the bytes of each handoff it fetched from the
        store, and the prompt and full token ids of each stream it
        finished (the tokens the client held, then the ones it sent):
        an HTTP answer carries text only."""

        def __init__(self, llm_config):
            super().__init__(llm_config)
            self.handoff_bytes = []
            self.streams = []

        def _fetch_handoff(self, kv, prompt_ids):
            out = super()._fetch_handoff(kv, prompt_ids)
            if out is not None:
                self.handoff_bytes.append(sum(
                    t.numel() * t.element_size() for t in out))
            return out

        def decode_stream(self, prompt_ids, generated, *args, **kwargs):
            sent = []
            for chunk in super().decode_stream(prompt_ids, generated,
                                               *args, **kwargs):
                yield chunk
                sent += [x if isinstance(x, int) else x[0] for x in chunk]
            self.streams.append((list(prompt_ids),
                                 [int(t) for t in generated] + sent))

        def probe(self, reset: bool = False) -> dict:
            out = dict(_replica_reads(self.engine),
                       handoff_bytes=list(self.handoff_bytes),
                       streams=list(self.streams))
            if reset:
                _reset_replica_reads()
                self.handoff_bytes.clear()
                self.streams.clear()
            return out

        rank_reads = _rank_reads
    return ProbeDecode


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict, timeout: float = 120.0) -> dict:
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _serve_probe_app(serve, me, cfg, name: str, port: int):
    """`serve.run(build_openai_app(cfg))` with the replica's class made
    the probe (the same deployment options, its placement group's too):
    returns the probe's handle."""
    from ray_tpu_torch.llm.serve import build_openai_app
    app = build_openai_app(cfg)
    server = app.root.init_args[0].root   # the LLM deployment, bound
    c = server.deployment.config
    server.deployment = serve.deployment(
        me.ProbeServer, name=server.deployment.name).options(
        num_replicas=cfg.num_replicas,
        ray_actor_options=dict(c.ray_actor_options),
        placement_group_bundles=c.placement_group_bundles)
    serve.run(app, name=name, route_prefix=f"/{name}", http_port=port,
              blocking_timeout_s=300)
    return serve.get_deployment_handle(server.deployment.name, name)


def _runtime_processes() -> list:
    """Pids of the port's runtime processes still alive on this host (its
    workers and head daemons)."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
        except OSError:
            continue
        if b"ray_tpu_torch.core" in cmd:
            pids.append(int(pid))
    return pids


def serve_runtime_phase(torch, results, smi, serve_inproc) -> dict:
    """The OpenAI app through the port's runtime on the card: a replica
    actor reserving the GPU (the probe class, `ProbeServer`), the router
    and the HTTP proxy on a free port. bf16 llama-125m at the serve
    phase's engine shape: the serve phase's traffic as text (36 prompts
    of 127 and 144 tokens, 64 greedy tokens each) from 36 client threads
    at once; K1 n_layers launches per replica decode step, plain 0; a
    streamed request with logprobs; /v1/models. fp32: tokens through
    HTTP == the in-process engine's == a forward argmax loop, and those
    of a LoRA adapter registered through the handle == an engine built
    with the merged params, then the base tokens again."""
    import dataclasses as dc
    import http.client
    import importlib
    import threading
    import urllib.request

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (EngineConfig, InferenceEngine, LLMConfig,
                                   LoraConfig)
    from ray_tpu_torch.llm.lora import init_lora, merge_lora
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import configs
    me = importlib.import_module("chip_smoke")
    tok = ByteTokenizer()
    port = _free_port()
    out = {}
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, object_store_memory=1 << 30)
    try:
        model = configs.bench_125m()
        cfg = LLMConfig(model_id="llama-125m", model=model,
                        engine=EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128,),
                                            eos_token=-1),
                        num_gpus_per_replica=1, seed=0)
        url = f"http://127.0.0.1:{port}/bf16"
        t0 = time.perf_counter()
        h = _serve_probe_app(serve, me, cfg, "bf16", port)
        first = _post(url + "/v1/completions",
                      {"prompt": "hello", "max_tokens": 4,
                       "temperature": 0.0})
        boot_s = time.perf_counter() - t0
        if first["usage"]["completion_tokens"] != 4:
            raise AssertionError(f"first answer: {first}")
        rng = np.random.default_rng(0)

        def text(n):
            return "".join(chr(c) for c in rng.integers(32, 127, n))
        prompts = [text(126) for _ in range(32)]   # 127 tokens with BOS
        shared = text(127)                         # BOS + 127: a page
        prompts += [shared + text(16) for _ in range(4)]
        before = h.probe.remote(reset=True).result(timeout_s=60)
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = _post(url + "/v1/completions", {
                "prompt": prompts[i], "max_tokens": 64,
                "temperature": 0.0})
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or None in answers:
            raise AssertionError("an HTTP request did not finish")
        after = h.probe.remote().result(timeout_s=60)
        steps = after["decode_steps"] - before["decode_steps"]
        n_tok = sum(a["usage"]["completion_tokens"] for a in answers)
        k1 = after["k1"]
        log(f"  bf16 through HTTP: {len(prompts)} requests from as many "
            f"client threads, {n_tok} tokens in {wall:.3f} s: "
            f"{n_tok / wall:.1f} tokens/s (the in-process serve phase: "
            f"{serve_inproc['tokens_per_s']:.1f}); {steps} replica decode "
            f"steps, K1 launches {k1['cuda']}, plain {k1['plain']}; "
            f"replica on {after['device']}, peak device memory "
            f"{after['peak'] / 2**30:.3f} GiB; boot (serve.run to the "
            f"first answer) {boot_s:.2f} s [{smi}]")
        if any(a["usage"]["completion_tokens"] != 64 for a in answers):
            raise AssertionError("a request did not finish with 64 tokens")
        if k1["cuda"] != model.n_layers * steps or steps == 0:
            raise AssertionError(f"replica K1 launches {k1['cuda']} != "
                                 f"{model.n_layers} x {steps} decode steps")
        if k1["plain"] != 0:
            raise AssertionError("the plain paged path ran in the replica")
        results["paged_decode"]["serve_replica_launches"] = k1["cuda"]

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        t0 = time.perf_counter()
        conn.request("POST", "/bf16/v1/completions", body=json.dumps({
            "prompt": prompts[0], "max_tokens": 64, "temperature": 0.0,
            "stream": True, "logprobs": True}).encode(),
            headers={"content-type": "application/json"})
        resp = conn.getresponse()
        ttft = None
        entries, done = [], False
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            chunk = json.loads(line[6:])["choices"][0]
            if ttft is None:
                ttft = time.perf_counter() - t0
            entries += chunk["logprobs"]["token_logprobs"]
        stream_s = time.perf_counter() - t0
        conn.close()
        with urllib.request.urlopen(url + "/v1/models", timeout=60) as r:
            models = json.load(r)
        log(f"  stream=true with logprobs: first chunk after "
            f"{1e3 * ttft:.1f} ms, {len(entries)} tokens in "
            f"{stream_s:.3f} s; /v1/models {models}")
        if not done or len(entries) != 64 or not all(
                math.isfinite(x) and x <= 0 for x in entries):
            raise AssertionError(f"stream: done {done}, {len(entries)} "
                                 f"logprob entries")
        if [m["id"] for m in models["data"]] != ["llama-125m"]:
            raise AssertionError(f"/v1/models: {models}")
        out.update(tokens_per_s=n_tok / wall, boot_s=boot_s, ttft_s=ttft,
                   peak=after["peak"], launches=k1["cuda"])
        serve.delete("bf16")

        # fp32: tokens through HTTP against the in-process engine
        m32 = dc.replace(configs.bench_125m(), dtype="float32")
        cfg32 = LLMConfig(model_id="llama-125m-fp32", model=m32,
                          engine=EngineConfig(max_slots=4, max_len=256,
                                              prompt_buckets=(128,),
                                              eos_token=-1),
                          lora=LoraConfig(rank=8), num_gpus_per_replica=1,
                          seed=1)
        url = f"http://127.0.0.1:{port}/fp32"
        h32 = _serve_probe_app(serve, me, cfg32, "fp32", port)
        texts = [text(n) for n in (19, 56, 99)]
        ids = [tok.encode(t) for t in texts]

        def over_http(model_id=None):
            h32.probe.remote(reset=True).result(timeout_s=60)
            got = [_post(url + "/v1/completions", {
                "prompt": t, "max_tokens": 16, "temperature": 0.0,
                **({"model": model_id} if model_id else {})})
                for t in texts]
            answered = h32.probe.remote().result(timeout_s=60)["answered"]
            if [a[0] for a in answered] != ids:
                raise AssertionError("the replica answered other prompts")
            toks = [a[1] for a in answered]
            if [g["choices"][0]["text"] for g in got] != [
                    tok.decode(t) for t in toks]:
                raise AssertionError("HTTP text != the decoded tokens")
            return toks
        base = over_http()
        eng = InferenceEngine(m32, cfg32.engine, seed=cfg32.seed,
                              device="cuda")
        want = eng.generate(ids, max_new_tokens=16, temperature=0.0)
        argmax = forward_argmax(torch, eng.params, m32, ids, 16)
        log(f"  fp32 through HTTP: 3 prompts x 16 greedy tokens == the "
            f"in-process engine: {base == want}, == forward argmax: "
            f"{base == argmax}")
        if not base == want == argmax:
            raise AssertionError(f"HTTP {base} / engine {want} / forward "
                                 f"{argmax}")
        gen = torch.Generator().manual_seed(7)
        lora = init_lora(m32, 8, gen)
        for ab in lora.values():
            ab["B"] = torch.randn(ab["B"].shape, generator=gen)
        lora_np = {t: {k: v.numpy() for k, v in ab.items()}
                   for t, ab in lora.items()}
        h32.load_adapter.remote("llama-125m-fp32-ft", lora_np).result(
            timeout_s=120)
        adapted = over_http("llama-125m-fp32-ft")
        merged = InferenceEngine(m32, cfg32.engine, params=merge_lora(
            eng.params, lora_np, alpha=cfg32.lora.alpha), device="cuda")
        want_ft = merged.generate(ids, max_new_tokens=16, temperature=0.0)
        again = over_http()
        log(f"  LoRA adapter (rank 8, nonzero B) by model=: tokens == an "
            f"engine built with the merged params: {adapted == want_ft}, "
            f"differ from the base: {adapted != base}; the base model "
            f"after it: {again == base}")
        if adapted != want_ft or adapted == base or again != base:
            raise AssertionError(f"adapter {adapted} / merged engine "
                                 f"{want_ft}; base after {again}")
        del eng, merged
        serve.delete("fp32")
    finally:
        serve.shutdown()
        rt.shutdown()
        torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while _runtime_processes() and time.monotonic() < deadline:
        time.sleep(0.5)
    left = _runtime_processes()
    if left:
        raise AssertionError(f"runtime processes outlived shutdown: {left}")
    return out


# -------- phase 19: the disaggregated plane through the runtime --------


def _as_probe(serve, app, cls):
    """Make the deployment at `app`'s root run `cls` (a probe subclass of
    its class), with the same name and options (a tp gang's placement
    group's too)."""
    node = app.root
    c = node.deployment.config
    node.deployment = serve.deployment(
        cls, name=node.deployment.name, num_replicas=c.num_replicas,
        health_check_period_s=c.health_check_period_s,
        autoscaling_config=c.autoscaling_config,
        ray_actor_options=dict(c.ray_actor_options),
        placement_group_bundles=c.placement_group_bundles)


def _serve_disagg_probe_app(serve, me, cfg, disagg, name: str, port: int):
    """`serve.run(build_disagg_openai_app(cfg, disagg))` with the pools'
    classes made the probes (the same deployments and options): returns
    the handles of the coordinator, the prefill pool and the decode
    pool."""
    from ray_tpu_torch.llm import build_disagg_openai_app
    app = build_disagg_openai_app(cfg, disagg)
    coord = app.root.init_args[0].root
    _llm, _d, prefill, decode = coord.init_args
    _as_probe(serve, prefill, me.ProbePrefill)
    _as_probe(serve, decode, me.ProbeDecode)
    serve.run(app, name=name, route_prefix=f"/{name}", http_port=port,
              blocking_timeout_s=300)
    return tuple(serve.get_deployment_handle(n.name, name)
                 for n in (coord, prefill.root, decode.root))


def _each_replica(rt, handle, method: str, *args) -> list:
    """Call `method` on every live replica of a deployment (the probe
    reads each replica's own process), in the router's order."""
    router = handle._get_router()
    router._refresh(force=True)
    return [rt.get(router._handle_for(info).handle_request.remote(
        method, list(args), {}, ""), timeout=120)
        for info in router.live_replicas()]


def _post_status(url: str, body: dict, timeout: float = 180.0):
    """(HTTP status, JSON body) of a POST; an HTTP error's too."""
    import urllib.error
    try:
        return 200, _post(url, body, timeout)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _concurrently(fn, items, timeout: float = 300.0) -> list:
    """fn(item) for every item, each on a thread of its own, all started
    together; their results in order. Raises if one did not finish."""
    import threading
    out = [None] * len(items)

    def run(i):
        out[i] = fn(items[i])
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError("a client thread did not finish")
    return out


def _stream_tokens(reads: list) -> dict:
    """prompt ids -> the full token ids of the longest stream the decode
    replicas finished for it (a resumed stream's holds the tokens the
    client got before the resume)."""
    got = {}
    for r in reads:
        for prompt, toks in r["streams"]:
            if len(toks) > len(got.get(tuple(prompt), ())):
                got[tuple(prompt)] = toks
    return got


def _export_reads(reads: list, t0: float, t1: float) -> dict:
    """Of the prefill workers' export intervals: the count, the mean and
    median ms, the most in flight at once, and the share of [t0, t1]
    that at least one was running."""
    spans = sorted(iv for r in reads for iv in r["exports"])
    ms = sorted(1e3 * (b - a) for a, b in spans)
    busy, end, most = 0.0, t0, 0
    for a, b in spans:
        busy += max(0.0, min(b, t1) - max(a, end))
        end = max(end, b)
        most = max(most, sum(1 for c, d in spans if c <= a < d))
    return dict(n=len(ms), mean_ms=sum(ms) / max(len(ms), 1),
                median_ms=ms[len(ms) // 2] if ms else 0.0,
                most_in_flight=most, busy_share=busy / (t1 - t0))


def disagg_phase(torch, results, smi, serve_inproc, http_phase) -> dict:
    """The disaggregated plane through the port's runtime on the card:
    `serve.run(build_disagg_openai_app(cfg, DisaggConfig(prefill_replicas=
    1, decode_replicas=2)))`, the three pool replicas sharing the card by
    fractional GPU shares (their classes the probes `ProbePrefill` and
    `ProbeDecode`), the coordinator and the OpenAI router holding none,
    the HTTP proxy on a free port. bf16 llama-125m, the decode replicas at
    the serve phase's engine shape: phase 18's traffic as text from 36
    client threads; K1 n_layers launches per decode step summed over the
    decode replicas, plain 0; the prefill worker launches no plain paged
    kernel. fp32: tokens through HTTP == the in-process engine's == a
    forward argmax; the handoff after the store bit-equal to the pages of
    an engine that prefilled the prompt itself; a decode replica
    SIGKILLed mid-stream leaves every stream equal to the engine's and is
    respawned on its share; a burst past max_ongoing_requests sheds with
    HTTP 429 while the admitted requests finish exact."""
    import dataclasses as dc
    import importlib

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (DisaggConfig, EngineConfig,
                                   InferenceEngine, LLMConfig)
    from ray_tpu_torch.llm.serve import _open_kv
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import configs
    me = importlib.import_module("chip_smoke")
    tok = ByteTokenizer()
    port = _free_port()
    out = {}
    rng = np.random.default_rng(0)

    def text(n):
        return "".join(chr(c) for c in rng.integers(32, 127, n))
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, object_store_memory=1 << 30)
    try:
        model = configs.bench_125m()
        # The prefill worker prefills a prompt whole, in one bucket: the
        # 144-token prompts need the 256 bucket; the decode replicas
        # prefill this traffic's suffixes in the 128 one, as the serve
        # phase does.
        cfg = LLMConfig(model_id="llama-125m", model=model,
                        engine=EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128, 256),
                                            eos_token=-1),
                        num_gpus_per_replica=0.3, seed=0)
        url = f"http://127.0.0.1:{port}/disagg"
        t0 = time.perf_counter()
        coord, pre, dec = _serve_disagg_probe_app(
            serve, me, cfg, DisaggConfig(prefill_replicas=1,
                                         decode_replicas=2), "disagg", port)
        first = _post(url + "/v1/completions",
                      {"prompt": "hello", "max_tokens": 4,
                       "temperature": 0.0})
        boot_s = time.perf_counter() - t0
        if first["usage"]["completion_tokens"] != 4:
            raise AssertionError(f"first answer: {first}")
        prompts = [text(126) for _ in range(32)]   # 127 tokens with BOS
        shared = text(127)                         # BOS + 127: a page
        prompts += [shared + text(16) for _ in range(4)]
        _each_replica(rt, pre, "probe", True)
        steps0 = {r["pid"]: r["decode_steps"]
                  for r in _each_replica(rt, dec, "probe", True)}
        st0 = coord.stats.remote().result(timeout_s=60)
        t0, m0 = time.perf_counter(), time.monotonic()
        answers = _concurrently(lambda p: _post(url + "/v1/completions", {
            "prompt": p, "max_tokens": 64, "temperature": 0.0}), prompts)
        wall, m1 = time.perf_counter() - t0, time.monotonic()
        st = coord.stats.remote().result(timeout_s=60)
        pre_r = _each_replica(rt, pre, "probe")
        dec_r = _each_replica(rt, dec, "probe")
        d = {k: st.get(k, 0) - st0.get(k, 0)
             for k in ("admitted", "completed", "shed", "shed_requests",
                       "shed_prefill", "shed_decode", "shed_slo",
                       "route_prefix_hits", "handoff_tokens",
                       "streams_resumed")}
        n_tok = sum(a["usage"]["completion_tokens"] for a in answers)
        for r in dec_r:
            r["decode_steps"] -= steps0[r["pid"]]
        steps = sum(r["decode_steps"] for r in dec_r)
        k1 = {k: sum(r["k1"][k] for r in dec_r) for k in ("cuda", "plain")}
        hand = [b for r in dec_r for b in r["handoff_bytes"]]
        exp = _export_reads(pre_r, m0, m1)
        log(f"  bf16 through HTTP: {len(prompts)} requests from as many "
            f"client threads, {n_tok} tokens in {wall:.3f} s: "
            f"{n_tok / wall:.1f} tokens/s (the in-process serve phase: "
            f"{serve_inproc['tokens_per_s']:.1f}; phase 18 through HTTP: "
            f"{http_phase['tokens_per_s']:.1f}); boot (serve.run to the "
            f"first answer) {boot_s:.2f} s [{smi}]")
        log(f"  coordinator: {d}; ongoing {st['ongoing']}, live decode "
            f"replicas {st['n_decode_live']}")
        log(f"  decode replicas: decode steps "
            f"{[r['decode_steps'] for r in dec_r]}, K1 launches "
            f"{[r['k1'] for r in dec_r]}, handoffs {len(hand)} of "
            f"{sorted(set(hand))} bytes, peak device memory "
            f"{[round(r['peak'] / 2**30, 3) for r in dec_r]} GiB on "
            f"{sorted({r['device'] for r in dec_r})}")
        log(f"  prefill worker: {exp['n']} exports, {exp['mean_ms']:.2f} "
            f"ms each (median {exp['median_ms']:.2f}), up to "
            f"{exp['most_in_flight']} at once, some export running "
            f"{100 * exp['busy_share']:.1f} % of the wall; paged launches "
            f"{[r['k1'] for r in pre_r]}, peak device memory "
            f"{[round(r['peak'] / 2**30, 3) for r in pre_r]} GiB")
        if any(a["usage"]["completion_tokens"] != 64 for a in answers):
            raise AssertionError("a request did not finish with 64 tokens")
        if (d["admitted"] != len(prompts) or d["completed"] != len(prompts)
                or d["shed"] or st["ongoing"]):
            raise AssertionError(f"coordinator stats {st} (from {st0})")
        if d["handoff_tokens"] != 4 * 128 or len(hand) != 4:
            raise AssertionError(f"handoffs: {d['handoff_tokens']} tokens, "
                                 f"fetched {hand}")
        if k1["cuda"] != model.n_layers * steps or steps == 0:
            raise AssertionError(f"decode replicas' K1 launches "
                                 f"{k1['cuda']} != {model.n_layers} x "
                                 f"{steps} decode steps")
        if k1["plain"] != 0 or any(
                r[k]["plain"] for r in pre_r
                for k in ("k1", "verify", "verify_insert")):
            raise AssertionError("a plain paged path ran in a replica")
        results["paged_decode"]["disagg_decode_launches"] = k1["cuda"]
        # the prefill hop alone: one request at a time, its first token
        # only (no decode stream), the decode replicas idle
        _each_replica(rt, pre, "probe", True)
        solo, m0 = [], time.monotonic()
        for p in prompts[:2] + prompts[32:34]:
            t1 = time.perf_counter()
            a = _post(url + "/v1/completions", {"prompt": p, "max_tokens": 1,
                                                "temperature": 0.0})
            solo.append(1e3 * (time.perf_counter() - t1))
            if a["usage"]["completion_tokens"] != 1:
                raise AssertionError(f"a one-token answer: {a}")
        alone = _export_reads(_each_replica(rt, pre, "probe"), m0,
                              time.monotonic())
        log(f"  one request at a time, max_tokens 1 (127, 127, 144, 144 "
            f"tokens): {[round(x, 2) for x in solo]} ms through HTTP, "
            f"their exports {alone['mean_ms']:.2f} ms each (median "
            f"{alone['median_ms']:.2f})")
        out.update(tokens_per_s=n_tok / wall, boot_s=boot_s,
                   launches=k1["cuda"], steps=steps, stats=d,
                   export_ms=exp["mean_ms"], solo_ms=solo,
                   export_alone_ms=alone["mean_ms"],
                   handoff_bytes=hand[0] if hand else 0,
                   peaks=[r["peak"] for r in pre_r + dec_r])
        serve.delete("disagg")

        # fp32: exactness, the handoff bits, a kill and a shed burst
        m32 = dc.replace(configs.bench_125m(), dtype="float32")
        ecfg = EngineConfig(max_slots=8, max_len=1024,
                            prompt_buckets=(128, 512), eos_token=-1)
        cfg32 = LLMConfig(model_id="llama-125m-fp32", model=m32,
                          engine=ecfg, num_gpus_per_replica=0.3, seed=1)
        url = f"http://127.0.0.1:{port}/disagg32"
        coord, pre, dec = _serve_disagg_probe_app(
            serve, me, cfg32, DisaggConfig(prefill_replicas=1,
                                           decode_replicas=2,
                                           max_ongoing_requests=4),
            "disagg32", port)
        eng = InferenceEngine(m32, ecfg, seed=cfg32.seed, device="cuda")

        def post_all(texts, n_new):
            """[(HTTP status, body)] of the texts' requests, all at
            once."""
            return _concurrently(lambda t: _post_status(
                url + "/v1/completions", {"prompt": t, "max_tokens": n_new,
                                          "temperature": 0.0}), texts)

        def answered_tokens(texts, got, reads, n_new):
            """The token ids of each answered text, from the decode
            replicas' streams (None for a refused request); an answer's
            text must be its tokens' text and its length n_new."""
            streams = _stream_tokens(reads)
            toks = []
            for t, (code, body) in zip(texts, got):
                ids = streams.get(tuple(tok.encode(t)))
                if code != 200:
                    toks.append(None)
                elif (ids is None or len(ids) != n_new
                        or body["choices"][0]["text"] != tok.decode(ids)):
                    raise AssertionError(f"answer {body} / stream {ids}")
                else:
                    toks.append(ids)
            return toks

        def over_http(texts, n_new):
            _each_replica(rt, dec, "probe", True)
            got = post_all(texts, n_new)
            return (answered_tokens(texts, got,
                                    _each_replica(rt, dec, "probe"), n_new),
                    [code for code, _ in got])

        texts = [text(n) for n in (18, 139, 299)]  # 19, 140, 300 tokens
        ids = [tok.encode(t) for t in texts]
        base = [over_http([t], 16)[0][0] for t in texts]
        want = eng.generate(ids, max_new_tokens=16, temperature=0.0)
        argmax = forward_argmax(torch, eng.params, m32, ids, 16)
        log(f"  fp32 through HTTP: 3 prompts (19, 140, 300 tokens) x 16 "
            f"greedy tokens == the in-process engine: {base == want}, == "
            f"forward argmax: {base == argmax}")
        if not base == want == argmax:
            raise AssertionError(f"HTTP {base} / engine {want} / forward "
                                 f"{argmax}")

        # the handoff of the 300-token prompt after the store, against
        # the pages of an engine that prefilled the prompt itself
        sealed = pre.prefill.remote(ids[2], 0.0).result(timeout_s=120)
        ks, vs = _open_kv(rt.get(sealed["kv"], timeout=60))
        imp = InferenceEngine(m32, ecfg, params=eng.params, device="cuda")
        if imp.import_kv(ids[2], ks, vs) != 2:
            raise AssertionError("the handoff did not import 2 pages")
        own = InferenceEngine(m32, ecfg, params=eng.params, device="cuda")
        own.generate([ids[2]], max_new_tokens=1, temperature=0.0)
        page = ecfg.page_size
        same = []
        for i in range(2):
            key = imp._prefix_hash(ids[2][:(i + 1) * page])
            a, b = imp.page_hash[key], own.page_hash[key]
            same += [torch.equal(imp.cache_k[:, :, a], own.cache_k[:, :, b]),
                     torch.equal(imp.cache_v[:, :, a], own.cache_v[:, :, b])]
        log(f"  fp32 handoff after the store: {tuple(ks.shape)} "
            f"{ks.dtype}, import_kv'd pages bit-equal to an engine's own "
            f"prefill: {all(same)}")
        if not all(same):
            raise AssertionError(f"handoff pages differ: {same}")
        del imp, own

        # a decode replica SIGKILLed mid-stream
        reads = _each_replica(rt, dec, "probe", True)
        pids0 = {r["pid"] for r in reads}
        router = dec._get_router()
        killed = rt.get(router._handle_for(router.live_replicas()[0])
                        .handle_request.remote(
                            "configure_chaos", ["serve.decode.kill:2", 3],
                            {}, ""), timeout=60)
        st0 = coord.stats.remote().result(timeout_s=60)
        texts = [text(n) for n in (59, 149, 199, 259)]
        got = post_all(texts, 32)
        st = coord.stats.remote().result(timeout_s=60)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                reads = _each_replica(rt, dec, "probe")
            except (rt.RayTpuError, ValueError):
                reads = []  # the dead replica still listed: ask again
            pids = {r["pid"] for r in reads}
            if len(pids) == 2 and killed not in pids:
                break
            time.sleep(1.0)
        codes = [code for code, _ in got]
        toks = answered_tokens(texts, got, reads, 32)
        want = eng.generate([tok.encode(t) for t in texts],
                            max_new_tokens=32, temperature=0.0)
        resumed = st.get("streams_resumed", 0) - st0.get("streams_resumed", 0)
        log(f"  kill: replica pid {killed} armed with serve.decode.kill:2; "
            f"4 streams x 32 tokens, HTTP {codes}, == the in-process "
            f"engine: {toks == want}; streams resumed {resumed}, decode "
            f"failures {st.get('decode_failures', 0)}; decode pool pids "
            f"{sorted(pids0)} -> {sorted(pids)} on "
            f"{sorted({r['device'] for r in reads})}")
        if codes != [200] * 4 or toks != want or resumed < 1:
            raise AssertionError(f"kill: {codes}, {toks} != {want}, "
                                 f"resumed {resumed}")
        if len(pids) != 2 or killed in pids or not all(
                r["device"] == torch.cuda.get_device_name(0)
                for r in reads):
            raise AssertionError(f"decode pool not respawned on the card: "
                                 f"{reads}")

        # a burst past max_ongoing_requests = 4
        st0 = coord.stats.remote().result(timeout_s=60)
        texts = [text(24) for _ in range(12)]
        got, codes = over_http(texts, 16)
        st = coord.stats.remote().result(timeout_s=60)
        ok = [i for i, c in enumerate(codes) if c == 200]
        want = eng.generate([tok.encode(texts[i]) for i in ok],
                            max_new_tokens=16, temperature=0.0)
        sheds = st.get("shed_requests", 0) - st0.get("shed_requests", 0)
        log(f"  burst of 12 past max_ongoing_requests 4: HTTP {codes}; "
            f"{len(ok)} admitted == the in-process engine: "
            f"{[got[i] for i in ok] == want}; sheds (requests) {sheds}")
        if (codes.count(429) == 0 or not ok or set(codes) - {200, 429}
                or [got[i] for i in ok] != want
                or sheds != codes.count(429)):
            raise AssertionError(f"burst: {codes}, {st}")
        del eng
        serve.delete("disagg32")
    finally:
        serve.shutdown()
        rt.shutdown()
        torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while _runtime_processes() and time.monotonic() < deadline:
        time.sleep(0.5)
    left = _runtime_processes()
    if left:
        raise AssertionError(f"runtime processes outlived shutdown: {left}")
    return out


# ------- phase 20: tensor-parallel replicas as process gangs -------


def _gang_reads(handle, reset: bool = False) -> list:
    """Every rank's reads of a tp replica (`rank_reads` of the probe, by
    the replica's `gang_call`), by rank."""
    return handle.gang_call.remote("rank_reads", reset).result(timeout_s=120)


def _gang_steps(reads: list, before: list) -> list:
    """Each rank's decode steps since `before`."""
    return [r["decode_steps"] - b["decode_steps"]
            for r, b in zip(reads, before)]


def _check_gang_k1(reads: list, before: list, n_layers: int, what: str):
    """Each rank's decode steps since `before` (equal on every rank, > 0),
    K1 n_layers launches a step on each rank and never the plain path;
    the steps."""
    steps = _gang_steps(reads, before)
    if len(set(steps)) != 1 or steps[0] == 0:
        raise AssertionError(f"{what}: the ranks' decode steps {steps}")
    for r, s in zip(reads, steps):
        if r["k1"] != {"cuda": n_layers * s, "plain": 0}:
            raise AssertionError(f"{what}: a rank's K1 launches {r['k1']} "
                                 f"for {s} decode steps")
    return steps[0]


def _replaced(handle, old: set, timeout: float = 120.0) -> list:
    """Wait until the replica's gang is a new one (no rank of `old`):
    its reads by rank."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            reads = _gang_reads(handle)
            if not {r["pid"] for r in reads} & old:
                return reads
        except Exception:  # noqa: BLE001 — the broken gang, still listed
            pass
        time.sleep(0.5)
    raise AssertionError(f"the gang of ranks {sorted(old)} was not replaced "
                         f"in {timeout} s")


TP_GANG_REQUESTS = 8       # (a)'s bf16 prompts besides the 4 sharing a page
TP_GANG_BURST_TOKENS = 16  # (b)'s greedy tokens a request


def tp_gang_phase(torch, results, smi, serve_inproc, tp_inproc, http_phase,
                  disagg) -> dict:
    """tp = 2 replicas as gangs of two processes through the port's
    runtime on the card. (a) `serve.run(build_openai_app(cfg))` with
    tensor_parallelism=2 and num_gpus_per_replica=1.0: two ranks at 0.5
    GPU over gloo in one placement group (the replica's class the probe
    `ProbeServer`). llama-125m bf16 at the serve phase's engine shape,
    TP_GANG_REQUESTS of phase 18's 127-token prompts and its 4 sharing a
    page, 64 tokens each, from as many client threads: both ranks take the
    same
    decode steps, K1 n_layers launches a step on each and no plain run.
    fp32: tokens through HTTP == the tp = 1 in-process engine's == a
    forward argmax; a LoRA adapter registered through the handle == an
    engine on the merged params; a follower SIGKILLed, the whole gang
    replaced on the card and the next request exact. (b) the
    disaggregated pools as gangs (`DisaggConfig(prefill_replicas=1,
    decode_replicas=1)`, num_gpus_per_replica=0.5: four processes on the
    card): a bf16 burst of those 12 requests (TP_GANG_BURST_TOKENS
    tokens each) timed, K1 on both decode ranks,
    each one-page handoff as many bytes as phase 19's; fp32 tokens of the
    300-token prompt through HTTP == the monolithic engine's, its sealed
    handoff full width and within 1e-4 of the tp = 1 export. No runtime
    process outlives the phase."""
    import dataclasses as dc
    import importlib
    import signal

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (DisaggConfig, EngineConfig,
                                   InferenceEngine, LLMConfig, LoraConfig,
                                   PrefillEngine)
    from ray_tpu_torch.llm.lora import init_lora, merge_lora
    from ray_tpu_torch.llm.serve import _open_kv
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import configs
    me = importlib.import_module("chip_smoke")
    tok = ByteTokenizer()
    port = _free_port()
    card = torch.cuda.get_device_name(0)
    out = {}
    rng = np.random.default_rng(0)

    def text(n):
        return "".join(chr(c) for c in rng.integers(32, 127, n))
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, object_store_memory=1 << 30)
    try:
        # (a) the monolithic deployment
        model = configs.bench_125m()
        cfg = LLMConfig(model_id="llama-125m", model=model,
                        engine=EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128,),
                                            eos_token=-1),
                        tensor_parallelism=2, num_gpus_per_replica=1.0,
                        seed=0)
        url = f"http://127.0.0.1:{port}/tp"
        t0 = time.perf_counter()
        h = _serve_probe_app(serve, me, cfg, "tp", port)
        first = _post(url + "/v1/completions",
                      {"prompt": "hello", "max_tokens": 4,
                       "temperature": 0.0})
        boot_s = time.perf_counter() - t0
        if first["usage"]["completion_tokens"] != 4:
            raise AssertionError(f"first answer: {first}")
        prompts = [text(126) for _ in range(TP_GANG_REQUESTS)]  # 127 tokens
        shared = text(127)                         # BOS + 127: a page
        prompts += [shared + text(16) for _ in range(4)]
        before = _gang_reads(h, reset=True)
        t0 = time.perf_counter()
        answers = _concurrently(lambda p: _post(url + "/v1/completions", {
            "prompt": p, "max_tokens": 64, "temperature": 0.0}), prompts)
        wall = time.perf_counter() - t0
        reads = _gang_reads(h)
        n_tok = sum(a["usage"]["completion_tokens"] for a in answers)
        log(f"  (a) bf16 tp=2 through HTTP: {len(prompts)} requests from "
            f"as many client threads, {n_tok} tokens in {wall:.3f} s: "
            f"{n_tok / wall:.1f} tokens/s (phase 16, tp=2 in process: "
            f"{tp_inproc['tokens_per_s']:.1f}; phase 18, tp=1 through "
            f"HTTP: {http_phase['tokens_per_s']:.1f}; phase 4: "
            f"{serve_inproc['tokens_per_s']:.1f}); boot (serve.run to the "
            f"first answer) {boot_s:.2f} s [{smi}]")
        log(f"  ranks: decode steps {_gang_steps(reads, before)}"
            f", K1 launches {[r['k1'] for r in reads]}, peak device memory "
            f"{[round(r['peak'] / 2**30, 3) for r in reads]} GiB, on "
            f"{sorted({r['device'] for r in reads})}, pids "
            f"{[r['pid'] for r in reads]}")
        if any(a["usage"]["completion_tokens"] != 64 for a in answers):
            raise AssertionError("a request did not finish with 64 tokens")
        steps = _check_gang_k1(reads, before, model.n_layers, "tp=2 bf16")
        if len({r["pid"] for r in reads}) != 2 or any(
                r["device"] != card for r in reads):
            raise AssertionError(f"the ranks: {reads}")
        results["paged_decode"]["tp_gang_launches"] = sum(
            r["k1"]["cuda"] for r in reads)
        out.update(tokens_per_s=n_tok / wall, boot_s=boot_s, steps=steps,
                   peaks=[r["peak"] for r in reads])
        serve.delete("tp")

        m32 = dc.replace(configs.bench_125m(), dtype="float32")
        cfg32 = LLMConfig(model_id="llama-125m-fp32", model=m32,
                          engine=EngineConfig(max_slots=4, max_len=256,
                                              prompt_buckets=(128,),
                                              eos_token=-1),
                          lora=LoraConfig(rank=8), tensor_parallelism=2,
                          num_gpus_per_replica=1.0, seed=1)
        url = f"http://127.0.0.1:{port}/tp32"
        h32 = _serve_probe_app(serve, me, cfg32, "tp32", port)
        texts = [text(n) for n in (19, 56, 99)]
        ids = [tok.encode(t) for t in texts]

        def over_http(model_id=None):
            h32.probe.remote(reset=True).result(timeout_s=60)
            got = [_post(url + "/v1/completions", {
                "prompt": t, "max_tokens": 16, "temperature": 0.0,
                **({"model": model_id} if model_id else {})})
                for t in texts]
            answered = h32.probe.remote().result(timeout_s=60)["answered"]
            if [a[0] for a in answered] != ids:
                raise AssertionError("the replica answered other prompts")
            toks = [a[1] for a in answered]
            if [g["choices"][0]["text"] for g in got] != [
                    tok.decode(t) for t in toks]:
                raise AssertionError("HTTP text != the decoded tokens")
            return toks
        base = over_http()
        eng = InferenceEngine(m32, cfg32.engine, seed=cfg32.seed,
                              device="cuda")
        want = eng.generate(ids, max_new_tokens=16, temperature=0.0)
        argmax = forward_argmax(torch, eng.params, m32, ids, 16)
        log(f"  (a) fp32 tp=2 through HTTP: 3 prompts x 16 greedy tokens "
            f"== the tp=1 in-process engine: {base == want}, == forward "
            f"argmax: {base == argmax}")
        if not base == want == argmax:
            raise AssertionError(f"HTTP {base} / engine {want} / forward "
                                 f"{argmax}")
        gen = torch.Generator().manual_seed(7)
        lora = init_lora(m32, 8, gen)
        for ab in lora.values():
            ab["B"] = torch.randn(ab["B"].shape, generator=gen)
        lora_np = {t: {k: v.numpy() for k, v in ab.items()}
                   for t, ab in lora.items()}
        h32.load_adapter.remote("llama-125m-fp32-ft", lora_np).result(
            timeout_s=120)
        adapted = over_http("llama-125m-fp32-ft")
        merged = InferenceEngine(m32, cfg32.engine, params=merge_lora(
            eng.params, lora_np, alpha=cfg32.lora.alpha), device="cuda")
        want_ft = merged.generate(ids, max_new_tokens=16, temperature=0.0)
        del merged
        log(f"  (a) LoRA adapter through the handle, both ranks: tokens == "
            f"an engine on the merged params: {adapted == want_ft}, differ "
            f"from the base: {adapted != base}")
        if adapted != want_ft or adapted == base:
            raise AssertionError(f"adapter {adapted} / merged engine "
                                 f"{want_ft}")
        old = [r["pid"] for r in _gang_reads(h32)]
        t0 = time.perf_counter()
        os.kill(old[1], signal.SIGKILL)
        new = _replaced(h32, set(old))
        replace_s = time.perf_counter() - t0
        again = over_http()
        log(f"  (a) follower pid {old[1]} SIGKILLed: gang {old} replaced "
            f"by {[r['pid'] for r in new]} on "
            f"{sorted({r['device'] for r in new})} in {replace_s:.2f} s; "
            f"the next requests == the tokens before: {again == base}")
        if again != base or any(r["device"] != card for r in new):
            raise AssertionError(f"after the kill: {again} / {new}")
        out["replace_s"] = replace_s
        serve.delete("tp32")

        # (b) the disaggregated pools, each a gang of two ranks
        cfgd = LLMConfig(model_id="llama-125m", model=model,
                         engine=EngineConfig(max_slots=32, max_len=1024,
                                             prompt_buckets=(128, 256),
                                             eos_token=-1),
                         tensor_parallelism=2, num_gpus_per_replica=0.5,
                         seed=0)
        url = f"http://127.0.0.1:{port}/tpd"
        t0 = time.perf_counter()
        _coord, pre, dec = _serve_disagg_probe_app(
            serve, me, cfgd, DisaggConfig(prefill_replicas=1,
                                          decode_replicas=1), "tpd", port)
        _post(url + "/v1/completions", {"prompt": "hello", "max_tokens": 4,
                                        "temperature": 0.0})
        boot_d = time.perf_counter() - t0
        burst = prompts
        before = _gang_reads(dec, reset=True)
        pre_before = _gang_reads(pre, reset=True)
        dec.probe.remote(reset=True).result(timeout_s=60)
        t0 = time.perf_counter()
        answers = _concurrently(lambda p: _post(url + "/v1/completions", {
            "prompt": p, "max_tokens": TP_GANG_BURST_TOKENS,
            "temperature": 0.0}), burst)
        wall_d = time.perf_counter() - t0
        dreads, preads = _gang_reads(dec), _gang_reads(pre)
        hand = dec.probe.remote().result(timeout_s=60)["handoff_bytes"]
        n_tok = sum(a["usage"]["completion_tokens"] for a in answers)
        log(f"  (b) bf16 pools at tp=2 (4 processes at 0.25 GPU): "
            f"{len(burst)} requests, {n_tok} tokens in {wall_d:.3f} s: "
            f"{n_tok / wall_d:.1f} tokens/s (phase 19: "
            f"{disagg['tokens_per_s']:.1f}); boot {boot_d:.2f} s; decode "
            f"ranks' steps {_gang_steps(dreads, before)}"
            f", K1 {[r['k1'] for r in dreads]}; handoffs {hand} B (phase "
            f"19: {disagg['handoff_bytes']} B a page); peak device memory "
            f"{[round(r['peak'] / 2**30, 3) for r in preads + dreads]} GiB "
            f"[{smi}]")
        if any(a["usage"]["completion_tokens"] != TP_GANG_BURST_TOKENS
               for a in answers):
            raise AssertionError(f"a request did not finish with "
                                 f"{TP_GANG_BURST_TOKENS} tokens")
        _check_gang_k1(dreads, before, model.n_layers, "tp=2 decode pool")
        if any(r[k]["plain"] for r in preads for k in
               ("k1", "verify", "verify_insert")) or any(
                r["k1"]["cuda"] for r in preads):
            raise AssertionError(f"the prefill ranks ran paged kernels: "
                                 f"{preads} (from {pre_before})")
        if len(hand) != 4 or set(hand) != {disagg["handoff_bytes"]}:
            raise AssertionError(f"one-page handoffs of {hand} B, phase "
                                 f"19's {disagg['handoff_bytes']} B")
        results["paged_decode"]["tp_disagg_launches"] = sum(
            r["k1"]["cuda"] for r in dreads)
        out.update(disagg_tokens_per_s=n_tok / wall_d, disagg_boot_s=boot_d)
        serve.delete("tpd")

        ecfg = EngineConfig(max_slots=8, max_len=1024,
                            prompt_buckets=(128, 512), eos_token=-1)
        cfgd32 = LLMConfig(model_id="llama-125m-fp32", model=m32,
                           engine=ecfg, tensor_parallelism=2,
                           num_gpus_per_replica=0.5, seed=1)
        url = f"http://127.0.0.1:{port}/tpd32"
        _coord, pre, dec = _serve_disagg_probe_app(
            serve, me, cfgd32, DisaggConfig(prefill_replicas=1,
                                            decode_replicas=1), "tpd32",
            port)
        long = text(299)                            # 300 tokens
        ids = tok.encode(long)
        dec.probe.remote(reset=True).result(timeout_s=60)
        got = _post(url + "/v1/completions", {"prompt": long,
                                              "max_tokens": 16,
                                              "temperature": 0.0})
        streams = _stream_tokens([dec.probe.remote().result(timeout_s=60)])
        toks = streams.get(tuple(ids))
        eng = InferenceEngine(m32, ecfg, params=eng.params, device="cuda")
        want = eng.generate([ids], max_new_tokens=16, temperature=0.0)[0]
        argmax = forward_argmax(torch, eng.params, m32, [ids], 16)[0]
        sealed = pre.prefill.remote(ids, 0.0).result(timeout_s=120)
        ks, vs = _open_kv(rt.get(sealed["kv"], timeout=60))
        _f, ks1, vs1 = PrefillEngine(m32, ecfg, params=eng.params,
                                     device="cuda").prefill_export(
            ids, temperature=0.0)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in ((ks, ks1), (vs, vs1)))
        log(f"  (b) fp32 pools at tp=2: the 300-token prompt x 16 greedy "
            f"tokens through HTTP == the monolithic engine: {toks == want}"
            f", == forward argmax: {toks == argmax}; sealed handoff "
            f"{tuple(ks.shape)} {ks.dtype} (tp=1's {tuple(ks1.shape)}), "
            f"max abs err against the tp=1 export {err:.3g} (limit 1e-4)")
        if (toks != want or toks != argmax
                or got["choices"][0]["text"] != tok.decode(want)):
            raise AssertionError(f"HTTP {toks} / engine {want} / forward "
                                 f"{argmax}")
        # 1e-4: each rank sums its half of the projections (another
        # cuBLAS order than tp = 1's); 8.23e-06 read on the H100
        if ks.shape != ks1.shape or ks.shape[2] != m32.n_kv_heads or \
                err > 1e-4:
            raise AssertionError(f"the sealed handoff {tuple(ks.shape)}, "
                                 f"err {err}")
        out["handoff_err"] = err
        del eng
        serve.delete("tpd32")
    finally:
        serve.shutdown()
        rt.shutdown()
        torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while _runtime_processes() and time.monotonic() < deadline:
        time.sleep(0.5)
    left = _runtime_processes()
    if left:
        raise AssertionError(f"runtime processes outlived shutdown: {left}")
    return out


# -------- phase 21: the data library, batch inference and ingest --------


def _make_probe_engine():
    from ray_tpu_torch.llm.batch import _EngineUDF

    class ProbeEngine(_EngineUDF):
        """The batch processor's engine stage with reads of its own
        process: after each block it puts `_replica_reads` (the paged
        kernels' launch counts, the engine's decode steps, its peak
        device memory), its `kv_stats()`, its blocks, the prompt and
        generated token ids it answered and the host clock into the
        runtime's KV under ("probe_engine", pid); at construction the
        clock it was ready at."""

        def __init__(self, *args):
            t0 = time.time()
            super().__init__(*args)
            self.blocks, self.answered = 0, []
            self._put("ready", dict(start=t0, ready=time.time()))

        @staticmethod
        def _put(what, value):
            from ray_tpu_torch.core.runtime import get_runtime
            get_runtime().request("kv_put", (
                ("probe_engine", what, os.getpid()), value))

        def __call__(self, batch):
            out = super().__call__(batch)
            self.blocks += 1
            self.answered += [
                ([int(t) for t in p], [int(t) for t in g]) for p, g in zip(
                    batch["__token_ids"], out["__generated_ids"])]
            self._put("reads", dict(
                _replica_reads(self.engine), kv=self.engine.kv_stats(),
                blocks=self.blocks, answered=list(self.answered),
                wall=time.time()))
            return out
    return ProbeEngine


def _probe_engine_reads(head, what: str) -> dict:
    """pid -> the probes' last `what` record in the runtime's KV, removed
    from it."""
    keys = [k for k in list(head.kv) if isinstance(k, tuple) and
            k[:2] == ("probe_engine", what)]
    return {k[2]: head.kv_take(k) for k in keys}


def ingest_loop(config):
    """A Trainer loop fed by its dataset shard: each batch of
    `get_dataset_shard("train").iter_torch_batches(device="cuda")`, rows of
    `batch_size` token ids [S + 1] (column `config["column"]`, default
    "data"), is one AdamW step of the port's train
    step on llama-125m (`configs.bench_125m`, random weights from seed 0)
    in `config["dtype"]`. Each report carries the loss, the step's host
    ms (ended by the loss readback), the ms the batch took to arrive, the
    worker's K2-K4 launch counts since the loop began, each row's sum
    (which rows the worker saw, in order), the batch's device and the
    worker's peak device memory."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.torch import get_device
    dev = get_device()   # raises where the rank's card is not visible
    if dev.type != "cuda":
        raise RuntimeError(f"the trainer's rank runs on {dev}, not a card")
    cfg = dataclasses.replace(configs.bench_125m(), dtype=config["dtype"])
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(3e-4), device=dev)
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0), dev))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    batches = train.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch_size"], device="cuda")
    t_wait = time.perf_counter()
    for step, batch in enumerate(batches):
        tokens = batch[config.get("column", "data")]
        t0 = time.perf_counter()
        state, loss = step_fn(state, {"tokens": tokens})
        loss = loss.item()   # the step's fence
        t1 = time.perf_counter()
        train.report(dict(step=step, loss=loss, ms=(t1 - t0) * 1e3,
                          wait_ms=(t0 - t_wait) * 1e3, counts=bwd_counts(),
                          rows=tokens.sum(dim=1).tolist(),
                          device=str(tokens.device),
                          peak=torch.cuda.max_memory_allocated(),
                          name=torch.cuda.get_device_name(0)))
        t_wait = time.perf_counter()


def _driver_batch_losses(torch, dtype: str, tokens, batch_size: int) -> list:
    """The ingest loop's steps run in this process on the same batches:
    its losses."""
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import adamw, make_train_step
    cfg = dataclasses.replace(configs.bench_125m(), dtype=dtype)
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(3e-4), device="cuda")
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0),
                                "cuda"))
    out = []
    for i in range(0, len(tokens), batch_size):
        batch = {"tokens": torch.tensor(tokens[i:i + batch_size],
                                        device="cuda")}
        state, loss = step_fn(state, batch)
        out.append(loss.item())
    del state
    torch.cuda.empty_cache()
    return out


def data_phase(torch, results, smi, serve_inproc, http_phase, train,
               trainer) -> dict:
    """The data library on the card (phase 21). (a) batch inference:
    `build_llm_processor` (llama-125m bf16 at the serve phase's engine
    shape, its engine stage one actor reserving the card, its class the
    probe `ProbeEngine`) over `from_items` of 256 byte-tokenizer prompts
    of 127 tokens in 4 blocks, 64 greedy tokens each, batches of 64: every
    row back in input order with its prompt; K1 12 launches per decode
    step of the actor, plain 0; tokens/s over the processor's wall beside
    phases 4 and 18, the time to the first output row, the actor's decode
    steps and peak. (b) fp32, 8 prompts x 16 tokens, batches of 3, two
    engine actors at 0.5 GPU: each row's tokens and text == the
    in-process engine's == a forward argmax; a CUDA config reserving no
    GPU and one at tensor_parallelism=2 refused before any actor starts.
    (c) Trainer ingest: `TorchTrainer` on one worker holding the card,
    `datasets={"train": from_numpy(tokens)}`, the loop stepping on
    `iter_torch_batches(batch_size=16, device="cuda")`: 6 bf16 steps of
    16 x 1024 (3 warm-up, 3 timed) beside phase 17's ms/step, K2-K4 12
    launches a step in the worker, plain 0, every row seen once in order;
    fp32 2 x 256, 3 steps through the dataset bit-equal to the same
    batches in this process. No runtime process outlives the phase."""
    import dataclasses as dc
    import importlib
    import tempfile

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.core.runtime import current_runtime
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, LLMConfig
    from ray_tpu_torch.llm import batch as batch_mod
    from ray_tpu_torch.llm import build_llm_processor
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.train import RunConfig, ScalingConfig, Trainer
    from ray_tpu_torch.util.state import list_actors
    me = importlib.import_module("chip_smoke")
    tok = ByteTokenizer()
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    storage = tempfile.mkdtemp(prefix="ingest-", dir=os.path.join(ROOT, "tmp"))
    out = {}
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, object_store_memory=1 << 30)
    head = current_runtime()
    engine_cls = batch_mod._EngineUDF
    batch_mod._EngineUDF = me.ProbeEngine   # the processor's engine stage
    try:
        rng = np.random.default_rng(0)

        def text(n):
            return "".join(chr(c) for c in rng.integers(32, 127, n))
        model = configs.bench_125m()
        cfg = LLMConfig(model_id="llama-125m", model=model,
                        engine=EngineConfig(max_slots=32, max_len=1024,
                                            prompt_buckets=(128,),
                                            eos_token=-1),
                        num_gpus_per_replica=1.0, seed=0)
        prompts = [text(126) for _ in range(256)]   # 127 tokens with BOS
        ds = rd.from_items([{"idx": i, "prompt": p}
                            for i, p in enumerate(prompts)],
                           override_num_blocks=4)
        proc = build_llm_processor(cfg, max_new_tokens=64, temperature=0.0,
                                   batch_size=64, concurrency=1)
        t0 = time.time()
        rows, first = [], None
        for row in proc(ds).iter_rows():
            if first is None:
                first = time.time() - t0
            rows.append(row)
        wall = time.time() - t0
        ready = _probe_engine_reads(head, "ready")
        reads = _probe_engine_reads(head, "reads")
        if len(reads) != 1 or len(ready) != 1:
            raise AssertionError(f"engine actors: {sorted(reads)}, "
                                 f"ready {sorted(ready)}")
        (r,) = reads.values()
        (rd_,) = ready.values()
        steps, k1 = r["decode_steps"], r["k1"]
        n_tok = sum(len(g) for _p, g in r["answered"])
        log(f"  (a) batch inference: {len(rows)} rows, {n_tok} tokens in "
            f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s over the "
            f"processor's wall (phase 4 in process "
            f"{serve_inproc['tokens_per_s']:.1f}, phase 18 through HTTP "
            f"{http_phase['tokens_per_s']:.1f}); first output row after "
            f"{first:.3f} s; the engine actor ready "
            f"{rd_['ready'] - t0:.2f} s after the start (its construction "
            f"{rd_['ready'] - rd_['start']:.2f} s), its last block done "
            f"{r['wall'] - t0:.2f} s after it; {r['blocks']} blocks, "
            f"{steps} decode steps, K1 launches {k1['cuda']}, plain "
            f"{k1['plain']}; actor on {r['device']}, peak "
            f"{r['peak'] / 2**30:.3f} GiB [{smi}]")
        if [x["idx"] for x in rows] != list(range(256)) or [
                x["prompt"] for x in rows] != prompts:
            raise AssertionError("the processor's rows are not the input's "
                                 "in order")
        if [p for p, _g in r["answered"]] != [tok.encode(p)
                                              for p in prompts]:
            raise AssertionError("the engine actor answered other prompts")
        if any(len(g) != 64 for _p, g in r["answered"]) or [
                x["generated"] for x in rows] != [
                tok.decode(g) for _p, g in r["answered"]]:
            raise AssertionError("a row's text is not its 64 tokens")
        if k1["cuda"] != model.n_layers * steps or steps == 0:
            raise AssertionError(f"actor K1 launches {k1['cuda']} != "
                                 f"{model.n_layers} x {steps} decode steps")
        if k1["plain"] != 0 or r["verify"]["plain"] or \
                r["verify_insert"]["plain"]:
            raise AssertionError(f"a plain paged path ran in the actor: {r}")
        results["paged_decode"]["batch_actor_launches"] = k1["cuda"]
        out.update(tokens_per_s=n_tok / wall, first_row_s=first,
                   steps=steps, peak=r["peak"], wall_s=wall)

        # (b) fp32: two engine actors at 0.5 GPU, uneven blocks
        m32 = dc.replace(configs.bench_125m(), dtype="float32")
        cfg32 = LLMConfig(model_id="llama-125m-fp32", model=m32,
                          engine=EngineConfig(max_slots=4, max_len=256,
                                              prompt_buckets=(128,),
                                              eos_token=-1),
                          num_gpus_per_replica=0.5, seed=1)
        texts = [text(n) for n in (19, 56, 99, 7, 33, 120, 64, 1)]
        ids = [tok.encode(t) for t in texts]
        got = build_llm_processor(
            cfg32, max_new_tokens=16, temperature=0.0, batch_size=3,
            concurrency=2)(rd.from_items(
                [{"idx": i, "prompt": t} for i, t in enumerate(texts)],
                override_num_blocks=3)).take_all()
        reads = _probe_engine_reads(head, "reads")
        _probe_engine_reads(head, "ready")
        answered = dict((tuple(p), g) for rr in reads.values()
                        for p, g in rr["answered"])
        toks = [answered.get(tuple(i)) for i in ids]
        eng = InferenceEngine(m32, cfg32.engine_config(tok),
                              seed=cfg32.seed, device="cuda")
        want = eng.generate(ids, max_new_tokens=16, temperature=0.0)
        argmax = forward_argmax(torch, eng.params, m32, ids, 16)
        del eng
        torch.cuda.empty_cache()
        log(f"  (b) fp32, 8 prompts x 16 greedy tokens through two engine "
            f"actors at 0.5 GPU ({len(reads)} actors, blocks "
            f"{[rr['blocks'] for rr in reads.values()]}): tokens == the "
            f"in-process engine: {toks == want}, == forward argmax: "
            f"{toks == argmax}; rows in order with the decoded text: "
            f"{[x['idx'] for x in got] == list(range(8))}")
        if len(reads) != 2 or not toks == want == argmax:
            raise AssertionError(f"actors {len(reads)}: tokens {toks} / "
                                 f"engine {want} / forward {argmax}")
        if [x["idx"] for x in got] != list(range(8)) or [
                x["prompt"] for x in got] != texts or [
                x["generated"] for x in got] != [tok.decode(w)
                                                 for w in want]:
            raise AssertionError(f"fp32 rows: {got}")
        before = len(list_actors())   # every actor made, dead or alive
        for bad, match in ((dc.replace(cfg32, num_gpus_per_replica=0),
                            "reserve one"),
                           (dc.replace(cfg32, tensor_parallelism=2),
                            "one process a replica")):
            try:
                build_llm_processor(bad)
            except ValueError as e:
                if match not in str(e):
                    raise
            else:
                raise AssertionError(f"{bad} was not refused")
        if len(list_actors()) != before:
            raise AssertionError("a refused processor started an actor")
        log("  a CUDA config reserving no GPU and one at "
            "tensor_parallelism=2: refused when built, no actor started")

        # (c) the Trainer fed by a Dataset on the card
        one_gpu = ScalingConfig(num_workers=1, use_gpu=True)
        tokens = np.random.default_rng(0).integers(
            0, model.vocab, (TRAIN_BATCH * 6, TRAIN_SEQ + 1)).astype(
            np.int32)
        res = Trainer(me.ingest_loop, train_loop_config=dict(
            dtype="bfloat16", batch_size=TRAIN_BATCH),
            scaling_config=one_gpu,
            run_config=RunConfig(name="ingest", storage_path=storage),
            datasets={"train": rd.from_numpy(tokens)}).fit()
        if res.error is not None:
            raise AssertionError(f"bf16 ingest fit: {res.error}")
        hist = res.metrics_history
        ms = [m["ms"] for m in hist]
        timed = sorted(ms[3:])
        counts = hist[-1]["counts"]
        log(f"  (c) Trainer ingest: {len(hist)} bf16 steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} from iter_torch_batches on "
            f"{hist[-1]['device']} ({hist[-1]['name']}): ms/step " +
            ", ".join(f"{x:.2f}" for x in ms) + f"; steps 4-6 median "
            f"{timed[len(timed) // 2]:.2f} (phase 17's trainer "
            f"{trainer['step_ms']:.2f}, phase 8 in process "
            f"{train['step_ms']:.2f}); batch waits " + ", ".join(
                f"{m['wait_ms']:.2f}" for m in hist) + f" ms; worker "
            f"peak {hist[-1]['peak'] / 2**30:.3f} GiB; launches K2 "
            f"{counts['fwd']}, K3 {counts['dq']}, K4 {counts['dkv']} "
            f"[{smi}]")
        want_rows = tokens.astype(np.int64).sum(axis=1).tolist()
        if [r for m in hist for r in m["rows"]] != want_rows:
            raise AssertionError("the worker did not see every row once, "
                                 "in order")
        if [m["step"] for m in hist] != list(range(6)) or not all(
                math.isfinite(m["loss"]) for m in hist) or not all(
                m["device"].startswith("cuda") for m in hist):
            raise AssertionError(f"bf16 ingest reports: {hist}")
        want = model.n_layers * len(hist)
        for key in ("fwd", "dq", "dkv"):
            if counts[key] != {"cuda": want, "plain": 0}:
                raise AssertionError(f"ingest worker ran {key} "
                                     f"{counts[key]}, want {want} kernel "
                                     f"launches, 0 plain")
        for kernel, key in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                            ("flash_bwd_dkv", "dkv")):
            results[kernel]["ingest_launches"] = counts[key]["cuda"]
        out.update(step_ms=timed[len(timed) // 2], ingest_peak=hist[-1][
            "peak"])

        small = np.random.default_rng(1).integers(
            0, model.vocab, (6, 257)).astype(np.int32)
        res = Trainer(me.ingest_loop, train_loop_config=dict(
            dtype="float32", batch_size=2), scaling_config=one_gpu,
            run_config=RunConfig(name="ingest32", storage_path=storage),
            datasets={"train": rd.from_numpy(small)}).fit()
        got = [m["loss"] for m in res.metrics_history]
        want = _driver_batch_losses(torch, "float32", small, 2)
        log(f"  fp32 ingest, 3 steps of 2 x 256 through the dataset: {got};"
            f" the same batches in this process: {want}")
        if res.error is not None or got != want:
            raise AssertionError(f"fp32 ingest {got} (error {res.error}) "
                                 f"!= this process's {want}")
    finally:
        batch_mod._EngineUDF = engine_cls
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while _runtime_processes() and time.monotonic() < deadline:
        time.sleep(0.5)
    left = _runtime_processes()
    if left:
        raise AssertionError(f"runtime processes outlived shutdown: {left}")
    return out


# ------- phase 22: sequence, expert and pipeline parallelism -------

# bench_tpu.py's bench_sp_ring: b, seq, heads, head_dim (bf16, causal)
SP_RING = (1, 32768, 8, 128)
SP_CHECK = (2, 4096, 8, 128)    # the attention checks at sp = 2
SP_EXACT_SEQ = 4096             # (a)'s check against the plain ring
SP_TRAIN_SEQ = 32768            # (c): 1 x 32768 tokens a step
SP_EXACT = (2, 512)             # (c) fp32: 2 x 512, 3 AdamW steps
EP_TOKENS = (2, 1024)           # (d) mixtral_8x7b at depth 2, 3 steps
SP_STEPS = (1, 2)               # (c) warm-up and timed steps a run
PP_MICRO = (8, 2, 1024)         # (e) bf16: 8 microbatches of 2 x 1024
PP_EXACT = (8, 16, 768)         # (e) fp32: 8 microbatches of 16 x 768
SP_WORLD = 2


def ring_attn_flops(b: int, s: int, h: int, d: int) -> float:
    """bench_tpu.py's count for causal attention forward and backward:
    forward 2 products, backward 7 (the recompute twice, dP, dS K, dP^T,
    dV, dK), causal halving the work: 9 x 2 b h s^2 d / 2."""
    return 9 * 2 * b * h * s * s * d / 2


def _grad_call(torch, fn, leaves):
    """fn(*leaves) and the gradients of the sum of its squared output (in
    fp32, as bench_sp_ring's loss), a fence after."""
    out = fn(*leaves)
    grads = torch.autograd.grad(out.float().pow(2).sum(), leaves)
    torch.cuda.synchronize()
    return out, grads


def _expect_counts(counts: dict, want: int, what: str) -> None:
    for key in ("fwd", "dq", "dkv"):
        if counts[key] != {"cuda": want, "plain": 0}:
            raise AssertionError(f"{what}: {key} launches {counts[key]}, "
                                 f"want {want} kernel launches, 0 plain")


def _steps(torch, step, state, batch, n: int):
    """n steps: (state, losses, host ms of each step, fenced)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, ms


EXACT_LR = 3e-4   # the fp32 steps' AdamW rate (the sharded-train phase's)


def _fp32_runs(torch, cfg, runs, batch, lr=EXACT_LR):
    """3 AdamW steps from the same seeded fp32 params for each (mesh,
    attn_impl) of `runs` (mesh None: the one-process unsharded step):
    [(losses, param leaves)], a sharded run's leaves its DTensors."""
    from ray_tpu_torch.models import init_params, loss_fn, param_logical_axes
    from ray_tpu_torch.train import adamw, make_train_step
    from ray_tpu_torch.train.optim import tree_leaves
    out = []
    for mesh, impl in runs:
        c = dataclasses.replace(cfg, attn_impl=impl)
        init_fn, step, _, _ = make_train_step(
            lambda p, b, c=c, mesh=mesh: loss_fn(p, b, c, mesh), adamw(lr),
            mesh, None if mesh is None else param_logical_axes(c),
            device="cuda")
        state = init_fn(init_params(c, torch.Generator().manual_seed(1),
                                    "cuda"))
        state, losses, _ = _steps(torch, step, state, batch, 3)
        out.append((losses, [x.detach() for x in tree_leaves(state.params)]))
        del state
    return out


def _block_of(full, dt):
    """This rank's block of a full tensor under DTensor `dt`'s placements,
    cut locally (gloo's all-gather into one tensor of CUDA tensors
    crashes, so `full_tensor()` is not used on the card)."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    for i, p in enumerate(dt.placements):
        if isinstance(p, Shard):
            full = full.chunk(mesh.size(i), p.dim)[mesh.get_local_rank(i)]
    return full


def _exact_vs(runs) -> list:
    """For each run after the first: (largest relative loss difference,
    largest difference of this rank's param blocks) against the first,
    the one-process run."""
    (l0, p0), rest = runs[0], runs[1:]
    out = []
    for ls, ps in rest:
        diffs = [(a.to_local() - _block_of(b, a)).abs() if hasattr(
            a, "to_local") else (a - b).abs() for a, b in zip(ps, p0)]
        worst = max(range(len(diffs)), key=lambda i: diffs[i].max().item())
        out.append((max(abs(a - b) / abs(b) for a, b in zip(ls, l0)),
                    diffs[worst].max().item(), worst,
                    sum(int((d > 2e-4).sum()) for d in diffs),
                    sum(d.numel() for d in diffs)))
    return out


def _pp_stage_fn(cfg, sin, cos):
    """The port's decoder layer over a stage's stacked layers."""
    from ray_tpu_torch.models.transformer import decoder_layer

    def stage_fn(p, x):
        n = next(iter(p.values())).shape[0]
        for li in range(n):
            x = decoder_layer(x, {k: v[li] for k, v in p.items()}, cfg, sin,
                              cos)
        return x
    return stage_fn


def _sp_attention(torch, res: dict, world: int) -> None:
    """(b): the kernel ring and Ulysses at sp = world against the dense
    reference on the full inputs in this process (outputs and gradients,
    K2-K4 launches), then bench_sp_ring's shape split over the ranks."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import (MeshConfig, make_mesh,
                                        ring_attention, ulysses_attention)
    from ray_tpu_torch.parallel.mesh import axis_rank
    from ray_tpu_torch.parallel.ring_attention import reference_attention
    mesh = make_mesh(MeshConfig(fsdp=1, sp=world))
    r = axis_rank(mesh, "sp")
    g = torch.Generator(device="cuda").manual_seed(22)
    B, S, H, D = SP_CHECK
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for causal in (True, False):
            full = [torch.randn(B, S, H, D, generator=g, device="cuda")
                    .to(dtype).requires_grad_(True) for _ in range(3)]
            ref, ref_g = _grad_call(torch, lambda q, k, v: (
                reference_attention(q, k, v, causal=causal)), full)
            want = [x.chunk(world, dim=1)[r] for x in (ref, *ref_g)]
            del ref, ref_g
            local = [x.detach().chunk(world, dim=1)[r].contiguous()
                     .requires_grad_(True) for x in full]
            for kind, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                reset_counts()
                o, grads = _grad_call(torch, lambda q, k, v: fn(
                    q, k, v, mesh, causal=causal), local)
                errs = []
                e = [scaled_err(a, b, errs)
                     for a, b in zip((o, *grads), want)]
                checks.append(dict(kind=kind, dtype=dn, causal=causal,
                                   err=max(e), abs_err=max(errs),
                                   counts=bwd_counts()))
            del full, local, want
    res["checks"] = checks
    torch.cuda.empty_cache()
    b, s, h, d = SP_RING
    local = [torch.randn(b, s // world, h, d, generator=g, device="cuda")
             .to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
    ring = lambda q, k, v: ring_attention(q, k, v, mesh)  # noqa: E731
    _grad_call(torch, ring, local)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        _grad_call(torch, ring, local)
    dist.barrier()
    res["ring_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    res["ring_peak"] = torch.cuda.max_memory_allocated()


def _sp_train(torch, res: dict, world: int) -> None:
    """(c): the llama-125m ring train step at sp = world on 1 x
    SP_TRAIN_SEQ tokens (SP_STEPS: 1 warm-up, 2 timed steps, K2-K4 launches,
    peak)."""
    import numpy as np
    import torch.distributed as dist
    from ray_tpu_torch.models import (configs, init_params, loss_fn,
                                      param_logical_axes)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import adamw, make_train_step
    mesh = make_mesh(MeshConfig(fsdp=1, sp=world))
    cfg = dataclasses.replace(configs.bench_125m(), attn_impl="ring")
    init_fn, step, _, _ = make_train_step(
        lambda p, bt: loss_fn(p, bt, cfg, mesh), adamw(3e-4), mesh,
        param_logical_axes(cfg), device="cuda")
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0),
                                "cuda"))
    batch = {"tokens": torch.tensor(
        np.random.default_rng(0).integers(0, cfg.vocab,
                                          (1, SP_TRAIN_SEQ + 1)),
        dtype=torch.int32, device="cuda")}
    state, first, _ = _steps(torch, step, state, batch, SP_STEPS[0])
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses, ms = _steps(torch, step, state, batch, SP_STEPS[1])
    res.update(train_losses=first + losses, train_ms=ms,
               train_counts=bwd_counts(),
               train_peak=torch.cuda.max_memory_allocated())


def _sp_exact(torch, res: dict, world: int) -> None:
    """(c) fp32: the ring and Ulysses llama-125m steps at sp = world
    against the one-process step, 3 AdamW steps on SP_EXACT tokens."""
    import numpy as np
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(fsdp=1, sp=world))
    cfg32 = dataclasses.replace(configs.bench_125m(), dtype="float32")
    bx, sx = SP_EXACT
    batch = {"tokens": torch.tensor(
        np.random.default_rng(1).integers(0, cfg32.vocab, (bx, sx + 1)),
        dtype=torch.int32, device="cuda")}
    runs = _fp32_runs(torch, cfg32, [(None, "auto"), (mesh, "ring"),
                                     (mesh, "ulysses")], batch)
    res["sp_exact"] = _exact_vs(runs)


def _ep_train(torch, res: dict, world: int) -> None:
    """(d): ep = world. mixtral_8x7b at depth 2 in bf16 (its experts
    split over the ranks), 3 steps of EP_TOKENS; then tiny_moe in fp32
    against the one-process step."""
    import numpy as np
    import torch.distributed as dist
    from ray_tpu_torch.models import (configs, init_params, loss_fn,
                                      param_logical_axes)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import adamw, make_train_step
    mesh = make_mesh(MeshConfig(fsdp=1, ep=world))
    moe = dataclasses.replace(configs.mixtral_8x7b(), n_layers=2)
    init_fn, step, _, _ = make_train_step(
        lambda p, bt: loss_fn(p, bt, moe, mesh), adamw(3e-4), mesh,
        param_logical_axes(moe), device="cuda")
    state = init_fn(init_params(
        moe, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    torch.cuda.empty_cache()
    bx, sx = EP_TOKENS
    batch = {"tokens": torch.tensor(
        np.random.default_rng(2).integers(0, moe.vocab, (bx, sx + 1)),
        dtype=torch.int32, device="cuda")}
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms = _steps(torch, step, state, batch, 3)
    res.update(ep_losses=losses, ep_ms=ms,
               ep_peak=torch.cuda.max_memory_allocated(),
               ep_experts=state.params["layers"]["wg"].to_local().shape[1])
    del state
    torch.cuda.empty_cache()
    tiny = configs.tiny_moe()
    batch = {"tokens": torch.tensor(
        np.random.default_rng(3).integers(0, tiny.vocab, (4, 33)),
        dtype=torch.int32, device="cuda")}
    res["ep_exact"] = _exact_vs(_fp32_runs(
        torch, tiny, [(None, "auto"), (mesh, "auto")], batch))


def _pp_run(torch, res: dict, world: int) -> None:
    """(e): GPipe at pp = world. fp32 tanh stages against the sequential
    stages; then llama-125m's layers as world stages over PP_MICRO
    microbatches, forward and backward timed."""
    import torch.distributed as dist
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops.layers import rope
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.mesh import axis_rank
    from ray_tpu_torch.parallel.pipeline import gpipe
    mesh = make_mesh(MeshConfig(fsdp=1, pp=world))
    stage = axis_rank(mesh, "pp")
    m, rows, f = PP_EXACT
    gp = torch.Generator(device="cuda").manual_seed(5)
    ws = torch.randn(world, f, f, generator=gp, device="cuda") / f ** 0.5
    mbs = torch.randn(m, rows, f, generator=gp, device="cuda")
    tanh_stage = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    w = ws[stage:stage + 1].clone().requires_grad_(True)
    piped = gpipe(tanh_stage, w, mbs, mesh)
    dw, = torch.autograd.grad(piped.pow(2).sum(), (w,))
    wf = ws.clone().requires_grad_(True)
    x = mbs
    for i in range(world):
        x = tanh_stage(wf[i], x)
    dwf, = torch.autograd.grad(x.pow(2).sum(), (wf,))
    res["pp_exact"] = ((piped - x).abs().max().item(),
                       (dw[0] - dwf[stage]).abs().max().item())
    cfg = configs.bench_125m()
    lay = init_params(cfg, torch.Generator().manual_seed(0), "cuda")["layers"]
    per = cfg.n_layers // world
    block = {k: v.reshape(world, per, *v.shape[1:])[stage:stage + 1]
             .clone().requires_grad_(True) for k, v in lay.items()}
    del lay
    m, bx, sx = PP_MICRO
    sin, cos = rope(torch.arange(sx, device="cuda"), cfg.head_dim,
                    cfg.rope_theta)
    mbs = torch.randn(m, bx, sx, cfg.d_model, generator=gp,
                      device="cuda").to(cfg.torch_dtype)
    stage_fn = _pp_stage_fn(cfg, sin, cos)
    leaves = list(block.values())

    def pipe():
        out = gpipe(stage_fn, block, mbs, mesh)
        torch.autograd.grad(out.float().pow(2).mean(), leaves)
        torch.cuda.synchronize()
    pipe()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        pipe()
    dist.barrier()
    res.update(pp_ms=(time.perf_counter() - t0) / 3 * 1e3,
               pp_peak=torch.cuda.max_memory_allocated(),
               pp_counts=bwd_counts())


SP_PARTS = (_sp_attention, _sp_train, _sp_exact, _ep_train, _pp_run)


def sp_worker(rank, world, port, out, parts=SP_PARTS):
    """One rank of phase 22 (b)-(e) (`parts`), two processes on the one
    card over gloo (every rank draws the same seeded inputs and calls
    alike). Rank 0 logs each part as it starts and its device memory."""
    import datetime
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()    # a crash in native code prints its stack
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=600))
        res = {"times": {}}
        for part in parts:
            t0 = time.perf_counter()
            if rank == 0:
                free, total = torch.cuda.mem_get_info()
                log(f"  rank 0: {part.__name__}, card memory free "
                    f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB")
            part(torch, res, world)
            torch.cuda.empty_cache()
            res["times"][part.__name__] = round(time.perf_counter() - t0, 1)
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 — the parent reports it and fails
        import traceback
        text = traceback.format_exc()
        print(f"rank {rank}: {text}", file=sys.stderr, flush=True)
        out.put((rank, "error", text))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(target, world: int, timeout: float, *args) -> dict:
    """target(rank, world, port, queue, *args) in `world` spawned
    processes: their results by rank; raises with their tracebacks, or
    their exit codes, on a failure."""
    import multiprocessing as mp
    import queue
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, port, out, *args))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, status, value = out.get(timeout=10)
            except queue.Empty:
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"{target.__name__}: no result in "
                                         f"{timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(
                        f"{target.__name__}: a rank died (exit codes "
                        f"{[p.exitcode for p in procs]})")
                continue
            (got.__setitem__(rank, value) if status == "ok"
             else errors.append(f"rank {rank}: {value}"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError(f"{target.__name__} failed:\n"
                             + "\n".join(errors))
    return got


def parallel_phase(torch, results, smi) -> dict:
    """Sequence, expert and pipeline parallelism: (a) the kernel ring on
    one process at bench_sp_ring's shape (a ring of one: one K2, K3 and
    K4 launch a call), held to the plain ring at 4096 tokens; the
    one-process baselines of (c) and (e); then (b)-(e) on two processes
    over gloo on the one card (`sp_worker`)."""
    import numpy as np
    import torch.distributed as dist
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.ops.layers import rope
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, ring_attention
    from ray_tpu_torch.train import adamw, make_train_step
    out = {}
    mesh = make_mesh(MeshConfig(fsdp=1))   # a process group of one
    g = torch.Generator(device="cuda").manual_seed(21)

    # (a) correctness at 4096 tokens: the kernel ring against the plain
    b, s, h, d = SP_RING
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        leaves = [torch.randn(b, SP_EXACT_SEQ, h, d, generator=g,
                              device="cuda").to(dtype).requires_grad_(True)
                  for _ in range(3)]
        got = _grad_call(torch, lambda q, k, v: ring_attention(
            q, k, v, mesh), leaves)
        want = _grad_call(torch, lambda q, k, v: ring_attention(
            q, k, v, mesh, impl="jnp"), leaves)
        errs = []
        e = max(scaled_err(x, y, errs) for x, y in zip(
            (got[0], *got[1]), (want[0], *want[1])))
        log(f"  (a) kernel ring vs plain ring, [{b},{SP_EXACT_SEQ},{h},{d}] "
            f"causal {dn}, out and dq/dk/dv: {e:.3e} of the reference's "
            f"scale (tol {TOL[dn]}), abs {max(errs):.3e}")
        if not e <= TOL[dn]:
            raise AssertionError(f"(a) the kernel ring disagrees: {e}")
        del leaves, got, want
    # (a) bench_sp_ring's shape: launches, time, peak
    leaves = [torch.randn(b, s, h, d, generator=g, device="cuda")
              .to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
    ring = lambda q, k, v: ring_attention(q, k, v, mesh)  # noqa: E731
    reset_counts()
    _grad_call(torch, ring, leaves)
    _expect_counts(bwd_counts(), 1, "(a) the ring of one")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        _grad_call(torch, ring, leaves)
    ring_ms = (time.perf_counter() - t0) / 5 * 1e3
    flops = ring_attn_flops(b, s, h, d)
    out.update(ring_ms=ring_ms, ring_peak=torch.cuda.max_memory_allocated())
    log(f"  (a) ring of one at [{b},{s},{h},{d}] bf16 causal, forward and "
        f"backward of sum(out**2): {ring_ms:.3f} ms/call, "
        f"{flops / ring_ms / 1e9:.1f} TFLOP/s by bench_sp_ring's count "
        f"({flops / 1e12:.2f} TFLOP), peak {out['ring_peak'] / 2**30:.3f} "
        f"GiB; launches K2/K3/K4 1 each, plain 0 [{smi}]")
    del leaves
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (c)'s one-process baseline: the same 32768 tokens, a ring of one
    cfg = dataclasses.replace(configs.bench_125m(), attn_impl="ring")
    init_fn, step, _, _ = make_train_step(
        lambda p, bt: loss_fn(p, bt, cfg), adamw(3e-4), device="cuda")
    state = init_fn(init_params(cfg, torch.Generator().manual_seed(0),
                                "cuda"))
    batch = {"tokens": torch.tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (1, SP_TRAIN_SEQ + 1)),
        dtype=torch.int32, device="cuda")}
    state, first, _ = _steps(torch, step, state, batch, SP_STEPS[0])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses, ms = _steps(torch, step, state, batch, SP_STEPS[1])
    _expect_counts(bwd_counts(), cfg.n_layers * SP_STEPS[1],
                   "(c) one process")
    out.update(one_ms=sorted(ms)[SP_STEPS[1] // 2],
               one_peak=torch.cuda.max_memory_allocated(),
               one_losses=first + losses)
    del state
    torch.cuda.empty_cache()

    # (e)'s one-process baseline: the 12 layers over the 8 microbatches
    from ray_tpu_torch.models.transformer import decoder_layer
    lay = {k: v.requires_grad_(True) for k, v in init_params(
        configs.bench_125m(), torch.Generator().manual_seed(0),
        "cuda")["layers"].items()}
    m, bx, sx = PP_MICRO
    sin, cos = rope(torch.arange(sx, device="cuda"), cfg.head_dim,
                    cfg.rope_theta)
    plain = configs.bench_125m()
    mbs = torch.randn(m, bx, sx, cfg.d_model, generator=g,
                      device="cuda").to(plain.torch_dtype)

    def seq_call():
        for i in range(m):
            x = mbs[i]
            for li in range(plain.n_layers):
                x = decoder_layer(x, {k: v[li] for k, v in lay.items()},
                                  plain, sin, cos)
            torch.autograd.grad(x.float().pow(2).mean(), list(lay.values()))
        torch.cuda.synchronize()
    seq_call()
    t0 = time.perf_counter()
    for _ in range(3):
        seq_call()
    out["pp_one_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del lay, mbs
    torch.cuda.empty_cache()

    # (b)-(e) on two processes over gloo on the one card
    t0 = time.perf_counter()
    got = _run_ranks(sp_worker, SP_WORLD, 900)
    log(f"  two ranks over gloo on the one card: {time.perf_counter() - t0:.1f}"
        f" s; rank 0's parts (s): {got[0]['times']} [{smi}]")
    for r in range(SP_WORLD):
        for c in got[r]["checks"]:
            want = ((r + 1 if c["causal"] else SP_WORLD)
                    if c["kind"] == "ring" else 0)
            ok = (c["err"] <= TOL[c["dtype"]]
                  and c["counts"]["fwd"] == {"cuda": want, "plain": 0}
                  and c["counts"]["dq"] == c["counts"]["dkv"]
                  == {"cuda": want, "plain": 0})
            log(f"  (b) rank {r} {c['kind']} [{','.join(map(str, SP_CHECK))}]"
                f" {'causal' if c['causal'] else 'full'} {c['dtype']}: out "
                f"and grads {c['err']:.3e} of the reference's scale (tol "
                f"{TOL[c['dtype']]}), abs {c['abs_err']:.3e}; launches K2 "
                f"{c['counts']['fwd']}, K3 {c['counts']['dq']}, K4 "
                f"{c['counts']['dkv']} (want {want} each) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"(b) rank {r}: {c}")
    split_ms = max(got[r]["ring_ms"] for r in range(SP_WORLD))
    log(f"  (b) [{b},{s},{h},{d}] bf16 causal over sp = 2: {split_ms:.3f} "
        f"ms/call against {ring_ms:.3f} on one process ((a)); both ranks "
        f"share the one card and every rotation goes through the host over "
        f"gloo, so this bounds no NVLink deployment [{smi}]")

    seq = SP_TRAIN_SEQ
    fpt = flops_per_token(cfg, seq)
    for r in range(SP_WORLD):
        g_r = got[r]
        _expect_counts(g_r["train_counts"],
                       SP_STEPS[1] * cfg.n_layers * (r + 1),
                       f"(c) rank {r} over {SP_STEPS[1]} steps")
        if not all(math.isfinite(x) for x in g_r["train_losses"]):
            raise AssertionError(f"(c) rank {r} losses {g_r['train_losses']}")
    step_ms = sorted(got[0]["train_ms"])[SP_STEPS[1] // 2]
    tps, one_tps = seq / step_ms * 1e3, seq / out["one_ms"] * 1e3
    log(f"  (c) llama-125m bf16 attn_impl='ring', 1 x {seq} tokens a step, "
        f"sp = 2: {step_ms:.1f} ms/step (upper median of {SP_STEPS[1]}; "
        f"{', '.join(f'{x:.1f}' for x in got[0]['train_ms'])}), "
        f"{tps:.1f} tokens/s, MFU {100 * fpt * tps / PEAK_FLOPS['bfloat16']:.2f}"
        f" % ({fpt / 1e9:.3f} GFLOP/token at {seq}); peaks "
        f"{got[0]['train_peak'] / 2**30:.3f} and "
        f"{got[1]['train_peak'] / 2**30:.3f} GiB; one process, a ring of "
        f"one: {out['one_ms']:.1f} ms/step, {one_tps:.1f} tokens/s, MFU "
        f"{100 * fpt * one_tps / PEAK_FLOPS['bfloat16']:.2f} %, peak "
        f"{out['one_peak'] / 2**30:.3f} GiB [{smi}]")
    log(f"  (c) launches a step: rank 0 {cfg.n_layers}, rank 1 "
        f"{2 * cfg.n_layers} of each of K2, K3, K4, plain 0; losses rank 0 "
        f"{[round(x, 4) for x in got[0]['train_losses']]}, one process "
        f"{[round(x, 4) for x in out['one_losses']]}")
    # AdamW moves an entry by about lr a step whatever its gradient's size,
    # so an entry whose gradient sits at fp32 rounding noise (the sp sum
    # adds the two halves of each row in another order) may move the
    # other way: allow one entry in 10^7 past 2e-4, none past the most
    # two trajectories can part in 3 steps (2 x 3 x lr).
    bad = []
    for r in range(SP_WORLD):
        for name, (dl, dp, leaf, n_far, n) in zip(("ring", "ulysses"),
                                                  got[r]["sp_exact"]):
            log(f"  (c) rank {r} fp32 {SP_EXACT[0]} x {SP_EXACT[1]}, 3 AdamW "
                f"steps, {name} at sp = 2 vs the one-process step: losses "
                f"{dl:.3e} (relative, tol 1e-5), params {dp:.3e} (tol 2e-4, "
                f"or at most one entry in 10^7 past it and none past "
                f"{6 * EXACT_LR:.1e}; {n_far} of {n} entries past 2e-4, the "
                f"largest in leaf {leaf})")
            params_ok = dp <= 2e-4 or (n_far <= n * 1e-7
                                       and dp <= 6 * EXACT_LR)
            if not (dl <= 1e-5 and params_ok):
                bad.append((r, name))
    if bad:
        raise AssertionError(f"(c) fp32 steps disagree: {bad}")

    for r in range(SP_WORLD):
        g_r = got[r]
        ls = g_r["ep_losses"]
        log(f"  (d) rank {r} mixtral_8x7b(n_layers=2) bf16 ep = 2 "
            f"({g_r['ep_experts']} of 8 experts a rank), {EP_TOKENS[0]} x "
            f"{EP_TOKENS[1]} tokens: ms/step {[round(x, 1) for x in g_r['ep_ms']]}"
            f", losses {[round(x, 4) for x in ls]}, peak "
            f"{g_r['ep_peak'] / 2**30:.3f} GiB [{smi}]")
        if (not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]
                or g_r["ep_experts"] != 4):
            raise AssertionError(f"(d) rank {r}: losses {ls}")
        (dl, dp, _, _, _), = g_r["ep_exact"]
        log(f"  (d) rank {r} tiny_moe fp32 ep = 2 vs the one-process step: "
            f"losses {dl:.3e} (relative, tol 1e-5), its param blocks "
            f"{dp:.3e} (tol 2e-4)")
        if not (dl <= 1e-5 and dp <= 2e-4):
            raise AssertionError(f"(d) rank {r}: tiny_moe fp32 disagrees")

    m = PP_MICRO[0]
    for r in range(SP_WORLD):
        g_r = got[r]
        e_out, e_grad = g_r["pp_exact"]
        log(f"  (e) rank {r} gpipe fp32 tanh stages F = {PP_EXACT[2]}, "
            f"{PP_EXACT[0]} microbatches: out {e_out:.3e} (tol 1e-5), its "
            f"stage's grad {e_grad:.3e} (tol 1e-4)")
        if not (e_out <= 1e-5 and e_grad <= 1e-4):
            raise AssertionError(f"(e) rank {r}: gpipe disagrees")
        ticks = m + SP_WORLD - 1
        _expect_counts(g_r["pp_counts"], 3 * ticks * cfg.n_layers // SP_WORLD,
                       f"(e) rank {r} over 3 calls")
    log(f"  (e) gpipe bf16, llama-125m's 12 layers as 2 stages of 6, {m} "
        f"microbatches of {PP_MICRO[1]} x {PP_MICRO[2]}, forward and "
        f"backward: {got[0]['pp_ms']:.1f} ms/call (bubble (S-1)/(M+S-1) = "
        f"1/{m + 1}; every stage also runs its idle ticks on zeros, as the "
        f"JAX schedule does), peaks {got[0]['pp_peak'] / 2**30:.3f} and "
        f"{got[1]['pp_peak'] / 2**30:.3f} GiB; the 12 layers over the same "
        f"microbatches on one process {out['pp_one_ms']:.1f} ms [{smi}]")
    for kernel, key in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                        ("flash_bwd_dkv", "dkv")):
        results[kernel]["sp_launches"] = [
            got[r]["train_counts"][key]["cuda"] for r in range(SP_WORLD)]
    out.update(step_ms=step_ms, tokens_per_s=tps, split_ms=split_ms)
    return out


# ---- phase 23: compiled graphs, channels, collectives, torch ingest ----

DAG_STAGES = (range(0, 6), range(6, 12))   # llama-125m's layers per stage
DAG_BUFFER = 48 << 20      # each channel: the 25.2 MB hidden states fit
DAG_EXECUTES = 10          # pipelined executes timed (after one warm-up)
ALLREDUCE_NUMEL = 16 << 20  # 64 MB of fp32


def _sha(torch, tensors) -> str:
    """sha256 of tensors' bytes, in order (on the host)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _param_leaves(params: dict) -> list:
    """A params tree's tensors in a fixed order (sorted names)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += _param_leaves(v) if isinstance(v, dict) else [v]
    return out


def _hop_value(torch, dev):
    """(a)'s pytree: llama-125m's bf16 hidden states at the train shape and
    an int64 tensor, from seed 3 on `dev`."""
    g = torch.Generator().manual_seed(3)
    h = torch.randn(TRAIN_BATCH, TRAIN_SEQ, 768, generator=g).to(
        torch.bfloat16)
    return {"h": h.to(dev), "ids": torch.arange(TRAIN_BATCH * TRAIN_SEQ,
                                                dtype=torch.int64).to(dev),
            "step": 7}


class StageWorker:
    """A stage actor of phase 23 holding llama-125m (`configs.bench_125m`,
    random weights from seed 0) on its card: `part` "a" runs
    embed_tokens and layers 0-5 and returns the bf16 hidden states, "b"
    layers 6-11, the final norm and the fp32 head and returns the last
    position's logits and each position's argmax (the ops of the port's
    `forward`, in its order). It also writes and reads (a)'s tensor hop
    and takes part in (c)'s collective group. A stage that sees no card
    raises."""

    def __init__(self, part: str):
        import torch
        from ray_tpu_torch.models import configs, init_params
        if not torch.cuda.is_available():
            raise RuntimeError(f"stage {part} sees no card (pid "
                               f"{os.getpid()})")
        self.part = part
        self.cfg = configs.bench_125m()
        self.params = init_params(self.cfg, torch.Generator().manual_seed(0),
                                  "cuda")
        self.rank = None

    def forward_part(self, x):
        import torch
        from ray_tpu_torch.models.transformer import (decoder_layer,
                                                      embed_tokens,
                                                      layer_params, lm_head)
        from ray_tpu_torch.ops.layers import rmsnorm, rope
        c, p = self.cfg, self.params
        with torch.no_grad():
            if self.part == "a":
                x = embed_tokens(p["embed"], x, c)
            sin, cos = rope(torch.arange(x.shape[1], device=x.device),
                            c.head_dim, c.rope_theta)
            for li in DAG_STAGES[self.part == "b"]:
                x = decoder_layer(x, layer_params(p, li), c, sin, cos)
            if self.part == "a":
                return x
            x = rmsnorm(x, p["final_norm"], c.norm_eps)
            logits = torch.matmul(x.float(), lm_head(p, c).float())
            return {"last": logits[:, -1].contiguous(),
                    "argmax": logits.argmax(-1)}

    def full_forward(self, tokens):
        """This actor's params through the port's `forward`: the last
        position's logits and each position's argmax, on the host."""
        import torch
        from ray_tpu_torch.models import forward
        with torch.no_grad():
            logits = forward(self.params, tokens.to("cuda"), self.cfg)
        return {"last": logits[:, -1].cpu(), "argmax": logits.argmax(-1).cpu()}

    def counts(self, reset: bool = False) -> dict:
        from ray_tpu_torch.ops import attention
        out = dict(attention.launches)
        if reset:
            reset_counts()
        return out

    def hop_write(self, path: str, n: int) -> list:
        """Write (a)'s value n times into the tensor channel at `path`,
        each 0.2 s after the last so that the reader is idle (no
        backpressure wait is timed): the host clock at each write's
        start and its ms (the device-to-host staging)."""
        import torch
        from ray_tpu_torch.experimental.channel import TensorChannel
        value = _hop_value(torch, "cuda")
        torch.cuda.synchronize()
        w = TensorChannel(path)
        out = []
        try:
            for _ in range(n):
                time.sleep(0.2)
                t0 = time.time()
                w.write(value, timeout=120)
                out.append((t0, (time.time() - t0) * 1e3))
        finally:
            w.close()
        return out

    def hop_read(self, path: str, n: int) -> dict:
        """Read n values from the tensor channel at `path` onto this card:
        the host clock at each read's end and the sha256 of what arrived
        (the bf16 leaf, then the int64 one) with its devices."""
        import torch
        from ray_tpu_torch.experimental.channel import TensorChannel
        r = TensorChannel(path)
        ends, shas = [], set()
        try:
            for _ in range(n):
                v = r.read(timeout=120)
                ends.append(time.time())
                shas.add((_sha(torch, [v["h"], v["ids"]]), str(v["h"].device),
                          str(v["ids"].device), str(v["h"].dtype), v["step"]))
        finally:
            r.close()
        return {"ends": ends, "got": sorted(shas)}

    def coll_init(self, rank: int):
        from ray_tpu_torch.util import collective as col
        col.init_collective_group(2, rank, group_name="stages")
        self.rank = rank

    def coll_allreduce(self) -> dict:
        """An in-place allreduce of a 64 MB fp32 CUDA tensor (seed
        100 + rank)."""
        import torch
        from ray_tpu_torch.util import collective as col
        t = torch.randn(ALLREDUCE_NUMEL, generator=torch.Generator()
                        .manual_seed(100 + self.rank)).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = col.allreduce(t, group_name="stages")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return {"ms": ms, "sha": _sha(torch, [t]), "inplace": out is t,
                "device": str(t.device)}

    def coll_broadcast(self) -> dict:
        """Every bf16 parameter from rank 0 into rank 1's zeroed CUDA
        tensors, in place."""
        import torch
        from ray_tpu_torch.util import collective as col
        leaves = _param_leaves(self.params)
        if self.rank == 1:
            for t in leaves:
                t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in leaves:
            if col.broadcast(t, src_rank=0, group_name="stages") is not t:
                raise AssertionError("broadcast did not write in place")
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "sha": _sha(torch, leaves),
                "bytes": sum(t.numel() * t.element_size() for t in leaves)}

    def coll_barrier(self) -> float:
        from ray_tpu_torch.util import collective as col
        t0 = time.perf_counter()
        col.barrier(group_name="stages")
        return (time.perf_counter() - t0) * 1e3


class TokenRows:
    """A torch map-style dataset over numpy token rows: item i is row i as
    a tensor (phase 23 (d)'s `from_torch` source)."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        import torch
        return torch.from_numpy(self.rows[i].copy())


def dag_phase(torch, results, smi) -> dict:
    """Compiled graphs, channels, collectives and torch ingest on the card
    (phase 23), through the port's runtime with two `StageWorker` actors
    at 0.5 GPU each. (a) one CUDA tensor hop between them through a
    `TensorChannel`: a pytree of llama-125m's bf16 hidden states at the
    train shape (16 x 1024 x 768, 25.2 MB) and an int64 tensor, the bytes
    read back equal to the bytes written, ms and GB/s a hop. (b) the
    compiled two-stage llama-125m forward (stage a: embed_tokens and
    layers 0-5; stage b: layers 6-11, the final norm and the fp32 head),
    the bf16 hidden states over a tensor channel of 48 MB: the last
    position's logits [16, 32000] and each position's argmax [16, 1024]
    equal this process's `forward` bit for bit on every execute, K2 6
    launches per stage per execute and no plain run; ms per execute over
    10 pipelined executes, logged beside the same stages through plain
    `.remote()` chains and the in-process forward. (c) the collective
    library between the stages: an in-place allreduce of a 64 MB fp32
    CUDA tensor equal to the sum this process computes, llama-125m's bf16
    parameters broadcast from rank 0 into rank 1's zeroed CUDA tensors
    bit-equal (rank 1's forward then equal to rank 0's), a barrier; GB/s
    each. (d) phase 21's fp32 ingest (3 steps of 2 x 256) fed from
    `from_torch` of a torch map-style dataset over the same rows, its
    losses equal to this process's; the same rows through
    `write_tfrecord` and `read_tfrecord`, equal row for row. No runtime
    process outlives the phase."""
    import importlib
    import tempfile

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.experimental.channel import TensorChannel
    from ray_tpu_torch.models import configs, forward, init_params
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.train import RunConfig, ScalingConfig, Trainer
    me = importlib.import_module("chip_smoke")
    out: dict = {}
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    storage = tempfile.mkdtemp(prefix="dag-", dir=os.path.join(ROOT, "tmp"))
    torch.cuda.empty_cache()
    cfg = configs.bench_125m()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    reset_counts()
    with torch.no_grad():
        logits = forward(params, tokens, cfg)
        want = {"last": logits[:, -1].contiguous(),
                "argmax": logits.argmax(-1)}
        del logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DAG_EXECUTES):
            logits = forward(params, tokens, cfg)
            del logits
        torch.cuda.synchronize()
    inproc_ms = (time.perf_counter() - t0) * 1e3 / DAG_EXECUTES
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, object_store_memory=1 << 30)
    try:
        t0 = time.perf_counter()
        stage = rt.remote(me.StageWorker).options(num_gpus=0.5)
        a, b = stage.remote("a"), stage.remote("b")
        rt.get([a.counts.remote(True), b.counts.remote(True)], timeout=180)
        boot_s = time.perf_counter() - t0

        # (a) one CUDA tensor hop between the two processes
        n_hops = 5
        chan = TensorChannel(create=True, capacity=DAG_BUFFER)
        try:
            rref = b.hop_read.remote(chan.path, n_hops)
            writes = rt.get(a.hop_write.remote(chan.path, n_hops),
                            timeout=180)
            reads = rt.get(rref, timeout=180)
        finally:
            chan.close()
            chan.unlink()
        value = _hop_value(torch, "cuda")
        nbytes = sum(v.numel() * v.element_size() for v in (
            value["h"], value["ids"]))
        want_got = [(_sha(torch, [value["h"], value["ids"]]), "cuda:0",
                     "cuda:0", "torch.bfloat16", 7)]
        if reads["got"] != want_got:
            raise AssertionError(f"(a) the hop read {reads['got']}, wrote "
                                 f"{want_got}")
        hop_ms = [(e - w0) * 1e3 for (w0, _), e in zip(writes,
                                                         reads["ends"])]
        best = min(hop_ms[1:])
        log(f"  (a) tensor hop, {nbytes} B (bf16 16 x 1024 x 768 + int64) "
            f"CUDA -> channel -> CUDA between two processes, the reader "
            f"idle: write start to read end " +
            ", ".join(f"{x:.2f}" for x in hop_ms) + " ms, of which the "
            "write (device-to-host staging) " +
            ", ".join(f"{m:.2f}" for _, m in writes) + f" ms; best after "
            f"the first {best:.2f} ms, {nbytes / best / 1e6:.2f} GB/s; "
            f"bytes equal [{smi}]")
        out.update(hop_ms=best, hop_gbps=nbytes / best / 1e6)

        # (b) the compiled two-stage forward
        with InputNode() as inp:
            dag = b.forward_part.bind(a.forward_part.bind(inp))
        compiled = dag.experimental_compile(buffer_size_bytes=DAG_BUFFER,
                                            channel_type="tensor")
        try:
            first = compiled.execute(tokens).get(timeout=180)
            t0 = time.perf_counter()
            refs = [compiled.execute(tokens) for _ in range(DAG_EXECUTES)]
            got = [r.get(timeout=180) for r in refs]
            dag_ms = (time.perf_counter() - t0) * 1e3 / DAG_EXECUTES
        finally:
            compiled.teardown()
        for i, g in enumerate([first] + got):
            for k in ("last", "argmax"):
                if (g[k].device.type != "cuda" or g[k].dtype != want[k].dtype
                        or not torch.equal(g[k], want[k])):
                    raise AssertionError(
                        f"(b) execute {i}: {k} {g[k].dtype} on "
                        f"{g[k].device} != this process's forward")
        del first, got, refs
        counts = rt.get([a.counts.remote(True), b.counts.remote(True)],
                        timeout=60)
        n_exec = DAG_EXECUTES + 1
        for name, c in zip("ab", counts):
            if c != {"cuda": len(DAG_STAGES[0]) * n_exec, "plain": 0}:
                raise AssertionError(
                    f"(b) stage {name} ran flash_fwd {c}, want "
                    f"{len(DAG_STAGES[0])} x {n_exec} kernel launches, 0 "
                    f"plain")
        results["flash_fwd"]["dag_launches"] = [c["cuda"] for c in counts]
        t0 = time.perf_counter()
        plain = [b.forward_part.remote(a.forward_part.remote(tokens))
                 for _ in range(DAG_EXECUTES)]
        plain = rt.get(plain, timeout=300)
        plain_ms = (time.perf_counter() - t0) * 1e3 / DAG_EXECUTES
        same = all(torch.equal(p["last"].to("cuda"), want["last"])
                   for p in plain)
        del plain
        rt.get([a.counts.remote(True), b.counts.remote(True)], timeout=60)
        log(f"  (b) compiled two-stage llama-125m forward, 16 x 1024 tokens: "
            f"{dag_ms:.2f} ms per execute over {DAG_EXECUTES} pipelined "
            f"executes (the same stages through plain .remote() chains "
            f"{plain_ms:.2f} ms, their logits "
            f"{'equal' if same else 'NOT equal'} too; this process's "
            f"forward {inproc_ms:.2f} ms); logits and "
            f"argmax bit-equal on all {n_exec} executes; flash_fwd launches "
            f"per stage {[c['cuda'] for c in counts]} (6 x {n_exec}), plain "
            f"0; actors up in {boot_s:.2f} s [{smi}]")
        out.update(dag_ms=dag_ms, plain_ms=plain_ms, inproc_ms=inproc_ms)

        # (c) the collective library between the two stage actors
        rt.get([a.coll_init.remote(0), b.coll_init.remote(1)], timeout=60)
        ar = rt.get([a.coll_allreduce.remote(), b.coll_allreduce.remote()],
                    timeout=300)
        summed = (torch.randn(ALLREDUCE_NUMEL, generator=torch.Generator()
                              .manual_seed(100))
                  + torch.randn(ALLREDUCE_NUMEL, generator=torch.Generator()
                                .manual_seed(101)))
        want_sha = _sha(torch, [summed])
        if [(x["sha"], x["inplace"], x["device"]) for x in ar] != [
                (want_sha, True, "cuda:0")] * 2:
            raise AssertionError(f"(c) allreduce {ar} != this process's sum")
        bc = rt.get([a.coll_broadcast.remote(), b.coll_broadcast.remote()],
                    timeout=600)
        want_sha = _sha(torch, _param_leaves(params))
        if [x["sha"] for x in bc] != [want_sha] * 2:
            raise AssertionError("(c) broadcast: rank 1's params are not "
                                 "rank 0's")
        small = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256)))
        fa, fb = rt.get([a.full_forward.remote(small),
                         b.full_forward.remote(small)], timeout=120)
        if not (torch.equal(fa["last"], fb["last"])
                and torch.equal(fa["argmax"], fb["argmax"])):
            raise AssertionError("(c) rank 1's forward after the broadcast "
                                 "!= rank 0's")
        bar = rt.get([a.coll_barrier.remote(), b.coll_barrier.remote()],
                     timeout=60)
        ar_b = ALLREDUCE_NUMEL * 4
        log(f"  (c) collectives over the runtime's KV between the stages: "
            f"allreduce of {ar_b} B fp32 in place "
            f"{max(x['ms'] for x in ar):.1f} ms "
            f"({ar_b / max(x['ms'] for x in ar) / 1e6:.3f} GB/s a rank), == "
            f"this process's sum; broadcast of {bc[0]['bytes']} B bf16 "
            f"params {max(x['ms'] for x in bc):.1f} ms "
            f"({bc[0]['bytes'] / max(x['ms'] for x in bc) / 1e6:.3f} GB/s), "
            f"bit-equal, rank 1's forward == rank 0's; barrier "
            f"{max(bar):.2f} ms [{smi}]")
        out.update(allreduce_ms=max(x["ms"] for x in ar),
                   broadcast_ms=max(x["ms"] for x in bc))
        for h in (a, b):
            rt.kill(h)
        del a, b

        # (d) from_torch ingest and TFRecord on the card's machine
        small = np.random.default_rng(1).integers(
            0, cfg.vocab, (6, 257)).astype(np.int32)
        one_gpu = ScalingConfig(num_workers=1, use_gpu=True)
        res = Trainer(me.ingest_loop, train_loop_config=dict(
            dtype="float32", batch_size=2, column="item"),
            scaling_config=one_gpu,
            run_config=RunConfig(name="from_torch", storage_path=storage),
            datasets={"train": rd.from_torch(me.TokenRows(small))}).fit()
        got = [m["loss"] for m in res.metrics_history]
        want_l = _driver_batch_losses(torch, "float32", small, 2)
        if res.error is not None or got != want_l:
            raise AssertionError(f"(d) from_torch ingest {got} (error "
                                 f"{res.error}) != this process's {want_l}")
        tfr = os.path.join(storage, "tfr")
        rd.from_torch(me.TokenRows(small)).write_tfrecord(tfr)
        back = rd.read_tfrecord(tfr).take_all()
        if len(back) != len(small) or not all(
                np.array_equal(r["item"], row) for r, row in zip(back, small)):
            raise AssertionError("(d) the rows through write_tfrecord and "
                                 "read_tfrecord differ")
        log(f"  (d) fp32 ingest from from_torch, 3 steps of 2 x 256: {got} =="
            f" this process's; the rows through write_tfrecord ("
            f"{len(os.listdir(tfr))} shards) and read_tfrecord equal row "
            f"for row")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        del params
        torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while _runtime_processes() and time.monotonic() < deadline:
        time.sleep(0.5)
    left = _runtime_processes()
    if left:
        raise AssertionError(f"runtime processes outlived shutdown: {left}")
    return out


# ---- phase 24, rl: RLlib's on-policy half ----

RL_BUDGET_S = 120          # the phase's budget, split over its parts:
RL_PART_S = {"a": 10, "b": 5, "c": 5, "d": 44, "e": 4, "f": 52}
RL_SYNCS_ALLOWED = 1       # an on-card iteration: its one metrics read


class _TimeLimit:
    """Raise TimeoutError in the main thread when a part runs past its
    limit (SIGALRM), so a stuck part fails the phase instead of the
    call."""

    def __init__(self, seconds: int, what: str):
        self.seconds, self.what = seconds, what

    def _fire(self, *_):
        raise TimeoutError(f"rl ({self.what}) ran past its {self.seconds} s")

    def __enter__(self):
        import signal
        self._prev = signal.signal(signal.SIGALRM, self._fire)
        signal.alarm(self.seconds)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import signal
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._prev)
        self.s = time.perf_counter() - self.t0
        return False


def _rl_timed(algo, iters: int) -> tuple:
    """One warm iteration, then `iters` timed: (env-steps/s, ms an
    iteration, the last result, every result)."""
    results = [algo.train()]
    steps0 = algo._timesteps
    t0 = time.perf_counter()
    for _ in range(iters):
        results.append(algo.train())
    dt = time.perf_counter() - t0
    return ((algo._timesteps - steps0) / dt, dt / iters * 1e3, results[-1],
            results)


def _finite_losses(results, what: str) -> None:
    for r in results:
        for k in ("total_loss", "policy_loss", "vf_loss"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{what}: non-finite {k} {r[k]}")


def _rl_syncs(torch, fn) -> list:
    """The synchronizing calls fn() makes (CUDA sync debug mode 'warn')."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def _rl_fixed_batch(obs_dim: int, n: int, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"obs": rng.random((n, obs_dim), dtype=f32),
            "actions": rng.integers(0, 4, n).astype(np.int64),
            "logp": (-np.abs(rng.standard_normal(n)) - 0.5).astype(f32),
            "advantages": rng.standard_normal(n).astype(f32),
            "returns": rng.standard_normal(n).astype(f32),
            "vs": rng.standard_normal(n).astype(f32),
            "pg_advantages": rng.standard_normal(n).astype(f32)}


def _rl_card_vs_cpu(torch, lr: float) -> dict:
    """(e) one PPO and one IMPALA update of the nature CNN on a fixed batch
    on the card and on the CPU, the global TF32 switches on (cuDNN's
    default) so that only the RL path's own scoping holds fp32."""
    import functools

    import numpy as np
    from ray_tpu_torch.rllib.algorithms.impala import impala_loss
    from ray_tpu_torch.rllib.algorithms.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import Learner
    from ray_tpu_torch.rllib.core.rl_module import (NATURE_FILTERS,
                                                    CNNActorCriticModule,
                                                    tree_leaves)
    module = CNNActorCriticModule((84, 84, 4), 4, filters=NATURE_FILTERS,
                                  dense=512)
    batch = _rl_fixed_batch(84 * 84 * 4, 256, 0)
    out = {}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name, fn, cfg in (
                ("ppo", ppo_loss, dict(clip=0.2, vf_coef=0.5,
                                       ent_coef=0.01)),
                ("impala", impala_loss, dict(vf_coef=0.5, ent_coef=0.01))):
            runs = {}
            for dev in ("cuda", "cpu"):
                learner = Learner(module, functools.partial(fn, module=module),
                                  lr=lr, grad_clip=0.5, seed=0,
                                  loss_cfg=cfg, device=dev)
                m = learner.update(batch)
                runs[dev] = (m, [p.detach().cpu().numpy()
                                 for p in tree_leaves(learner.params)])
            (mc, pc), (mh, ph) = runs["cuda"], runs["cpu"]
            loss_err = max(abs(mc[k] - mh[k]) for k in mc)
            diffs = np.concatenate([np.abs(a - b).ravel()
                                    for a, b in zip(pc, ph)])
            out[name] = dict(loss_err=loss_err, param_err=float(diffs.max()),
                             past=int((diffs > 2e-4).sum()), n=diffs.size)
            if loss_err > 1e-5 or float(diffs.max()) > 2 * lr:
                raise AssertionError(f"(e) {name}: card vs CPU losses "
                                     f"{loss_err:.3e} (bound 1e-5), params "
                                     f"{float(diffs.max()):.3e} (bound "
                                     f"{2 * lr:.1e})")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return out


def _actor_pid(handle) -> int:
    from ray_tpu_torch.core.runtime import get_runtime
    return get_runtime().actors[handle._actor_id].worker.proc.pid


def _rl_async(cfg_cls, name: str) -> dict:
    """(f) an async algorithm over two runner actors on the CPU and the
    learner on the card; runner 0 SIGKILLed after the first iteration."""
    import signal
    config = (cfg_cls().environment(env="MinAtarBreakout-v0")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                           rollout_fragment_length=32)
              .training(train_batch_size=512, lr=3e-4)
              .debugging(seed=0))
    algo = config.build_algo()
    try:
        t0 = time.perf_counter()
        results = [algo.train()]
        boot_s = time.perf_counter() - t0
        old = algo.env_runner_group.remotes[0]
        os.kill(_actor_pid(old), signal.SIGKILL)
        t0 = time.perf_counter()
        for _ in range(2):
            results.append(algo.train())
        after_s = time.perf_counter() - t0
        _finite_losses(results, f"(f) {name}")
        if algo.env_runner_group.remotes[0] is old:
            raise AssertionError(f"(f) {name}: the killed runner was not "
                                 f"replaced")
        if results[-1]["num_env_steps_sampled_lifetime"] < 3 * 512:
            raise AssertionError(f"(f) {name}: {results[-1]}")
        on_card = all(p.is_cuda for p in
                      _leaves(algo.learner_group.local.params))
        if not on_card:
            raise AssertionError(f"(f) {name}: the learner is not on CUDA")
        return dict(boot_s=boot_s, after_s=after_s,
                    steps=results[-1]["num_env_steps_sampled_lifetime"],
                    loss=results[-1]["total_loss"])
    finally:
        algo.stop()


def _leaves(params) -> list:
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves
    return tree_leaves(params)


def _rl_group(torch) -> dict:
    """(f) two learner actors at 0.5 GPU each against the local learner on
    the card, 3 updates on one batch: losses 1e-4, params 1e-4 / 1e-5."""
    import functools

    import numpy as np
    from ray_tpu_torch.rllib.algorithms.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import CNNActorCriticModule
    module = CNNActorCriticModule((10, 10, 4), 3)
    loss = functools.partial(ppo_loss, module=module)
    cfg = dict(lr=3e-4, seed=0, grad_clip=0.5,
               loss_cfg=dict(clip=0.2, vf_coef=0.5, ent_coef=0.01))
    batch = _rl_fixed_batch(400, 512, 1)
    batch["actions"] %= 3
    local = Learner(module, loss, device="cuda", **cfg)
    t0 = time.perf_counter()
    group = LearnerGroup(module, loss, num_learners=2, config=cfg,
                         device="cuda")
    boot_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        for _ in range(3):
            ml = local.update(batch)
            mg = group.update(batch)
        update_ms = (time.perf_counter() - t0) / 3 * 1e3
        loss_err = abs(ml["total_loss"] - mg["total_loss"])
        worst = 0.0
        for a, b in zip(_leaves(local.get_weights()),
                        _leaves(group.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            worst = max(worst, float(np.abs(a - b).max()))
        if loss_err > 1e-4 * max(1.0, abs(ml["total_loss"])):
            raise AssertionError(f"(f) group loss {mg['total_loss']} vs "
                                 f"local {ml['total_loss']}")
    finally:
        group.stop()
    return dict(boot_s=boot_s, update_ms=update_ms, loss_err=loss_err,
                param_err=worst)


def rl_phase(torch, smi) -> dict:
    """RLlib's on-policy half (`ray_tpu_torch.rllib`) on the card, within
    RL_BUDGET_S, each part under its own limit (RL_PART_S). (a) PPO on
    MinAtarBreakout-v0 at bench_rl_ppo's shape: one local runner of 16 envs
    acting on the CPU, fragments of 64, train_batch 1024, minibatch 256, 2
    epochs, lr 3e-4, the learner on the card; 1 warm and 3 timed
    iterations. (b) PPO on JaxAtariClassBreakout-v0 (the nature CNN over
    84x84x4 frames, 16 envs, T 64, the same batch) with the env on the
    card; the synchronizing calls of one iteration counted. (c) IMPALA on
    card at bench_rl_impala's shape (broadcast_interval 2), 6 timed
    iterations. (d) the on-card PPO iteration learns JaxMinAtarBreakout
    (test_fused_ppo_learns_on_device's setting, 120 iterations, the last
    window's return per episode > 0.4). (e) one PPO and one IMPALA update
    of the nature CNN on the card against the CPU (losses 1e-5; params
    2e-4, entries past it counted, none past 2 lr), TF32 switched on
    globally. (f) IMPALA and APPO over two runner actors with the learner
    on the card, a runner SIGKILLed and replaced; two learner actors at 0.5
    GPU against the local learner; no runtime process outlives it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig
    from ray_tpu_torch.rllib.core.learner import Learner, read_metrics
    from ray_tpu_torch.rllib.core.ondevice import (OnDeviceSamplerGroup,
                                                   build_ppo_train_iter)
    from ray_tpu_torch.rllib.core.rl_module import CNNActorCriticModule
    from ray_tpu_torch.rllib.env.device_env import (build_rollout,
                                                    make_device_env)
    out: dict = {}
    t_phase = time.perf_counter()

    def shape(env, **training):
        return (PPOConfig().environment(env=env)
                .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(train_batch_size=1024, minibatch_size=256,
                          num_epochs=2, lr=3e-4, **training)
                .debugging(seed=0))

    # (a) host runner, learner on the card
    with _TimeLimit(RL_PART_S["a"], "a") as tl:
        algo = shape("MinAtarBreakout-v0").build_algo()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sps, iter_ms, last, results = _rl_timed(algo, 3)
            peak = torch.cuda.max_memory_allocated()
            _finite_losses(results, "(a)")
            learner = algo.learner_group.local
            acting = algo.env_runner_group.local.acting_params
            if not all(p.is_cuda for p in _leaves(learner.params)):
                raise AssertionError("(a) learner params are not on CUDA")
            if not all(p.device.type == "cpu" for p in _leaves(acting)):
                raise AssertionError("(a) the acting copy is not on the CPU")
        finally:
            algo.stop()
    out["a"] = dict(sps=sps, iter_ms=iter_ms, sample_ms=last["sample_ms"],
                    learner_ms=last["learner_update_ms"], peak=peak,
                    s=tl.s)
    log(f"  (a) PPO MinAtarBreakout-v0, 16 envs on one local runner (CPU "
        f"acting), batch 1024, mb 256, 2 epochs: {sps:.1f} env-steps/s, "
        f"train_iter_ms {iter_ms:.1f}, sample_ms {last['sample_ms']}, "
        f"learner_update_ms {last['learner_update_ms']}, learner peak "
        f"{peak / 2**20:.1f} MiB; learner params on CUDA, acting copy on "
        f"the CPU, losses finite; {tl.s:.1f} s [{smi}]")

    # (b) PPO with the env on the card
    with _TimeLimit(RL_PART_S["b"], "b") as tl:
        algo = shape("JaxAtariClassBreakout-v0").build_algo()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sps, iter_ms, last, results = _rl_timed(algo, 3)
            peak = torch.cuda.max_memory_allocated()
            _finite_losses(results, "(b)")
            learner = algo.learner_group.local
            _vs, traj = build_rollout(algo._device_vec_env, algo.module, 2)(
                learner.params, algo._ondev_vs, algo._ondev_gen)
            if not all(v.is_cuda for v in traj.values()):
                raise AssertionError("(b) trajectory tensors off the card")
            state = {}

            def one_iter():
                vs, m = algo._ondev_iter(algo._ondev_vs, algo._ondev_gen)
                state["m"] = read_metrics(m)
            syncs = _rl_syncs(torch, one_iter)
            if len(syncs) > RL_SYNCS_ALLOWED:
                # where the first one is: the iteration alone (no metrics
                # read) under sync debug mode "error", its traceback
                import traceback
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    algo._ondev_iter(algo._ondev_vs, algo._ondev_gen)
                    where = "none without the read"
                except RuntimeError:
                    where = traceback.format_exc(limit=-6)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                raise AssertionError(f"(b) {len(syncs)} synchronizing calls "
                                     f"in one iteration; the first:\n{where}")
        finally:
            algo.stop()
    out["b"] = dict(sps=sps, iter_ms=iter_ms, peak=peak, syncs=len(syncs),
                    s=tl.s)
    log(f"  (b) PPO JaxAtariClassBreakout-v0 on the card (nature CNN, "
        f"84x84x4, 16 envs, T 64): {sps:.1f} env-steps/s, {iter_ms:.1f} ms "
        f"an iteration, peak {peak / 2**20:.1f} MiB; trajectory on CUDA; "
        f"{len(syncs)} synchronizing call(s) in one iteration"
        + (f" ({syncs[0][:90]})" if syncs else "") + f"; {tl.s:.1f} s")

    # (c) IMPALA on the card (Anakin)
    with _TimeLimit(RL_PART_S["c"], "c") as tl:
        config = (IMPALAConfig().environment(env="JaxAtariClassBreakout-v0")
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=16)
                  .training(train_batch_size=1024, minibatch_size=256,
                            lr=3e-4, broadcast_interval=2)
                  .debugging(seed=0))
        algo = config.build_algo()
        try:
            sps, iter_ms, last, results = _rl_timed(algo, 6)
            _finite_losses(results, "(c)")
        finally:
            algo.stop()
    out["c"] = dict(sps=sps, iter_ms=iter_ms, s=tl.s)
    log(f"  (c) IMPALA JaxAtariClassBreakout-v0 on the card, batch 1024, mb "
        f"256, broadcast_interval 2: {sps:.1f} env-steps/s, {iter_ms:.1f} ms "
        f"an iteration, V-trace policy loss {last['policy_loss']:.4f}; "
        f"{tl.s:.1f} s")

    # (d) it learns on the card
    with _TimeLimit(RL_PART_S["d"], "d") as tl:
        env = make_device_env("JaxMinAtarBreakout-v0", 16)
        mod = CNNActorCriticModule((10, 10, 4), 3)
        learner = Learner(mod, None, lr=1e-3, grad_clip=0.5, seed=0)
        ti = build_ppo_train_iter(env, mod, T=64, num_epochs=2,
                                  minibatch_size=256, gamma=0.99, lam=0.95,
                                  clip=0.2, vf_coef=0.5, ent_coef=0.01,
                                  learner=learner)
        vs = env.reset(torch.Generator(device="cuda").manual_seed(1))
        gen = torch.Generator(device="cuda").manual_seed(2)
        grp = OnDeviceSamplerGroup()
        for i in range(120):
            vs, m = ti(vs, gen)
            if i in (89, 119):
                m = read_metrics(m)
                grp.record(m["ep_ret_sum"], m["ep_len_sum"], m["ep_count"])
        window = grp._window[-1][0]
        if not window > 0.4:
            raise AssertionError(f"(d) the last window's return per episode "
                                 f"{window:.3f} <= 0.4: {grp._window}")
    out["d"] = dict(window=window, first=grp._window[0][0], s=tl.s)
    log(f"  (d) on-card PPO on JaxMinAtarBreakout-v0, 120 iterations: return "
        f"per episode {grp._window[0][0]:.3f} over iterations 1-90, "
        f"{window:.3f} over 91-120 (gate > 0.4; random play ~0.12); "
        f"{tl.s:.1f} s")

    # (e) fp32 on the card against the CPU
    with _TimeLimit(RL_PART_S["e"], "e") as tl:
        ex = _rl_card_vs_cpu(torch, 3e-4)
    out["e"] = ex
    log("  (e) nature CNN, one update on a fixed 256-row batch, card vs CPU "
        "with TF32 switched on globally: " + "; ".join(
            f"{k} losses {v['loss_err']:.2e} (1e-5), params "
            f"{v['param_err']:.2e} ({v['past']} of {v['n']} past 2e-4, "
            f"none past 6e-4)"
            for k, v in ex.items()) + f"; {tl.s:.1f} s")

    # (f) through the port's runtime
    with _TimeLimit(RL_PART_S["f"], "f") as tl:
        rt.init(num_cpus=8, object_store_memory=256 << 20)
        try:
            imp = _rl_async(IMPALAConfig, "IMPALA")
            app = _rl_async(APPOConfig, "APPO")
            grp_out = _rl_group(torch)
        finally:
            rt.shutdown()
        deadline = time.monotonic() + 15
        while _runtime_processes() and time.monotonic() < deadline:
            time.sleep(0.5)
        left = _runtime_processes()
        if left:
            raise AssertionError(f"(f) runtime processes outlived shutdown: "
                                 f"{left}")
    out["f"] = dict(impala=imp, appo=app, group=grp_out, s=tl.s)
    log(f"  (f) runtime: IMPALA over two runner actors, the learner on the "
        f"card: first iteration (runners booting) {imp['boot_s']:.2f} s, "
        f"runner 0 SIGKILLed, 2 more in {imp['after_s']:.2f} s with its "
        f"replacement; APPO {app['boot_s']:.2f} s, {app['after_s']:.2f} s; "
        f"two learner actors at 0.5 GPU up in {grp_out['boot_s']:.2f} s, "
        f"{grp_out['update_ms']:.1f} ms an update pair, == the local "
        f"learner (loss {grp_out['loss_err']:.2e}, params "
        f"{grp_out['param_err']:.2e}); no runtime process left; {tl.s:.1f} s")
    out["s"] = time.perf_counter() - t_phase
    if out["s"] > RL_BUDGET_S:
        raise AssertionError(f"rl phase took {out['s']:.1f} s, past its "
                             f"{RL_BUDGET_S} s budget")
    return out


# ---- phase 25, rl-offpolicy: RLlib's off-policy, offline, multi-agent
# and model-based half ----

RL2_BUDGET_S = 150         # the phase's budget; each part's own limit
# guards against a stuck part with room for the slowest hosts seen (the
# same code ran 1.3-1.5x slower on some), so the limits sum past the
# budget, which the phase's total is held to
RL2_PART_S = {"a": 10, "b": 65, "c": 10, "d": 35, "e": 60}
PENDULUM_TWIN = "PendulumTwin-v1"


class PendulumTwin:
    """A numpy copy of gymnasium's Pendulum-v1 (g 10, m 1, l 1, max speed
    8, max torque 2, dt 0.05, reward -(theta^2 + 0.1 thetadot^2 + 0.001
    u^2) with theta wrapped to [-pi, pi), truncated after 200 steps), for
    the card's machine, which has no gymnasium. Test equipment for phase
    25, registered as PENDULUM_TWIN in the port's env registry; `reset`
    seeds numpy's PCG64 as gymnasium's `np_random` does."""

    MAX_SPEED, MAX_TORQUE, DT, G, M, L = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0

    def __init__(self, max_episode_steps: int = 200):
        import numpy as np
        from ray_tpu_torch.rllib.env.base import Box
        high = np.array([1.0, 1.0, self.MAX_SPEED], dtype=np.float32)
        self.observation_space = Box(-high, high, (3,), np.float32)
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,),
                                np.float32)
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self.state = None
        self._t = 0

    def reset(self, *, seed=None, options=None):
        import numpy as np
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        import numpy as np
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def step(self, u):
        import numpy as np
        th, thdot = self.state
        g, m, l, dt = self.G, self.M, self.L, self.DT
        u = np.clip(u, -self.MAX_TORQUE, self.MAX_TORQUE)[0]
        costs = ((((th + np.pi) % (2 * np.pi)) - np.pi) ** 2
                 + 0.1 * thdot ** 2 + 0.001 * (u ** 2))
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._t += 1
        return (self._obs(), -costs, False, self._t >= self.max_episode_steps,
                {})

    def close(self):
        pass


class TargetMatchEnv:
    """A copy of the JAX package's cooperative test env
    (tests/test_rllib.py `_TargetMatchEnv`) on the port's spaces: each of
    two agents sees a one-hot target and is rewarded 1 for choosing the
    matching action; episodes of 8 steps. Module-level, so runner actors
    unpickle it by name."""

    possible_agents = ["a0", "a1"]

    def __init__(self, n: int = 4, seed: int = 0):
        import numpy as np
        from ray_tpu_torch.rllib.env.base import Box, Discrete
        self.n = n
        self._rng = np.random.default_rng(seed)
        box = Box(low=0.0, high=1.0, shape=(n,), dtype=np.float32)
        self.observation_spaces = {a: box for a in self.possible_agents}
        self.action_spaces = {a: Discrete(n) for a in self.possible_agents}
        self._t = 0

    def _obs(self):
        import numpy as np
        out = {}
        self._targets = {}
        for a in self.possible_agents:
            tgt = int(self._rng.integers(self.n))
            self._targets[a] = tgt
            v = np.zeros(self.n, np.float32)
            v[tgt] = 1.0
            out[a] = v
        return out

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        rew = {a: float(action_dict[a] == self._targets[a])
               for a in self.possible_agents}
        self._t += 1
        done = self._t >= 8
        obs = self._obs()
        terms = {a: done for a in self.possible_agents}
        terms["__all__"] = done
        truncs = {a: False for a in self.possible_agents}
        truncs["__all__"] = False
        return obs, rew, terms, truncs, {}

    def close(self):
        pass


def _rl2_max_err(a_list, b_list) -> float:
    return max(float(abs(a - b).max()) for a, b in zip(a_list, b_list))


def _dqn_card_vs_cpu(torch, algo) -> dict:
    """(a) one DQN update (double Q, the target tree in the batch) from
    the same weights and batch on the card and on the CPU, TF32 switched
    on globally so that only the learner's own fp32 scoping holds it:
    the loss (1e-5 relative), each gradient leaf (1e-5 of its largest
    entry) and the params after the Adam step (2 lr: Adam's first step
    moves an entry by about lr whatever its gradient's size)."""
    from ray_tpu_torch.rllib.core.learner import Learner, to_device
    from ray_tpu_torch.rllib.core.rl_module import params_to_numpy
    c = algo.config
    batch = algo.buffer.sample(c.train_batch_size)
    weights = algo.get_weights()
    target = params_to_numpy(algo.target_params)
    runs = []
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cuda", "cpu"):
            ln = Learner(algo.module, algo._loss_fn(), lr=c.lr,
                         grad_clip=c.grad_clip, loss_cfg=algo._loss_cfg(),
                         device=dev)
            ln.set_weights(weights)
            loss, _aux, grads = ln.grads(to_device(
                {**batch, "target_params": target}, ln.device))
            ln.apply(grads)
            runs.append((float(loss), [g.cpu().numpy() for g in grads],
                         [p.detach().cpu().numpy() for p in ln._leaves]))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    (lc, gc, pc), (lh, gh, ph) = runs
    loss_err = abs(lc - lh) / max(1.0, abs(lh))
    grad_err = max(float(abs(a - b).max()) / max(1e-12, float(abs(b).max()))
                   for a, b in zip(gc, gh))
    param_err = _rl2_max_err(pc, ph)
    if loss_err > 1e-5 or grad_err > 1e-5 or param_err > 2 * c.lr:
        raise AssertionError(f"(a) DQN card vs CPU: loss {loss_err:.3e} "
                             f"(1e-5), grads {grad_err:.3e} (1e-5 of each "
                             f"leaf's largest), params {param_err:.3e} "
                             f"(2 lr)")
    return dict(loss_err=loss_err, grad_err=grad_err, param_err=param_err)


def _sac_card_vs_cpu(torch, algo) -> dict:
    """(b) one fused SAC update (critic, actor, alpha, polyak) of the
    trained state on the card and on the CPU, the same batch and the same
    normals fed: metrics 1e-5 relative, params and targets within 2 lr."""
    import numpy as np
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.core.learner import read_metrics, to_device
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves
    c = algo.config
    cpu = (SACConfig().environment(env=PENDULUM_TWIN)
           .training(lr=c.lr, train_batch_size=c.train_batch_size)
           .learners(device="cpu").debugging(seed=0)).build_algo()
    try:
        cpu.learner_group.set_weights(algo.get_weights())
        cpu._load_extra_state(algo._extra_state(), None)
        batch = algo.buffer.sample(c.train_batch_size)
        gen = torch.Generator().manual_seed(3)
        noise = {k: torch.randn((c.train_batch_size, 1), generator=gen)
                 for k in ("next", "actor")}
        out = []
        for a in (algo, cpu):
            m = read_metrics(a._update(
                to_device(batch, a.device),
                {k: v.to(a.device) for k, v in noise.items()}))
            out.append((m, [p.detach().cpu().numpy() for p in
                            tree_leaves(a.params)
                            + tree_leaves(a.target_params)]))
    finally:
        cpu.stop()
    (mc, pc), (mh, ph) = out
    metric_err = max(abs(mc[k] - mh[k]) / max(1.0, abs(mh[k])) for k in mh)
    param_err = _rl2_max_err(pc, ph)
    if metric_err > 1e-5 or param_err > 2 * c.lr or not np.isfinite(
            param_err):
        raise AssertionError(f"(b) SAC card vs CPU: metrics "
                             f"{metric_err:.3e} (1e-5), params and targets "
                             f"{param_err:.3e} (2 lr)")
    return dict(metric_err=metric_err, param_err=param_err)


def _returns_to_go(rows, gamma: float = 0.99) -> None:
    """Each row's discounted return to the end of its episode, in place
    (rows in time order, one env)."""
    acc = 0.0
    for r in reversed(rows):
        acc = r["rewards"] + gamma * (1.0 - r["dones"]) * acc
        r["returns"] = acc


def _write_jsonl(rows, path: str) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _freeway_random(episodes: int = 12, max_steps: int = 150) -> float:
    """The random policy's mean return on MinAtarFreeway-v0 (the JAX
    score-gate test's baseline: numpy's default_rng(0), episodes seeded
    0..11)."""
    import numpy as np
    from ray_tpu_torch.rllib.env.base import make
    env = make("MinAtarFreeway-v0", max_steps=max_steps)
    rng = np.random.default_rng(0)
    rets = []
    for ep in range(episodes):
        env.reset(seed=ep)
        total = 0.0
        for _ in range(max_steps):
            _o, r, term, trunc, _ = env.step(int(rng.integers(0, 3)))
            total += r
            if term or trunc:
                break
        rets.append(total)
    return float(np.mean(rets))


def rl_offpolicy_phase(torch, smi) -> dict:
    """RLlib's off-policy, offline, multi-agent and model-based half
    (`ray_tpu_torch.rllib`) on the card, within RL2_BUDGET_S, each part
    under its own limit (RL2_PART_S). (a) DQN on MinAtarBreakout-v0 at the
    config's defaults (hidden 64, 64, batch 32, 32 updates an iteration,
    learning after 1000 steps), one local runner of 8 envs acting on the
    CPU: env-steps/s, ms an update, the learner's peak; one update card
    vs CPU. (b) SAC on the Pendulum twin at the JAX test's config (64
    steps and 64 updates of 128 rows an iteration, learning after 500
    steps): the best mean of the last 10 returns > -900 within 220
    iterations; ms an update; one fused update card vs CPU. (c) offline:
    (b)'s policy and (a)'s greedy policy recorded to JSON lines; CQL from
    the twin's file (a BC warm-up iteration, then two conservative ones:
    finite losses, critic_loss > bellman_loss), BC and MARWIL from the
    MinAtar file (BC's greedy actions match the recorded ones on >= 0.9
    of the rows). (d) MultiAgentPPO on the cooperative
    env over two runner actors, the learners on the card: the JAX test's
    bar (return > 9 after 25 iterations); no runtime process outlives it.
    (e) DreamerV3 on MinAtarFreeway-v0 (max_steps 150) at the score-gate
    test's config: the late mean return above max(1.25 x random, random
    + 0.3) within 90 iterations; then one update at the default width
    (deter 256, hidden 256, 16 x 16 latents, B 8, T 32, H 10) timed, its
    synchronizing calls counted."""
    import importlib
    import tempfile

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, DQNConfig,
                                     DreamerV3Config, MARWILConfig,
                                     MultiAgentPPOConfig, SACConfig)
    from ray_tpu_torch.rllib.core.learner import to_device
    from ray_tpu_torch.rllib.env.base import register
    from ray_tpu_torch.rllib.offline import record_transitions
    me = importlib.import_module("chip_smoke")
    register(PENDULUM_TWIN, me.PendulumTwin)
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="offline-", dir=os.path.join(ROOT, "tmp"))
    out: dict = {}
    t_phase = time.perf_counter()
    try:
        # (a) DQN over a host runner, the learner on the card
        with _TimeLimit(RL2_PART_S["a"], "25 a") as tl:
            dqn = (DQNConfig().environment(env="MinAtarBreakout-v0")
                   .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                                rollout_fragment_length=32)
                   .debugging(seed=0)).build_algo()
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(4):        # 1024 steps: learning starts
                    dqn.train()
                sps, iter_ms, last, results = _rl_timed(dqn, 3)
                peak = torch.cuda.max_memory_allocated()
                if not all(math.isfinite(x["total_loss"]) for x in results):
                    raise AssertionError(f"(a) DQN losses: {results}")
                if not all(p.is_cuda for p in
                           _leaves(dqn.learner_group.local.params)):
                    raise AssertionError("(a) DQN learner params off CUDA")
                batch = dqn.buffer.sample(dqn.config.train_batch_size)
                batch["target_params"] = dqn.target_params
                t0 = time.perf_counter()
                for _ in range(32):
                    dqn.learner_group.update(batch)
                update_ms = (time.perf_counter() - t0) / 32 * 1e3
                ex_a = _dqn_card_vs_cpu(torch, dqn)
                dqn_weights, dqn_module = dqn.get_weights(), dqn.module
            finally:
                dqn.stop()
        out["a"] = dict(sps=sps, iter_ms=iter_ms, update_ms=update_ms,
                        peak=peak, s=tl.s, **ex_a)
        log(f"  (a) DQN MinAtarBreakout-v0, 8 envs on one local runner (CPU "
            f"acting), 32 updates of 32 rows an iteration: {sps:.1f} "
            f"env-steps/s, {iter_ms:.1f} ms an iteration, "
            f"{update_ms:.3f} ms an update (its host read included), "
            f"learner peak {peak / 2**20:.1f} MiB, td_error_mean "
            f"{last['td_error_mean']:.4f}; card vs CPU (TF32 on globally): "
            f"loss {ex_a['loss_err']:.2e} (1e-5), grads "
            f"{ex_a['grad_err']:.2e} (1e-5 of each leaf's largest), params "
            f"{ex_a['param_err']:.2e} (2 lr); {tl.s:.1f} s [{smi}]")

        # (b) SAC on the Pendulum twin
        with _TimeLimit(RL2_PART_S["b"], "25 b") as tl:
            sac = (SACConfig().environment(env=PENDULUM_TWIN)
                   .env_runners(num_env_runners=0, num_envs_per_env_runner=1,
                                rollout_fragment_length=64)
                   .training(lr=3e-4, train_batch_size=128,
                             num_updates_per_iter=64,
                             num_steps_sampled_before_learning_starts=500)
                   .debugging(seed=0)).build_algo()
            try:
                runner = sac.env_runner_group.local
                best, iters = -1e9, 0
                t0 = time.perf_counter()
                for i in range(220):
                    r = sac.train()
                    iters = i + 1
                    if i >= 80 and runner.completed_returns:
                        best = max(best, float(np.mean(
                            runner.completed_returns[-10:])))
                        if best > -900.0:
                            break
                train_s = time.perf_counter() - t0
                if not best > -900.0:
                    raise AssertionError(f"(b) SAC on the Pendulum twin: "
                                         f"best mean of the last 10 returns "
                                         f"{best:.1f} <= -900 after {iters} "
                                         f"iterations")
                batch = to_device(sac.buffer.sample(128), sac.device)
                sac._update(batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(64):
                    sac._update(batch)
                torch.cuda.synchronize()
                sac_update_ms = (time.perf_counter() - t0) / 64 * 1e3
                ex_b = _sac_card_vs_cpu(torch, sac)
                sac_weights, sac_module = sac.get_weights(), sac.module
                alpha = r.get("alpha", float("nan"))
            finally:
                sac.stop()
        out["b"] = dict(best=best, iters=iters, train_s=train_s,
                        update_ms=sac_update_ms, s=tl.s, **ex_b)
        log(f"  (b) SAC on the Pendulum twin (64 steps and 64 updates of 128 "
            f"rows an iteration): best mean of the last 10 returns "
            f"{best:.1f} (gate > -900) after {iters} iterations, "
            f"{iters * 64} env steps, in {train_s:.1f} s; alpha {alpha:.4f};"
            f" {sac_update_ms:.3f} ms a fused update (critic, actor, alpha, "
            f"polyak; no host read); card vs CPU on fed normals: metrics "
            f"{ex_b['metric_err']:.2e} (1e-5), params and targets "
            f"{ex_b['param_err']:.2e} (2 lr); {tl.s:.1f} s")

        # (c) offline: record, then CQL, BC and MARWIL from files
        with _TimeLimit(RL2_PART_S["c"], "25 c") as tl:
            twin_path = os.path.join(tmp, "pendulum.json")
            twin_rows = record_transitions(
                PENDULUM_TWIN, sac_module, sac_weights, num_steps=1000,
                path=twin_path, fmt="json", seed=1)
            atari_rows = record_transitions(
                "MinAtarBreakout-v0", dqn_module, dqn_weights,
                num_steps=2000, seed=1, explore=False)
            _returns_to_go(atari_rows)
            atari_path = os.path.join(tmp, "breakout.json")
            _write_jsonl(atari_rows, atari_path)
            cql = (CQLConfig().environment(env=PENDULUM_TWIN)
                   .offline_data(input_=twin_path)
                   .training(lr=3e-4, train_batch_size=64,
                             num_updates_per_iter=8, cql_alpha=1.0,
                             num_ood_actions=3, bc_iters=1)
                   .debugging(seed=0)).build_algo()
            try:
                cql_res = [cql.train() for _ in range(3)]
                cql_eval = cql.evaluate(200)["episode_return_mean"]
            finally:
                cql.stop()
            for k in ("critic_loss", "actor_loss", "bellman_loss"):
                if not all(math.isfinite(x[k]) for x in cql_res):
                    raise AssertionError(f"(c) CQL {k}: {cql_res}")
            gap = cql_res[-1]["critic_loss"] - cql_res[-1]["bellman_loss"]
            if not gap > 0:
                raise AssertionError(f"(c) CQL: critic_loss <= bellman_loss "
                                     f"({cql_res[-1]})")
            offline = {}
            for name, cls in (("BC", BCConfig), ("MARWIL", MARWILConfig)):
                algo = (cls().environment(env="MinAtarBreakout-v0")
                        .offline_data(input_=atari_path)
                        .training(lr=1e-3, minibatch_size=128, num_epochs=2)
                        .debugging(seed=0)).build_algo()
                try:
                    res = [algo.train() for _ in range(3)]
                    with torch.no_grad():
                        logits, _ = algo.module.forward(
                            algo.learner_group.local.params,
                            torch.as_tensor(algo._obs, device="cuda"))
                    agree = float((logits.argmax(-1).cpu().numpy()
                                   == algo._actions).mean())
                finally:
                    algo.stop()
                if not all(math.isfinite(x["total_loss"]) for x in res):
                    raise AssertionError(f"(c) {name} losses: {res}")
                offline[name] = ([x["total_loss"] for x in res], agree)
            bc, bc_agree = offline["BC"]
            if not bc_agree >= 0.9:
                raise AssertionError(f"(c) BC's greedy actions match the "
                                     f"recorded ones on {bc_agree:.3f} of "
                                     f"the rows (< 0.9)")
        out["c"] = dict(gap=gap, cql_eval=cql_eval, offline=offline, s=tl.s)
        log(f"  (c) offline: {len(twin_rows)} twin rows (SAC's policy) and "
            f"{len(atari_rows)} MinAtarBreakout rows (DQN's greedy policy, "
            f"returns to go added) as JSON lines; CQL from the twin's file, "
            f"a BC warm-up iteration then two conservative (3 OOD actions): "
            f"critic_loss {cql_res[-1]['critic_loss']:.3f} > bellman_loss "
            f"{cql_res[-1]['bellman_loss']:.3f}, actor_loss "
            f"{cql_res[-1]['actor_loss']:.3f}, an evaluation return "
            f"{cql_eval:.1f}; from the MinAtar file BC's loss "
            f"{[round(x, 4) for x in bc]}, its greedy actions == the "
            f"recorded ones on {bc_agree:.3f} of the rows (gate >= 0.9); "
            f"MARWIL's loss {[round(x, 4) for x in offline['MARWIL'][0]]}, "
            f"agreement {offline['MARWIL'][1]:.3f}; {tl.s:.1f} s")

        # (d) multi-agent PPO over two runner actors
        with _TimeLimit(RL2_PART_S["d"], "25 d") as tl:
            rt.init(num_cpus=8, object_store_memory=256 << 20)
            try:
                mappo = (MultiAgentPPOConfig().environment(
                            env=me.TargetMatchEnv)
                         .env_runners(num_env_runners=2,
                                      rollout_fragment_length=128)
                         .training(lr=3e-3, minibatch_size=64, num_epochs=4)
                         .debugging(seed=0)).build_algo()
                try:
                    t0 = time.perf_counter()
                    last = mappo.train()
                    boot_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    for _ in range(24):
                        last = mappo.train()
                    iter_ms = (time.perf_counter() - t0) / 24 * 1e3
                    on_card = all(p.is_cuda for ln in mappo.learners.values()
                                  for p in ln._leaves)
                finally:
                    mappo.stop()
            finally:
                rt.shutdown()
            deadline = time.monotonic() + 15
            while _runtime_processes() and time.monotonic() < deadline:
                time.sleep(0.5)
            left = _runtime_processes()
            if left:
                raise AssertionError(f"(d) runtime processes outlived "
                                     f"shutdown: {left}")
            if not on_card:
                raise AssertionError("(d) a policy's learner is off CUDA")
            if not (last["episode_return_mean"] > 9.0
                    and "a0/total_loss" in last and "a1/total_loss" in last):
                raise AssertionError(f"(d) MultiAgentPPO: {last}")
        out["d"] = dict(ret=last["episode_return_mean"], boot_s=boot_s,
                        iter_ms=iter_ms, s=tl.s)
        log(f"  (d) MultiAgentPPO on the cooperative env, two runner actors, "
            f"a learner a policy on the card: episode return "
            f"{last['episode_return_mean']:.2f} after 25 iterations (bar > "
            f"9; random play ~4); first iteration (runners booting) "
            f"{boot_s:.2f} s, then {iter_ms:.1f} ms an iteration; no "
            f"runtime process left; {tl.s:.1f} s")

        # (e) DreamerV3
        with _TimeLimit(RL2_PART_S["e"], "25 e") as tl:
            rand = _freeway_random()
            gate = max(1.25 * rand, rand + 0.3)
            config = (DreamerV3Config()
                      .environment(env="MinAtarFreeway-v0",
                                   env_config={"max_steps": 150})
                      .training(batch_size_B=16, batch_length_T=16,
                                num_updates_per_iter=16, horizon_H=15,
                                entropy_scale=1e-3, actor_critic_lr=1e-3,
                                model_size={"deter": 64, "hidden": 64,
                                            "classes": 8, "groups": 8})
                      .debugging(seed=0))
            config.num_envs = 8
            algo = config.build_algo()
            try:
                scores = []
                t0 = time.perf_counter()
                for it in range(90):
                    r = algo.train()
                    if "episode_return_mean" in r:
                        scores.append(r["episode_return_mean"])
                    if len(scores) >= 3 and float(np.mean(scores[-3:])) > gate:
                        break
                score_s = time.perf_counter() - t0
                late = float(np.mean(scores[-3:])) if scores else float("nan")
                if not all(math.isfinite(r[k]) for k in
                           ("world_model_loss", "actor_loss", "critic_loss")):
                    raise AssertionError(f"(e) DreamerV3 losses: {r}")
                if not late > gate:
                    raise AssertionError(
                        f"(e) DreamerV3 late return {late:.3f} <= "
                        f"{gate:.3f} (random {rand:.3f}): {scores}")
            finally:
                algo.stop()
            wide = (DreamerV3Config()
                    .environment(env="MinAtarFreeway-v0",
                                 env_config={"max_steps": 150})
                    .debugging(seed=0)).build_algo()
            try:
                wide._collect(wide.config.batch_length_T)
                batch = wide._replay_batch(np.arange(wide.config.batch_size_B))
                wide._update(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(3):
                    m = wide._update(batch)
                torch.cuda.synchronize()
                wide_ms = (time.perf_counter() - t0) / 3 * 1e3
                wide_peak = torch.cuda.max_memory_allocated()
                syncs = _rl_syncs(torch, lambda: wide._update(batch))
                if not math.isfinite(float(m["world_model_loss"])):
                    raise AssertionError(f"(e) default width: {m}")
            finally:
                wide.stop()
        out["e"] = dict(late=late, rand=rand, iters=it + 1, score_s=score_s,
                        wide_ms=wide_ms, wide_peak=wide_peak,
                        syncs=len(syncs), s=tl.s)
        log(f"  (e) DreamerV3 MinAtarFreeway-v0 (max_steps 150, B 16, T 16, "
            f"H 15, 16 updates an iteration, deter 64): late mean return "
            f"{late:.3f} (gate > {gate:.3f}; random {rand:.3f}) after "
            f"{it + 1} iterations in {score_s:.1f} s; default width (deter "
            f"256, hidden 256, 16 x 16 latents, B 8, T 32, H 10): "
            f"{wide_ms:.1f} ms an update, peak {wide_peak / 2**20:.1f} MiB, "
            f"{len(syncs)} synchronizing call(s) in an update"
            + (f" ({syncs[0][:90]})" if syncs else "")
            + f"; {tl.s:.1f} s [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    if out["s"] > RL2_BUDGET_S:
        raise AssertionError(f"rl-offpolicy phase took {out['s']:.1f} s, "
                             f"past its {RL2_BUDGET_S} s budget")
    return out


def trace_padded_call(torch, what: str, fn, iters: int, smi: str) -> None:
    """What a padded-width call costs, by torch.profiler's device trace:
    each kernel's device time a call (the pads, the kernel, the cut), and
    the host's time to issue `iters` calls beside the device sleep that
    `device_ms` queues them behind (a host slower than the sleep leaves
    the device idle inside the timed window)."""
    from torch.profiler import ProfilerActivity, profile
    n = 24
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            rows.append((t / n, e.count / n, e.key))
    rows.sort(reverse=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(int(1e8))
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"  {what} traced: " + "; ".join(
        f"{k[:48]} {t:.2f} us x {c:g}" for t, c, k in rows)
        + f" (device us a call, {sum(t for t, _, _ in rows):.2f} in all); "
        f"the host issues {iters} calls in {issue_ms:.2f} ms against the "
        f"{sleep_ms:.2f} ms device sleep [{smi}]")


def time_head_dims(torch, root: str) -> int:
    """--head-dim-times ROOT: with the package of the checkout at ROOT
    (this one, or another, say the parent commit's), the device time of
    each kernel in bf16 at head_dims 12, 16, 32, 64, 80, 100, 128, 256,
    264, 384 and 520: K2 with lse, K3 and K4 at [8, 1024, 16 heads, 8 kv
    heads] causal, K1, K1' and K5 at 32 slots x 16/8 heads, lengths
    128-191 (P = 2, S = 5 for K1' and K5; pools at the padded head_dim
    where it is no multiple of 8, as the engines allocate them), each
    beside its bound (the bytes each input is read and each output written
    once, or its products, at the card's data-sheet rates, for the true
    head_dim); the widths a checkout's wrappers refuse are reported as
    refused."""
    sys.path.insert(0, root)
    import ray_tpu_torch
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ray_tpu_torch imported from "
                           f"{ray_tpu_torch.__file__}, not {root}")
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import paged_attention as PA
    _build.build_all()
    smi = smi_line()
    g = torch.Generator(device="cuda").manual_seed(8)
    lens_l = torch.randint(128, 192, (32,), generator=torch.Generator()
                           .manual_seed(3)).tolist()
    import torch.nn.functional as F
    d8_of = getattr(_build, "padded_head_dim", lambda hd: hd)
    for hd in (12, 16, 32, 64, 80, 100, 128, 256, 264, 384, 520):
        d8 = d8_of(hd)
        B, S, H, Hkv = 8, 1024, 16, 8
        q, k, v, do = attn_case(torch, g, B, S, H, Hkv, hd, torch.bfloat16)
        scale = hd ** -0.5
        try:
            o, lse = A.flash_attention_fwd(q, k, v, True, scale,
                                           with_lse=True)
        except ValueError as e:
            log(f"  hd {hd}: refused ({e}) [{smi}]")
            continue
        delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
                 .reshape(B * H, S).contiguous())
        fwd = device_ms(torch, lambda i: A.flash_attention_fwd(
            q, k, v, True, scale, with_lse=True), 20)
        dq = device_ms(torch, lambda i: A.flash_bwd_dq(
            q, k, v, do, lse, delta, True, scale), 20)
        dkv = device_ms(torch, lambda i: A.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, scale), 20)
        del q, k, v, do, o, lse, delta
        qd, pk, pv, lens, tables = k1_case(torch, 32, H, Hkv, hd, 128, 2,
                                           lens_l, torch.bfloat16, seed=4,
                                           layers=12)
        pk, pv = F.pad(pk, (0, d8 - hd)), F.pad(pv, (0, d8 - hd))
        k1 = device_ms(torch, lambda i: PA.paged_decode_attention(
            qd, pk[i % 12], pv[i % 12], lens, tables), 240)
        qv, pk, pv, kn, vn, lens, tables = verify_case(
            torch, 32, 5, H, Hkv, hd, 128, 2, lens_l, torch.bfloat16, seed=4,
            layers=12, scratch_entries=False)
        pk, pv = F.pad(pk, (0, d8 - hd)), F.pad(pv, (0, d8 - hd))
        k1v = device_ms(torch, lambda i: PA.paged_verify_attention(
            qv, pk[i % 12], pv[i % 12], lens, tables), 240)
        k5 = device_ms(torch, lambda i: PA.paged_verify_insert_attention(
            qv, pk, pv, kn, vn, lens, tables, i % 12), 240)
        if d8 != hd:
            trace_padded_call(torch, f"K5 at hd {hd}", lambda i:
                              PA.paged_verify_insert_attention(
                                  qv, pk, pv, kn, vn, lens, tables, i % 12),
                              240, smi)
        log(f"  hd {hd}: K2 with lse {fwd * 1e3:.2f} us, K3 {dq * 1e3:.2f} us, "
            f"K4 {dkv * 1e3:.2f} us at [{B},{S},{H}/{Hkv},{hd}] causal; K1 "
            f"{k1 * 1e3:.2f} us, K5 {k5 * 1e3:.2f} us at 32 slots x "
            f"{H}/{Hkv} heads, lengths 128-191 [{smi}]")
        # bounds: q/o/dq/do of H heads, k/v/dk/dv of Hkv heads, lse and
        # delta fp32; 2 * hd flops per (query, key) pair and product
        isz, pairs = 2, B * H * S * (S + 1) // 2
        qb, kvb, rows = B * S * H * hd * isz, B * S * Hkv * hd * isz, \
            B * H * S * 4
        tokens = sum(min(x, 2 * 128) for x in lens_l)
        k1_bytes = (tokens * Hkv * hd * 2 * isz + 2 * qd.numel() * isz
                    + 32 * 4 * 3)
        bounds = {
            "K2 with lse": bound_ms(2 * qb + 2 * kvb + rows,
                                    4 * hd * pairs, "bfloat16"),
            "K3": bound_ms(3 * qb + 2 * kvb + 2 * rows, 6 * hd * pairs,
                           "bfloat16"),
            "K4": bound_ms(2 * qb + 4 * kvb + 2 * rows, 8 * hd * pairs,
                           "bfloat16"),
            "K1": bound_ms(k1_bytes, 4 * H * hd * tokens, "bfloat16"),
            "K1'": bound_ms(*verify_work(lens_l, 5, 128, 2, H, Hkv, hd, isz,
                                         False), "bfloat16"),
            "K5": bound_ms(*verify_work(lens_l, 5, 128, 2, H, Hkv, hd, isz,
                                        True), "bfloat16"),
        }
        log(f"  hd {hd}: K1' {k1v * 1e3:.2f} us; bounds " + ", ".join(
            f"{n} {b * 1e3:.2f} us ({by})" for n, (b, by) in bounds.items())
            + f" [{smi}]")
        del qd, qv, pk, pv, kn, vn
    return 0


def serve_worker(root: str) -> int:
    """--serve-worker ROOT: import the port from the checkout at ROOT and
    run this script's serve phase once per line read from stdin, each
    run's numbers printed on a line of their own after "SERVE_RUN "."""
    import torch
    sys.path.insert(0, root)
    import ray_tpu_torch
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ray_tpu_torch imported from "
                           f"{ray_tpu_torch.__file__}, not {root}")
    from ray_tpu_torch.ops import paged_attention as PA
    smi = smi_line()
    lens_l = torch.randint(128, 192, (32,), generator=torch.Generator()
                           .manual_seed(3)).tolist()
    k1_in = k1_case(torch, 32, 12, 12, 64, 128, 2, lens_l, torch.bfloat16,
                    seed=4)
    k1_args = (k1_in[0], k1_in[1][0], k1_in[2][0], *k1_in[3:])
    for _ in sys.stdin:
        serve, eng, _p = serve_phase(torch, {"paged_decode": {}}, smi)
        del eng
        torch.cuda.empty_cache()
        # the host's cost of one K1 call at the serving shape: 200 calls
        # issued without a wait (each takes the device ~12 us, less than
        # the host's cost, so the launch queue never fills)
        for _i in range(10):
            PA.paged_decode_attention(*k1_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _i in range(200):
            PA.paged_decode_attention(*k1_args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print("SERVE_RUN " + json.dumps(dict(
            {k: serve[k] for k in ("tokens_per_s", "wall_s", "decode_steps")},
            k1_host_us=host_us)), flush=True)
    return 0


def serve_ab(other: str, pairs: int) -> int:
    """--serve-ab OTHER [--pairs N]: the serve phase (phase 4) of another
    checkout of the repo (say a parent commit's, unpacked beside this one)
    and of this one in turn, N pairs in the order other, this, this,
    other, ...: each checkout's package in a worker process of its own,
    both alive throughout, one serving at a time, after one unrecorded
    run each (builds, first engine). Prints every run's decode tokens/s
    and the host's cost of one K1 call at the serving shape, their
    medians and the pairs this checkout won."""
    import statistics
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = smi_line()
    roots = {"other": os.path.abspath(other), "this": ROOT}
    procs = {}
    try:
        for name, root in roots.items():
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-worker",
                 root], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)

        def run(name):
            p = procs[name]
            p.stdin.write("run\n")
            p.stdin.flush()
            for line in p.stdout:
                if line.startswith("SERVE_RUN "):
                    return json.loads(line[len("SERVE_RUN "):])
                log(f"  [{name}] {line.rstrip()}")
            raise RuntimeError(f"the {name} worker ended: rc {p.wait()}")

        for name in roots:
            run(name)
        tps = {"other": [], "this": []}
        host = {"other": [], "this": []}
        for i in range(pairs):
            for name in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                r = run(name)
                tps[name].append(r["tokens_per_s"])
                host[name].append(r["k1_host_us"])
                log(f"  pair {i} {name}: {r['tokens_per_s']:.1f} tokens/s, "
                    f"wall {r['wall_s']:.3f} s, {r['decode_steps']} decode "
                    f"steps; host cost of a K1 call {r['k1_host_us']:.2f} us")
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    won = sum(a > b for a, b in zip(tps["this"], tps["other"]))
    log(f"serve A/B over {pairs} pairs [{smi}]: this "
        f"{roots['this']} median {statistics.median(tps['this']):.1f} "
        f"tokens/s ({', '.join(f'{x:.1f}' for x in tps['this'])}); other "
        f"{roots['other']} median {statistics.median(tps['other']):.1f} "
        f"({', '.join(f'{x:.1f}' for x in tps['other'])}); this faster in "
        f"{won} of {pairs} pairs; host cost of a K1 call, median: this "
        f"{statistics.median(host['this']):.2f} us, other "
        f"{statistics.median(host['other']):.2f} us")
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve-ab", metavar="OTHER_CHECKOUT",
                    help="only time the serve phase against another checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--serve-worker", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--head-dim-times", metavar="ROOT", nargs="?", const=ROOT,
                    help="only time the kernels at head_dims 12-520, with "
                    "the package of the checkout at ROOT (default: this)")
    args = ap.parse_args()
    if args.serve_worker:
        return serve_worker(os.path.abspath(args.serve_worker))
    if args.serve_ab:
        return serve_ab(args.serve_ab, args.pairs)
    import torch
    if args.head_dim_times:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        return time_head_dims(torch, os.path.abspath(args.head_dim_times))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ray_tpu_torch
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise RuntimeError(f"ray_tpu_torch imported from "
                           f"{ray_tpu_torch.__file__}, not this checkout")
    from ray_tpu_torch.ops import _build
    t_all = time.perf_counter()

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/25] device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[2/25] build: {len(build_logs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        # ptxas -v reports, per kernel instantiation, an entry line, a
        # stack/spill line and a register/smem line; print one line each
        entry = spill = ""
        for line in text.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"  {src}: {entry}: {line.split(':', 1)[-1].strip()}; "
                    f"{spill}")
            elif "error" in line or "warning" in line:
                log(f"  {src}: {line.strip()}")
    tc = tensor_core_counts(_build)
    if tc is None:
        log("  no cuobjdump in the toolkit: tensor-core instructions not "
            "counted")
    else:
        for fn, (hg, hm) in tc.items():
            log(f"  SASS {fn}: {hg} HGMMA (wgmma), {hm} HMMA (mma.sync)")
        for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                       "flash_bwd_dq_wgmma_kernel"):
            # D = 64 and 128, each for hd = D and padded (hd < D)
            found = [n for n in tc if n.startswith(kernel + " bf16")]
            if len(found) != 4 or any(tc[n][0] == 0 for n in found):
                raise AssertionError(f"{kernel}: bf16 instantiations {found} "
                                     f"lack wgmma in their SASS")
        tf32 = [n for n in tc if " fp32 " in n and tc[n] != (0, 0)]
        if tf32:
            raise AssertionError(f"fp32 bodies {tf32} use the tensor cores "
                                 f"(TF32): they must stay on fp32 FMAs")

    results: dict = {}
    t0 = time.perf_counter()
    log("[3/25] kernels against their plain versions")
    check_k1(torch, results)
    check_verify(torch, results)
    check_k2(torch, results)
    check_k3_k4(torch, results)
    check_head_dims(torch, results)
    log(f"  kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[4/25] serve: llama-125m bf16, 36 requests x 64 greedy tokens")
    serve, eng, prompts = serve_phase(torch, results, smi)
    log(f"  serve phase {time.perf_counter() - t0:.1f} s; decode "
        f"{serve['tokens_per_s']:.1f} tokens/s, wall {serve['wall_s']:.3f} s,"
        f" peak {serve['peak_bytes']} B")

    t0 = time.perf_counter()
    log("[4b] where the serve path's time goes")
    profile_phase(torch, eng, prompts, smi)
    no_sync_check(torch, eng)
    log(f"  profile phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[5/25] spec-serve: llama-125m bf16, the same 36 requests, ngram "
        "speculation, spec_k 4")
    spec = spec_serve_phase(torch, results, smi, eng.params, serve)
    log(f"  spec-serve phase {time.perf_counter() - t0:.1f} s; "
        f"{spec['tokens_per_s']:.1f} tokens/s vs plain "
        f"{serve['tokens_per_s']:.1f}, acceptance {spec['acceptance']:.3f}")

    serve_params = eng.params
    del eng
    t0 = time.perf_counter()
    log("[6/25] exact: llama-125m fp32, engine vs forward (flash kernel)")
    exact_phase(torch, results)
    log(f"  exact phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[7/25] spec-exact: llama-125m fp32, speculative vs plain engine vs "
        "forward")
    spec_exact_phase(torch)
    log(f"  spec-exact phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[8/25] train: llama-125m bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"adamw(3e-4)")
    torch.cuda.empty_cache()
    train = train_phase(torch, results, smi)
    log(f"  train phase {time.perf_counter() - t0:.1f} s; "
        f"{train['step_ms']:.2f} ms/step, {train['tokens_per_s']:.1f} "
        f"tokens/s, MFU {100 * train['mfu']:.2f} %")

    t0 = time.perf_counter()
    log("[9/25] train-exact: llama-125m fp32, kernels vs plain attention")
    torch.cuda.empty_cache()
    train_exact_phase(torch)
    log(f"  train-exact phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[10/25] tiny: configs.tiny() (head_dim 16) through the engine, the "
        "speculative engine and the train step")
    tiny_phase(torch)
    log(f"  tiny phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[11/25] guided: llama-125m bf16, the serve phase's 32 prompts, half "
        "under a JSON-schema guide; fp32 against masked forward argmax")
    guide = guided_phase(torch, smi, serve_params, serve)
    log(f"  guided phase {time.perf_counter() - t0:.1f} s; "
        f"{guide['tokens_per_s']:.1f} tokens/s vs serve "
        f"{serve['tokens_per_s']:.1f}, peak {guide['peak_bytes']} B")
    del serve_params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("[12/25] handoff: prefill engine -> import_kv + resume_token, "
        "llama-125m, 300-token prompts")
    hand = handoff_phase(torch, smi)
    log(f"  handoff phase {time.perf_counter() - t0:.1f} s; "
        f"{hand['tokens_per_s']:.1f} tokens/s decode, "
        f"{hand['e2e_tokens_per_s']:.1f} end to end, peak "
        f"{hand['peak_bytes']} B")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("[13/25] dense: kv_layout='dense', llama-125m, fp32 against the "
        "paged engine, bf16 timed")
    dense = dense_phase(torch, smi, serve)
    log(f"  dense phase {time.perf_counter() - t0:.1f} s; "
        f"{dense['tokens_per_s']:.1f} tokens/s, peak {dense['peak_bytes']} B")
    torch.cuda.empty_cache()

    import torch.distributed as dist
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh(MeshConfig(fsdp=1))
    log(f"[14/25] sharded-train: llama-125m over {mesh} (a process group "
        f"of one), bf16 {TRAIN_BATCH} x {TRAIN_SEQ} timed, fp32 2 x 256 "
        f"against the unsharded step")
    sharded = sharded_train_phase(torch, smi, train, mesh)
    log(f"  sharded-train phase {time.perf_counter() - t0:.1f} s; "
        f"{sharded['step_ms']:.2f} ms/step vs {train['step_ms']:.2f} "
        f"unsharded")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("[15/25] checkpoint: the sharded bf16 state after step 5 through "
        "the manifest path, restored into a fresh state")
    ck = checkpoint_phase(torch, smi, mesh)
    log(f"  checkpoint phase {time.perf_counter() - t0:.1f} s; save "
        f"{ck['save_ms']:.1f} ms, restore {ck['restore_ms']:.1f} ms, "
        f"{ck['bytes']} bytes")
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("[16/25] tp-serve: tp=2 as two processes on the one card over gloo, "
        "llama-125m")
    tps = tp_serve_phase(torch, smi, serve)
    log(f"  tp-serve phase {time.perf_counter() - t0:.1f} s; "
        f"{tps['tokens_per_s']:.1f} tokens/s vs {serve['tokens_per_s']:.1f} "
        f"at tp=1")

    t0 = time.perf_counter()
    log("[17/25] trainer: the port's runtime and Trainer, llama-125m on a "
        "worker holding the card")
    tr = trainer_phase(torch, smi, train)
    log(f"  trainer phase {time.perf_counter() - t0:.1f} s; "
        f"{tr['step_ms']:.2f} ms/step vs {train['step_ms']:.2f} in this "
        f"process; boot to first report {tr['boot_s']:.2f} s, restart "
        f"{tr['restart_s']:.2f} s")
    for kernel, key in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                        ("flash_bwd_dkv", "dkv")):
        results[kernel]["trainer_launches"] = tr["counts"][key]["cuda"]

    t0 = time.perf_counter()
    log("[18/25] serve-runtime: serve.run(build_openai_app(...)) on the "
        "port's runtime, a replica holding the card, HTTP on a free port; "
        "llama-125m bf16 timed, fp32 and a LoRA adapter exact")
    sr = serve_runtime_phase(torch, results, smi, serve)
    log(f"  serve-runtime phase {time.perf_counter() - t0:.1f} s; "
        f"{sr['tokens_per_s']:.1f} tokens/s through HTTP vs "
        f"{serve['tokens_per_s']:.1f} in process; boot {sr['boot_s']:.2f} "
        f"s, first streamed chunk {1e3 * sr['ttft_s']:.1f} ms, replica "
        f"peak {sr['peak'] / 2**30:.3f} GiB")

    t0 = time.perf_counter()
    log("[19/25] disagg: serve.run(build_disagg_openai_app(...)) on the "
        "port's runtime, a prefill worker and two decode replicas sharing "
        "the card, HTTP on a free port; llama-125m bf16 timed, fp32 exact "
        "with a handoff check, a decode replica killed mid-stream and a "
        "shed burst")
    dg = disagg_phase(torch, results, smi, serve, sr)
    log(f"  disagg phase {time.perf_counter() - t0:.1f} s; "
        f"{dg['tokens_per_s']:.1f} tokens/s through HTTP vs "
        f"{sr['tokens_per_s']:.1f} in phase 18 and "
        f"{serve['tokens_per_s']:.1f} in process; boot {dg['boot_s']:.2f} "
        f"s, export {dg['export_ms']:.2f} ms under load and "
        f"{dg['export_alone_ms']:.2f} ms alone, handoff "
        f"{dg['handoff_bytes']} B a request")

    t0 = time.perf_counter()
    log("[20/25] tp-gang: tensor_parallelism=2 replicas as gangs of two "
        "processes through the port's runtime: build_openai_app (bf16 "
        "timed, fp32 and a LoRA adapter exact, a follower killed and the "
        "gang replaced) and both disaggregated pools (a bf16 burst, fp32 "
        "exact with a full-width handoff)")
    tg = tp_gang_phase(torch, results, smi, serve, tps, sr, dg)
    log(f"  tp-gang phase {time.perf_counter() - t0:.1f} s; "
        f"{tg['tokens_per_s']:.1f} tokens/s through HTTP at tp=2 vs "
        f"{tps['tokens_per_s']:.1f} in process at tp=2 and "
        f"{sr['tokens_per_s']:.1f} through HTTP at tp=1; boot "
        f"{tg['boot_s']:.2f} s, a gang replaced in {tg['replace_s']:.2f} s;"
        f" the pools at tp=2 {tg['disagg_tokens_per_s']:.1f} tokens/s")

    t0 = time.perf_counter()
    log("[21/25] data: the data library on the port's runtime: "
        "build_llm_processor over 256 prompts (llama-125m bf16, an engine "
        "actor holding the card; fp32 exact through two actors at 0.5 "
        "GPU) and the Trainer fed by iter_torch_batches(device='cuda')")
    da = data_phase(torch, results, smi, serve, sr, train, tr)
    log(f"  data phase {time.perf_counter() - t0:.1f} s; batch inference "
        f"{da['tokens_per_s']:.1f} tokens/s vs {serve['tokens_per_s']:.1f} "
        f"in process and {sr['tokens_per_s']:.1f} through HTTP, first row "
        f"{da['first_row_s']:.2f} s; ingest {da['step_ms']:.2f} ms/step vs "
        f"{tr['step_ms']:.2f} through phase 17's trainer")

    t0 = time.perf_counter()
    log("[22/25] parallel: sequence, expert and pipeline parallelism: the "
        "kernel ring at bench_sp_ring's 32768 tokens on one process; sp = 2, "
        "ep = 2 and pp = 2 as two processes over gloo on the one card "
        "(ring and Ulysses attention, the llama-125m ring train step at "
        "32768 tokens, mixtral_8x7b at depth 2, GPipe)")
    pa = parallel_phase(torch, results, smi)
    log(f"  parallel phase {time.perf_counter() - t0:.1f} s; sp = 2 train "
        f"step {pa['step_ms']:.1f} ms ({pa['tokens_per_s']:.1f} tokens/s) vs "
        f"{pa['one_ms']:.1f} on one process; the ring at 32768 tokens "
        f"{pa['ring_ms']:.3f} ms on one process, {pa['split_ms']:.3f} split "
        f"over two")

    t0 = time.perf_counter()
    log("[23/25] dag: compiled graphs, channels and collectives through the "
        "port's runtime, two stage actors at 0.5 GPU: a CUDA tensor hop, "
        "the compiled two-stage llama-125m forward over a tensor channel, "
        "allreduce, broadcast and barrier of CUDA tensors; the Trainer fed "
        "by from_torch, TFRecord written and read")
    dg23 = dag_phase(torch, results, smi)
    log(f"  dag phase {time.perf_counter() - t0:.1f} s; compiled "
        f"{dg23['dag_ms']:.2f} ms per execute vs plain .remote() chains "
        f"{dg23['plain_ms']:.2f} and one process {dg23['inproc_ms']:.2f}; "
        f"hop {dg23['hop_ms']:.2f} ms ({dg23['hop_gbps']:.2f} GB/s)")

    t0 = time.perf_counter()
    log("[24/25] rl: RLlib's on-policy half, the learner on the card: PPO "
        "over a host runner (MinAtarBreakout-v0) and with the env on the "
        "card (JaxAtariClassBreakout-v0), IMPALA on the card, on-card "
        "learning, fp32 card vs CPU, IMPALA and APPO over runner actors "
        "with one SIGKILLed, two learner actors at 0.5 GPU")
    rl = rl_phase(torch, smi)
    log(f"  rl phase {time.perf_counter() - t0:.1f} s (budget {RL_BUDGET_S} "
        f"s); PPO {rl['a']['sps']:.1f} env-steps/s over a host runner, "
        f"{rl['b']['sps']:.1f} with the env on the card; IMPALA on the card "
        f"{rl['c']['sps']:.1f}; learned {rl['d']['window']:.3f} a episode")

    t0 = time.perf_counter()
    log("[25/25] rl-offpolicy: RLlib's off-policy, offline, multi-agent and "
        "model-based half, the learners on the card: DQN over a host runner "
        "(MinAtarBreakout-v0), SAC on the Pendulum twin, offline CQL, BC and "
        "MARWIL from recorded files, MultiAgentPPO over two runner actors, "
        "DreamerV3 on MinAtarFreeway-v0 and one update at its default width")
    rl2 = rl_offpolicy_phase(torch, smi)
    log(f"  rl-offpolicy phase {time.perf_counter() - t0:.1f} s (budget "
        f"{RL2_BUDGET_S} s); DQN {rl2['a']['update_ms']:.2f} ms an update, "
        f"SAC {rl2['b']['update_ms']:.2f} ms a fused update, DreamerV3 "
        f"{rl2['e']['wide_ms']:.1f} ms an update at the default width")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        results[k] for k in ("paged_decode", "paged_verify",
                             "paged_verify_insert", "flash_fwd",
                             "flash_bwd_dq", "flash_bwd_dkv")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
