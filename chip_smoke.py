#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each raises on failure, so the script exits non-zero and prints
no result line):
 1. device  — name, power limit, torch and CUDA versions;
 2. build   — both hand-written kernels from the checkout's sources (one
              nvcc per source, in parallel), with ptxas's register,
              shared-memory and spill report;
 3. kernels — each kernel against its plain PyTorch version on the card
              (bf16 and fp32, stated tolerances), then its time (CUDA
              events, warmed, launches queued behind a device sleep so the
              host's launch cost is not timed), the plain version's time,
              the least time the card could take (bound) and, where one
              PyTorch call computes the same function, that call's time;
 4. serve   — the engine at full Llama-125M width (bf16, seeded random
              weights): 32 requests of 127 tokens plus 4 sharing a
              128-token prefix, 64 greedy tokens each; the paged-decode
              kernel must have run 12 times per decode step and the plain
              path never; then where the serve path's time goes (host
              clock of admission and of one decode window, and a
              torch.profiler trace: device busy time, idle share, device
              time by kernel);
 5. exact   — the same width in fp32: the engine's greedy tokens must
              equal an argmax loop over the port's `forward`, which runs
              the flash-forward kernel.
It prints the card's name and power limit, then one JSON line with the
kernels' numbers, then the result line
{"ok": true, "device": {"platform": "gpu", ...}} last.

It imports nothing of JAX or of the JAX package `ray_tpu`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}


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
    from ray_tpu_torch.ops import paged_attention as PA
    errs = []
    for label, h, hkv in (("llama-125m", 12, 12), ("llama3-1b GQA", 32, 8)):
        rng_l = [1, 127, 128, 129, 1024, 255, 256, 257]
        g = torch.Generator().manual_seed(1)
        rng_l += torch.randint(1, 1025, (24,), generator=g).tolist()
        for dtype in (torch.bfloat16, torch.float32):
            q, pk, pv, lens, tables = k1_case(torch, 32, h, hkv, 64, 128, 8,
                                              rng_l, dtype, seed=2)
            got = PA.paged_decode_attention(q, pk[0], pv[0], lens, tables)
            want = PA.paged_decode_attention_reference(q, pk[0], pv[0],
                                                       lens, tables)
            torch.cuda.synchronize()
            dn = str(dtype).split(".")[1]
            err = (got.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dn]
            log(f"  K1 paged_decode {label} {dn}: max_abs_err {err:.3e} "
                f"(tol {TOL[dn]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {label} {dn} disagrees: {err}")
            errs.append(err)
    # timing at the serving path's shape: 32 slots at lengths 128-191,
    # a 2-page table bucket, 12 layers' pools visited in turn (the
    # per-layer working set, 15.7 MB, would otherwise sit in L2)
    g = torch.Generator().manual_seed(3)
    lens_l = torch.randint(128, 192, (32,), generator=g).tolist()
    q, pk, pv, lens, tables = k1_case(torch, 32, 12, 12, 64, 128, 2, lens_l,
                                      torch.bfloat16, seed=4, layers=12)
    kern = lambda i: PA.paged_decode_attention(  # noqa: E731
        q, pk[i % 12], pv[i % 12], lens, tables)
    plain = lambda i: PA.paged_decode_attention_reference(  # noqa: E731
        q, pk[i % 12], pv[i % 12], lens, tables)
    ms = device_ms(torch, kern, 240)
    plain_ms = device_ms(torch, plain, 24)
    tokens = sum(min(x, 2 * 128) for x in lens_l)
    isz = 2
    nbytes = (tokens * 12 * 64 * 2 * isz          # K and V rows, once
              + 2 * q.numel() * isz               # q in, out
              + lens.numel() * 4 + tables.numel() * 4)
    flops = 4 * 12 * 64 * tokens                  # QK and PV
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"  K1 time at 32x12x64 bf16, lengths 128-191: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    results["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/paged_attention.py:78", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


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
        f"{nbytes / 1e6:.1f} MB)")
    results["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:34", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)


# ---------------- phases 4-5: the main path ----------------


def reset_counts():
    from ray_tpu_torch.ops import attention, paged_attention
    for d in (attention.launches, paged_attention.launches):
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
                peak_bytes=peak), eng, prompts[:32]


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
    log(f"  profiled 32 x 17 tokens: wall {wall_us / 1e3:.2f} ms (profiler "
        f"on), device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {len(spans)} device activities [{smi}]")
    cuda = torch.autograd.DeviceType.CUDA
    rows = [r for r in prof.key_averages()
            if getattr(r, "device_type", None) == cuda
            and getattr(r, "self_device_time_total", 0) > 0]
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    for r in rows[:12]:
        log(f"    {r.self_device_time_total / 1e3:9.3f} ms  {r.count:6d}x  "
            f"{r.key[:90]}")


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
            eng.params, eng.cache_k, eng.cache_v, generator=gen,
            config=eng.c, eos_token=-1, n_steps=4, trunc=True,
            want_logp=True, fused=fused, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out, logps, lens = out.cpu(), logps.cpu(), lens.cpu()
    if (out.shape != (4, B) or not ((out >= 0) & (out < eng.c.vocab)).all()
            or not (logps <= 0).all() or not (lens == 14).all()):
        raise AssertionError("no-sync window returned bad tokens/state")
    log("  decode window: 4 steps with top-k/top-p sampling and logprobs, "
        "no host synchronization (CUDA sync debug mode 'error')")


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


def main() -> int:
    import torch
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
    log(f"[1/5] device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[2/5] build: {len(build_logs)} kernels in "
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

    results: dict = {}
    t0 = time.perf_counter()
    log("[3/5] kernels against their plain versions")
    check_k1(torch, results)
    check_k2(torch, results)
    log(f"  kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[4/5] serve: llama-125m bf16, 36 requests x 64 greedy tokens")
    serve, eng, prompts = serve_phase(torch, results, smi)
    log(f"  serve phase {time.perf_counter() - t0:.1f} s; decode "
        f"{serve['tokens_per_s']:.1f} tokens/s, wall {serve['wall_s']:.3f} s,"
        f" peak {serve['peak_bytes']} B")

    t0 = time.perf_counter()
    log("[4b] where the serve path's time goes")
    profile_phase(torch, eng, prompts, smi)
    no_sync_check(torch, eng)
    log(f"  profile phase {time.perf_counter() - t0:.1f} s")
    del eng

    t0 = time.perf_counter()
    log("[5/5] exact: llama-125m fp32, engine vs forward (flash kernel)")
    exact_phase(torch, results)
    log(f"  exact phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": [results["paged_decode"],
                                  results["flash_fwd"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
