#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

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
              call's time; K2 and K3/K4 also at S = 1, 63, 65, 129 and
              1000 (the edges of their 64-row tiles) in bf16;
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
              temperatures under CUDA sync debug mode "error";
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
              AdamW trajectory of both, within stated tolerances.
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
                fn = (f"{name.group(1) if name else mangled} "
                      f"{'bf16' if '__nv_bfloat16' in mangled else 'fp32'} "
                      f"D={width.group(1) if width else '?'}")
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
        f"{nbytes / 1e6:.1f} MB); {rate(flops, ms, b_ms)}")
    results["paged_decode"] = dict(
        name="paged_decode", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/paged_attention.py:78", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


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
    but scratch. Also 40 query rows per kv head (32/4), the kernels'
    limit. Then the times at the serving shape and at a long context."""
    from ray_tpu_torch.ops import paged_attention as PA
    S = 5
    errs = {"k1p": [], "k5": []}
    rng_l = [1, 127, 128, 129, 1024, 255, 256, 257]
    g = torch.Generator().manual_seed(1)
    rng_l += torch.randint(1, 1025, (24,), generator=g).tolist()
    for label, h, hkv, hd in (("llama-125m", 12, 12, 64),
                              ("llama3-1b GQA", 32, 8, 64),
                              ("hd 128 GQA", 16, 8, 128),
                              ("40 rows per kv head", 32, 4, 64)):
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
            log(f"  K1' paged_verify {label} hd {hd} {dn}: max_abs_err "
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
        times[label] = time_verify(torch, PA, S, lo, hi, P, label,
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
    trace_summary(torch, prof, wall_us, "32 x 17 tokens", smi)


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
    accepted; then the speculative window stays free of host syncs."""
    import numpy as np
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import configs, forward, init_params
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
    want = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(n_new):
                logits = forward(params, torch.tensor([seq], device="cuda"),
                                 cfg)
                seq.append(int(logits[0, -1].argmax()))
            want.append(seq[len(p):])
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
    log(f"[1/9] device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[2/9] build: {len(build_logs)} kernels in "
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
            found = [n for n in tc if n.startswith(kernel + " bf16")]
            if len(found) != 2 or any(tc[n][0] == 0 for n in found):
                raise AssertionError(f"{kernel}: bf16 instantiations {found} "
                                     f"lack wgmma in their SASS")
        tf32 = [n for n in tc if " fp32 " in n and tc[n] != (0, 0)]
        if tf32:
            raise AssertionError(f"fp32 bodies {tf32} use the tensor cores "
                                 f"(TF32): they must stay on fp32 FMAs")

    results: dict = {}
    t0 = time.perf_counter()
    log("[3/9] kernels against their plain versions")
    check_k1(torch, results)
    check_verify(torch, results)
    check_k2(torch, results)
    check_k3_k4(torch, results)
    log(f"  kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[4/9] serve: llama-125m bf16, 36 requests x 64 greedy tokens")
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
    log("[5/9] spec-serve: llama-125m bf16, the same 36 requests, ngram "
        "speculation, spec_k 4")
    spec = spec_serve_phase(torch, results, smi, eng.params, serve)
    log(f"  spec-serve phase {time.perf_counter() - t0:.1f} s; "
        f"{spec['tokens_per_s']:.1f} tokens/s vs plain "
        f"{serve['tokens_per_s']:.1f}, acceptance {spec['acceptance']:.3f}")
    del eng

    t0 = time.perf_counter()
    log("[6/9] exact: llama-125m fp32, engine vs forward (flash kernel)")
    exact_phase(torch, results)
    log(f"  exact phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[7/9] spec-exact: llama-125m fp32, speculative vs plain engine vs "
        "forward")
    spec_exact_phase(torch)
    log(f"  spec-exact phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[8/9] train: llama-125m bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"adamw(3e-4)")
    torch.cuda.empty_cache()
    train = train_phase(torch, results, smi)
    log(f"  train phase {time.perf_counter() - t0:.1f} s; "
        f"{train['step_ms']:.2f} ms/step, {train['tokens_per_s']:.1f} "
        f"tokens/s, MFU {100 * train['mfu']:.2f} %")

    t0 = time.perf_counter()
    log("[9/9] train-exact: llama-125m fp32, kernels vs plain attention")
    torch.cuda.empty_cache()
    train_exact_phase(torch)
    log(f"  train-exact phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        results[k] for k in ("paged_decode", "paged_verify",
                             "paged_verify_insert", "flash_fwd",
                             "flash_bwd_dq", "flash_bwd_dkv")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
