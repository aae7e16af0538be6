"""LoRA adapters for the LLM stack (counterpart of `ray_tpu/llm/lora.py`).

Parity: reference `python/ray/llm/_internal/serve/deployments/llm/multiplex/`
(LoRA checkpoints multiplexed onto replicas). An adapter is a tree of
(A, B) factors over the attention projections, stacked over layers like
the base params; `merge_lora` folds W + (alpha/r)·A@B into a copy of the
params once per adapter, and the serve layer caches merged trees per
model id, so decode runs the same engine with no per-token cost. A tp
engine's params are its rank's blocks: the serve layer cuts the full
deltas (`lora_deltas`) by the engine's own placement
(`InferenceEngine.local_blocks`) and adds those (`add_deltas`).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

TARGETS = ("wq", "wk", "wv", "wo")


def adapter_seed(model_id: str) -> int:
    """A seed for `model_id`'s demo adapter that every process agrees on:
    a digest of the id (Python's `hash` of a str changes from process to
    process)."""
    digest = hashlib.sha256(model_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def init_lora(model_config, rank: int, generator: torch.Generator,
              targets=TARGETS) -> dict:
    """Zero-initialized adapter (B = 0: the base model's behavior), A drawn
    from `generator` at scale 0.01, fp32 on the generator's device."""
    c = model_config
    L, d, hd = c.n_layers, c.d_model, c.head_dim
    dev = generator.device
    out = {}
    for t in targets:
        cols = {"wq": c.n_heads * hd, "wk": c.n_kv_heads * hd,
                "wv": c.n_kv_heads * hd, "wo": d}[t]
        rows = {"wq": d, "wk": d, "wv": d, "wo": c.n_heads * hd}[t]
        out[t] = {
            "A": torch.randn((L, rows, rank), generator=generator,
                             device=dev, dtype=torch.float32) * 0.01,
            "B": torch.zeros((L, rank, cols), device=dev,
                             dtype=torch.float32),
        }
    return out


def _factor(x, device) -> torch.Tensor:
    """An fp32 factor on `device` (numpy arrays are copied: they may be
    read-only views of the object store)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def lora_deltas(lora: dict, alpha: float = 16.0, rank: int | None = None,
                device="cpu") -> dict:
    """An adapter's full weight deltas as a part of the params tree,
    {"layers": {target: (alpha / rank)·A@B}}, fp32 on `device`: a caller
    may cut it as it cut the params (`InferenceEngine.local_blocks`). The
    factors may be tensors or numpy arrays; the rank is read from them
    unless given."""
    rank = rank or next(iter(lora.values()))["A"].shape[-1]
    scale = alpha / rank
    return {"layers": {
        t: torch.einsum("lir,lrj->lij",
                        *(_factor(ab[k], device) for k in ("A", "B"))) * scale
        for t, ab in lora.items()}}


def add_deltas(params: dict, deltas: dict) -> dict:
    """A new params tree with each of `lora_deltas`' deltas cast to its
    weight's dtype and added. A delta whose shape is not its weight's
    raises ValueError."""
    layers = dict(params["layers"])
    for t, delta in deltas["layers"].items():
        w = layers[t]
        if delta.shape != w.shape:
            raise ValueError(
                f"the {t} delta is {tuple(delta.shape)}, its weight "
                f"{tuple(w.shape)}: a tp engine's params are its rank's "
                f"blocks, and the deltas are cut to them by "
                f"InferenceEngine.local_blocks")
        layers[t] = w + delta.to(device=w.device, dtype=w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def merge_lora(params: dict, lora: dict, alpha: float = 16.0,
               rank: int | None = None) -> dict:
    """A new params tree with the adapter folded in: the fp32 delta
    (alpha / rank)·A@B, cast to each layer's dtype and added. The factors
    may be tensors or numpy arrays; they move to the params' device."""
    device = params["layers"][next(iter(lora))].device
    return add_deltas(params, lora_deltas(lora, alpha, rank, device))
