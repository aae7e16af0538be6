"""LLM deployment/processor configuration (counterpart of
`ray_tpu/llm/config.py`), read by the serve deployment (`llm/serve.py`)
and the batch processor (`llm/batch.py`).

Parity: reference `python/ray/llm/_internal/serve/configs/` (LLMConfig:
engine sizing consumed for placement). `num_gpus_per_replica` takes the
role of the JAX package's `num_tpus_per_replica` under the port's "GPU"
resource: each replica actor reserves it, and its engine runs on the card
it reserved (`device`, CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.engine import EngineConfig
from ray_tpu_torch.models import ModelConfig, configs as model_zoo


@dataclasses.dataclass
class LoraConfig:
    max_adapters_per_replica: int = 3
    rank: int = 8
    alpha: float = 16.0


@dataclasses.dataclass
class LLMConfig:
    model_id: str = "llama-125m"
    model: ModelConfig | None = None          # None -> look up model_id
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    tensor_parallelism: int = 1               # "tp" mesh size per replica
    num_replicas: int = 1
    num_gpus_per_replica: float = 1.0         # the replica's "GPU" reservation
    tokenizer: str = "byte"                   # byte | hf:<name>
    lora: LoraConfig | None = None
    seed: int = 0
    device: str = "cuda"                      # "cuda" | "cpu" (tests)

    def resolve_model(self) -> ModelConfig:
        if self.model is not None:
            return self.model
        getter = getattr(model_zoo, self.model_id.replace("-", "_"), None)
        if getter is None:
            raise ValueError(
                f"unknown model_id {self.model_id!r}; pass model= explicitly"
                f" or add it to ray_tpu_torch.models.configs")
        return getter()

    def engine_config(self, tokenizer) -> EngineConfig:
        """The engine config, stopping on the tokenizer's eos unless the
        user overrode the default."""
        eos = getattr(tokenizer, "eos_id", None)
        if eos is not None and self.engine.eos_token == EngineConfig().eos_token:
            return dataclasses.replace(self.engine, eos_token=eos)
        return self.engine

    def check(self) -> None:
        """What a replica would refuse at start, refused when its
        deployment or processor is built, before any replica starts: a tp
        that does not divide the model's kv heads (the engine splits its KV
        pool by kv head) or the widths the rules table splits over tp, and
        a CUDA replica that reserves no GPU."""
        tp = self.tensor_parallelism
        c = self.resolve_model()
        if tp < 1:
            raise ValueError(f"tensor_parallelism={tp}: at least 1")
        for what, n in (("n_kv_heads", c.n_kv_heads), ("d_ff", c.d_ff),
                        ("vocab", c.vocab)):
            if n % tp:
                raise ValueError(
                    f"a replica over tp={tp} needs tp to divide {what}={n}: "
                    f"the engine splits its KV pool by kv head, and the "
                    f"params along {what}, over tp")
        if self.device != "cpu":
            self._reserved_gpu()

    def _reserved_gpu(self) -> None:
        if self.num_gpus_per_replica <= 0:
            raise ValueError(
                f"LLMConfig(device={self.device!r}) with "
                f"num_gpus_per_replica={self.num_gpus_per_replica}: a "
                f"replica runs on the card it reserves; reserve one, or ask "
                f"for device='cpu'")

    def replica_device(self) -> torch.device:
        """The replica's engine device: the CPU when the config asks for
        it, else the card the replica reserved. A replica that asks for
        CUDA and reserved no GPU raises; it never falls back to the CPU."""
        if self.device == "cpu":
            return torch.device("cpu")
        self._reserved_gpu()
        return resolve_device(self.device)  # raises if CUDA sees none
