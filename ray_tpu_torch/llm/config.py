"""LLM deployment/processor configuration (counterpart of
`ray_tpu/llm/config.py`), read by the serve deployment (`llm/serve.py`).

Parity: reference `python/ray/llm/_internal/serve/configs/` (LLMConfig:
engine sizing consumed for placement). `num_gpus_per_replica` takes the
role of the JAX package's `num_tpus_per_replica` under the port's "GPU"
resource: each replica actor reserves it, and its engine runs on the card
it reserved (`device`, CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

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
