"""ray_tpu_torch.llm — the continuous-batching engine (paged or dense KV,
guided decoding, speculation), the prefill engine of disaggregated
serving, LoRA adapters and serving through the port's runtime
(counterpart of `ray_tpu.llm`):
- engine.py  <- the engine and the prefill engine;
- serve.py   <- the LLM deployment and the OpenAI router in front of it
                (`build_openai_app`), adapters registered cluster-wide;
                the disaggregated prefill/decode plane (`DisaggConfig`,
                `build_disagg_deployment`, `build_disagg_openai_app`);
- lora.py    <- `init_lora`, `merge_lora`;
- config.py  <- LLMConfig (the replica's GPU reservation and device).
The guide compilers are in `llm/guided.py`. Tensor-parallel replicas and
the batch processor are later slices (ROADMAP queue 1 items 7 (f), its
second half, and 7 (e)).
"""

from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, LoraConfig
from ray_tpu_torch.llm.engine import InferenceEngine, PrefillEngine, Request
from ray_tpu_torch.llm.serve import (DisaggConfig, build_disagg_deployment,
                                     build_disagg_openai_app,
                                     build_llm_deployment, build_openai_app)
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["InferenceEngine", "PrefillEngine", "EngineConfig", "Request",
           "LLMConfig", "LoraConfig", "ByteTokenizer", "get_tokenizer",
           "build_llm_deployment", "build_openai_app",
           "DisaggConfig", "build_disagg_deployment",
           "build_disagg_openai_app"]
