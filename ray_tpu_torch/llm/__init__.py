"""ray_tpu_torch.llm — the continuous-batching engine (paged or dense KV,
guided decoding, speculation), the prefill engine of disaggregated
serving, LoRA adapters, serving and batch inference through the port's
runtime (counterpart of `ray_tpu.llm`):
- engine.py   <- the engine and the prefill engine;
- serve.py    <- the LLM deployment and the OpenAI router in front of it
                 (`build_openai_app`), adapters registered cluster-wide;
                 the disaggregated prefill/decode plane (`DisaggConfig`,
                 `build_disagg_deployment`, `build_disagg_openai_app`);
                 tensor-parallel replicas as gangs of processes
                 (`_tp_gang.py`) in both;
- batch.py    <- `build_llm_processor`: tokenize, engine and detokenize
                 stages over a `ray_tpu_torch.data` Dataset, the engine
                 stage an actor pool on the card;
- lora.py     <- `init_lora`, `merge_lora`;
- config.py   <- LLMConfig (the replica's GPU reservation and device).
The guide compilers are in `llm/guided.py`.
"""

from ray_tpu_torch.llm.batch import build_llm_processor
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
           "build_disagg_openai_app", "build_llm_processor"]
