"""ray_tpu_torch.llm — the paged-KV continuous-batching engine (counterpart
of `ray_tpu.llm`). The serve deployment, OpenAI router and batch processor
need the serve runtime and come with their own slice of the port."""

from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, LoraConfig
from ray_tpu_torch.llm.engine import InferenceEngine, Request
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["InferenceEngine", "EngineConfig", "Request", "LLMConfig",
           "LoraConfig", "ByteTokenizer", "get_tokenizer"]
