"""ray_tpu_torch.llm — the continuous-batching engine (paged or dense KV,
guided decoding, speculation) and the prefill engine of disaggregated
serving (counterpart of `ray_tpu.llm`). The guide compilers are in
`llm/guided.py`. The serve deployment, OpenAI router and batch processor
need the serve runtime and come with their own slice of the port."""

from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, LoraConfig
from ray_tpu_torch.llm.engine import InferenceEngine, PrefillEngine, Request
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["InferenceEngine", "PrefillEngine", "EngineConfig", "Request",
           "LLMConfig", "LoraConfig", "ByteTokenizer", "get_tokenizer"]
