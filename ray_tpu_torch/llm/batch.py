"""Batch LLM inference over ray_tpu_torch.data datasets — a staged processor
(counterpart of `ray_tpu/llm/batch.py`).

Parity: reference `python/ray/llm/_internal/batch/` (Processor with
preprocess / engine / postprocess STAGES over Ray Data, vLLMEngineStage).
Three pipeline stages:

  1. tokenize   — stateless task UDF (cheap, parallel across blocks)
  2. engine     — class UDF, one continuous-batching engine per actor, on
                  the share of the card the actor reserved
                  (`LLMConfig.num_gpus_per_replica`); its decode steps run
                  the paged-decode kernel
  3. detokenize — stateless task UDF

Under the streaming executor a detokenize task starts as soon as its
engine block ends, while the engine decodes the next block. But a task
stage hands its first block on only once its window of
`DataContext.max_tasks_in_flight` blocks is full or its input has ended,
so in a job of no more blocks than that the first output row comes only
after the engine has finished every block (PERF.md §7 holds the open
question). The stages are module-level classes: they travel to the
workers by reference.

The engine stage is one process a replica, so `tensor_parallelism > 1` is
refused (the JAX package builds one engine without a mesh whatever it
says). A config that asks for the card and reserves none is refused when
the processor is built, before any actor starts; an actor that finds no
card raises and never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.llm.config import LLMConfig


class _Tokenize:
    def __init__(self, llm_config: LLMConfig, input_col: str):
        self.tokenizer = llm_config.tokenizer
        self.input_col = input_col

    def __call__(self, batch: dict) -> dict:
        from ray_tpu_torch.llm.tokenizer import get_tokenizer
        tok = get_tokenizer(self.tokenizer)
        batch["__token_ids"] = np.array(
            [tok.encode(str(p)) for p in batch[self.input_col]],
            dtype=object)
        return batch


class _EngineUDF:
    """Engine stage: one continuous-batching engine per actor, reused
    across blocks; consumes pre-tokenized prompts, emits token ids."""

    def __init__(self, llm_config: LLMConfig, max_new_tokens, temperature):
        from ray_tpu_torch.llm.engine import InferenceEngine
        from ray_tpu_torch.llm.tokenizer import get_tokenizer
        tokenizer = get_tokenizer(llm_config.tokenizer)
        self.engine = InferenceEngine(
            llm_config.resolve_model(), llm_config.engine_config(tokenizer),
            seed=llm_config.seed, device=llm_config.replica_device())
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature

    def __call__(self, batch: dict) -> dict:
        token_lists = [list(map(int, t)) for t in batch["__token_ids"]]
        outs = self.engine.generate(token_lists, self.max_new_tokens,
                                    self.temperature)
        out = {k: v for k, v in batch.items() if k != "__token_ids"}
        out["__generated_ids"] = np.array(
            [np.asarray(o, np.int64) for o in outs], dtype=object)
        return out


class _Detokenize:
    def __init__(self, llm_config: LLMConfig, output_col: str):
        self.tokenizer = llm_config.tokenizer
        self.output_col = output_col

    def __call__(self, batch: dict) -> dict:
        from ray_tpu_torch.llm.tokenizer import get_tokenizer
        tok = get_tokenizer(self.tokenizer)
        out = {k: v for k, v in batch.items() if k != "__generated_ids"}
        out[self.output_col] = np.array(
            [tok.decode(list(map(int, o)))
             for o in batch["__generated_ids"]], dtype=object)
        return out


def build_llm_processor(llm_config: LLMConfig, *, input_col: str = "prompt",
                        output_col: str = "generated",
                        max_new_tokens: int | None = None,
                        temperature: float | None = None,
                        batch_size: int = 32, concurrency: int = 1):
    """Returns Dataset -> Dataset applying the staged generation
    pipeline (tokenize | engine | detokenize). The engine stage is an
    actor pool of `concurrency` actors, each reserving
    `llm_config.num_gpus_per_replica` GPUs."""
    if llm_config.tensor_parallelism != 1:
        raise ValueError(
            f"tensor_parallelism={llm_config.tensor_parallelism}: the batch "
            f"processor's engine stage is one process a replica, with one "
            f"engine and no mesh; serve a tp model with build_openai_app")
    llm_config.check()

    def processor(ds):
        ds = ds.map_batches(_Tokenize(llm_config, input_col),
                            batch_size=batch_size)
        ds = ds.map_batches(
            _EngineUDF,
            fn_constructor_args=(llm_config, max_new_tokens, temperature),
            batch_size=batch_size, concurrency=concurrency,
            num_gpus=llm_config.num_gpus_per_replica)
        return ds.map_batches(_Detokenize(llm_config, output_col),
                              batch_size=batch_size)

    return processor
