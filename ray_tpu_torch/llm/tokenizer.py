"""Tokenizers for the LLM stack (a copy of `ray_tpu/llm/tokenizer.py`).

`byte`: dependency-free byte-level tokenizer (ids 0..255 + bos/eos), the
default in this zero-egress environment. `hf:<name>` uses a local
transformers tokenizer when its files are already on disk (parity with the
reference resolving tokenizers through transformers)."""

from __future__ import annotations


class ByteTokenizer:
    """Bytes + 2 specials. vocab_size = 258 (bos=256, eos=257)."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, name: str):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(name)
        self.eos_id = self.tok.eos_token_id
        self.vocab_size = self.tok.vocab_size

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self.tok.encode(text)

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(spec: str):
    if spec == "byte":
        return ByteTokenizer()
    if spec.startswith("hf:"):
        return HFTokenizer(spec[3:])
    raise ValueError(f"unknown tokenizer spec {spec!r}")
