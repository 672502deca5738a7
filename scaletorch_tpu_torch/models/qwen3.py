"""Qwen3 dense model: the Llama decoder with per-head q/k RMSNorm and tied
embeddings (counterpart of scaletorch_tpu/models/qwen3.py). The decoder
body is shared with ``models/llama.py`` through the ``qk_norm`` flag."""

from __future__ import annotations

from dataclasses import dataclass

from scaletorch_tpu_torch.models.llama import LlamaConfig


@dataclass(frozen=True)
class Qwen3Config(LlamaConfig):
    # Qwen3-0.6B defaults (the ``qwen3-0.6b`` preset)
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128  # explicit, != hidden // heads
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True
    qk_norm: bool = True
