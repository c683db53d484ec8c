"""Llama configuration for the serving port (the config only; the
training model comes with the training slice).

Counterpart: ``paddle_tpu/models/llama.py`` (``LlamaConfig``,
``llama_tiny``, ``llama_3_8b``). The port keeps its own copy so that it
never imports the JAX package; the serving fields and their defaults
are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LlamaConfig", "llama_tiny", "llama_3_8b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"


def llama_tiny(**kw) -> LlamaConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    base.update(kw)
    return LlamaConfig(**base)


def llama_3_8b(**kw) -> LlamaConfig:
    base = dict(vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8,
                max_position_embeddings=8192, rope_theta=500000.0)
    base.update(kw)
    return LlamaConfig(**base)
