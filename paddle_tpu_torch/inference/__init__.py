"""Serving: the paged-KV decoders (Llama and GPT) and the ragged
continuous-batching engine, with speculative decoding and many-LoRA
serving, and the fleet Router over dp replicas. Counterpart:
``paddle_tpu/inference``."""
from .lora import AdapterRegistry, LoRALayout  # noqa: F401
from .fleet import Router  # noqa: F401
from .gpt_decode import PagedGPTDecoder  # noqa: F401
from .paged_decode import PagedLlamaDecoder  # noqa: F401
from .serving import (EngineOverloaded, Request, SamplingParams,  # noqa: F401
                      ServingEngine)
from .spec_decode import Drafter, NGramDrafter, SpecConfig  # noqa: F401

__all__ = ["ServingEngine", "SamplingParams", "Request",
           "EngineOverloaded", "PagedLlamaDecoder", "PagedGPTDecoder",
           "SpecConfig", "Drafter", "NGramDrafter", "AdapterRegistry",
           "LoRALayout", "Router"]
