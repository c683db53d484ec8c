"""Serving: the paged-KV decoder and the ragged continuous-batching
engine. Counterpart: ``paddle_tpu/inference``."""
from .paged_decode import PagedLlamaDecoder  # noqa: F401
from .serving import (EngineOverloaded, Request, SamplingParams,  # noqa: F401
                      ServingEngine)

__all__ = ["ServingEngine", "SamplingParams", "Request",
           "EngineOverloaded", "PagedLlamaDecoder"]
