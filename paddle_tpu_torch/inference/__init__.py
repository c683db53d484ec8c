"""Serving: the paged-KV decoder and the ragged continuous-batching
engine. Counterpart: ``paddle_tpu/inference``."""
from .paged_decode import PagedLlamaDecoder  # noqa: F401
from .serving import Request, SamplingParams, ServingEngine  # noqa: F401

__all__ = ["ServingEngine", "SamplingParams", "Request",
           "PagedLlamaDecoder"]
