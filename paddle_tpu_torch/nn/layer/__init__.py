from .common import Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm"]
