"""Functionals of the training slice. Counterpart:
``paddle_tpu/nn/functional``; ``rms_norm`` is ``ops/rms_norm.py``."""
from ...ops.rms_norm import rms_norm  # noqa: F401
from .attention import (flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention)
from .common import embedding, linear, silu  # noqa: F401
from .loss import cross_entropy  # noqa: F401

__all__ = ["linear", "embedding", "silu", "rms_norm", "cross_entropy",
           "scaled_dot_product_attention", "flash_attn_unpadded"]
