"""Functionals of the training slices. Counterpart:
``paddle_tpu/nn/functional``; ``rms_norm`` is ``ops/rms_norm.py``."""
from ...ops.rms_norm import rms_norm  # noqa: F401
from .activation import gelu  # noqa: F401
from .attention import (flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention)
from .common import embedding, linear, silu  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import (chunked_causal_lm_loss,  # noqa: F401
                   chunked_softmax_cross_entropy, cross_entropy, mse_loss)
from .norm import layer_norm  # noqa: F401

__all__ = ["linear", "embedding", "silu", "gelu", "rms_norm", "layer_norm",
           "cross_entropy", "chunked_softmax_cross_entropy",
           "chunked_causal_lm_loss", "scaled_dot_product_attention",
           "flash_attn_unpadded", "conv2d", "mse_loss"]
