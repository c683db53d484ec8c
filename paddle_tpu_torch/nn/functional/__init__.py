"""Functionals of the training slices. Counterpart:
``paddle_tpu/nn/functional``; ``rms_norm`` is ``ops/rms_norm.py``."""
from ...ops.rms_norm import rms_norm  # noqa: F401
from .activation import (gelu, hardsigmoid, hardswish, relu,  # noqa: F401
                         relu6, sigmoid, silu, swish)
from .attention import (flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention)
from .common import (dropout, dropout2d, dropout3d,  # noqa: F401
                     embedding, linear)
from .conv import conv2d  # noqa: F401
from .loss import (chunked_causal_lm_loss,  # noqa: F401
                   chunked_softmax_cross_entropy, cross_entropy, mse_loss)
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "silu", "swish", "relu", "relu6", "gelu", "sigmoid",
           "hardsigmoid", "hardswish", "rms_norm", "layer_norm",
           "batch_norm", "cross_entropy", "chunked_softmax_cross_entropy",
           "chunked_causal_lm_loss", "scaled_dot_product_attention",
           "flash_attn_unpadded", "conv2d", "mse_loss", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d"]
