"""Layers, functionals and initializers of the training slice.
Counterpart: ``paddle_tpu/nn``. Layers are ``torch.nn.Module``s whose
parameter names equal the JAX layers' ``named_parameters()`` names."""
from . import functional, initializer  # noqa: F401
from .layer import (GELU, Conv2D, Embedding, GShardGate,  # noqa: F401
                    LayerList, LayerNorm, Linear, MoELayer, MSELoss, RMSNorm,
                    Sequential, SiLU, Silu, SwitchGate)

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Sequential",
           "LayerList", "Silu", "SiLU", "GELU", "Conv2D", "MSELoss",
           "MoELayer", "SwitchGate", "GShardGate", "functional",
           "initializer"]
