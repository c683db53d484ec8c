"""Layers, functionals and initializers of the training slice.
Counterpart: ``paddle_tpu/nn``. Layers are ``torch.nn.Module``s whose
parameter names equal the JAX layers' ``named_parameters()`` names."""
from . import functional, initializer  # noqa: F401
from .layer import (GELU, Conv2D, Embedding, LayerList,  # noqa: F401
                    LayerNorm, Linear, MSELoss, RMSNorm, Sequential, SiLU,
                    Silu)

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Sequential",
           "LayerList", "Silu", "SiLU", "GELU", "Conv2D", "MSELoss",
           "functional", "initializer"]
