"""Layers, functionals and initializers of the training slice.
Counterpart: ``paddle_tpu/nn``. Layers are ``torch.nn.Module``s whose
parameter names equal the JAX layers' ``named_parameters()`` names."""
from . import functional, initializer  # noqa: F401
from .layer import Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "functional",
           "initializer"]
