"""Layers, functionals and initializers of the training slices.
Counterpart: ``paddle_tpu/nn``. Layers are ``torch.nn.Module``s whose
parameter (and buffer) names equal the JAX layers' ``named_parameters()``
(``named_buffers()``) names."""
from . import functional, initializer  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = list(_layers) + ["functional", "initializer"]
