"""``RMSNorm`` and ``LayerNorm``. Counterparts:
``paddle_tpu/nn/layer/norm.py`` (``LayerNorm`` :86-112, ``RMSNorm``
:114-128): RMSNorm's gain takes the layer's dtype (the model's, e.g.
bfloat16) and starts at ones; LayerNorm's gain (ones) and bias (zeros)
are float32, as JAX's ``create_parameter`` makes them for a layer built
without a dtype."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(I.Constant(1.0)(
            (hidden_size,), dtype, None, resolve_device(device)))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            I.Constant(1.0)(self.normalized_shape, torch.float32, None, dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            I.Constant(0.0)(self.normalized_shape, torch.float32, None, dev))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"
