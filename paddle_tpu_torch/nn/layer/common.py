"""``Linear`` and ``Embedding``. Counterparts:
``paddle_tpu/nn/layer/common.py`` (``Linear`` :18-34, ``Embedding``
:82-100) and ``Layer.create_parameter`` (``nn/layer/layers.py:87-100``).

Paddle's layouts and defaults: the Linear weight is **[in, out]**
(XavierUniform), the bias Constant 0 (none with ``bias_attr=False``);
the Embedding table is [vocab, dim], Normal(0, 1). Parameters are
float32 whatever the model's compute dtype: ``F.linear``
casts the weight to the activation's dtype inside the product.
Initializers draw from ``generator`` on ``device`` (``None``: cuda,
raising without a card)."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["Linear", "Embedding"]


def _param(init, shape, generator, device):
    return nn.Parameter(init(shape, torch.float32, generator,
                             resolve_device(device)))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias_attr=None,
                 generator=None, device=None):
        super().__init__()
        if bias_attr not in (None, False):
            raise NotImplementedError(
                "Linear: only bias_attr=None or False is ported")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param(I.XavierUniform(), (in_features, out_features),
                             generator, device)
        self.bias = None if bias_attr is False else _param(
            I.Constant(0.0), (out_features,), generator, device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, generator=None,
                 device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param(I.Normal(0.0, 1.0),
                             (num_embeddings, embedding_dim), generator,
                             device)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
