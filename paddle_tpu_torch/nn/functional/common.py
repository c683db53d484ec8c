"""``linear``, ``embedding`` and ``silu``. Counterparts:
``paddle_tpu/nn/functional/common.py`` (``linear`` :24-29,
``embedding``) and ``nn/functional/activation.py`` (``silu``)."""
from __future__ import annotations

import torch

__all__ = ["linear", "embedding", "silu"]


def linear(x, weight, bias=None):
    """y = x @ W (+ b), with paddle's [in, out] weight cast to x's dtype
    inside the product (a float32 weight under bfloat16 activations)."""
    y = torch.matmul(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def embedding(x, weight):
    """Row gather of the [vocab, dim] table."""
    return torch.nn.functional.embedding(x, weight)


def silu(x):
    return torch.nn.functional.silu(x)
