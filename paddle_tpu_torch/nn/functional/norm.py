"""``layer_norm``. Counterpart: ``paddle_tpu/nn/functional/norm.py:68``.

Same rounding as the JAX version: mean and variance in float32, the
normalized value cast back to the input dtype, then the gain and the
bias applied in the input dtype (each cast to it). The serving
decoder's LayerNorm rounds elsewhere (``inference/gpt_decode.py``)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(-len(tuple(normalized_shape)), 0))
    acc = x.to(torch.float32)
    mean = acc.mean(dim=dims, keepdim=True)
    var = acc.var(dim=dims, keepdim=True, unbiased=False)
    out = ((acc - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
        if bias is not None:
            out = out + bias.to(x.dtype)
    elif bias is not None:
        out = out + bias
    return out
