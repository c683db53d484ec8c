"""RMSNorm on tensors. Counterpart: ``paddle_tpu/ops/rms_norm.py``.

Same rounding as the JAX version: accumulate in float32, cast back to
the input dtype, then multiply by the gain in the input dtype."""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1):
    acc = x.to(torch.float32)
    ms = acc.square().mean(dim=axis, keepdim=True)
    out = (acc * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out
