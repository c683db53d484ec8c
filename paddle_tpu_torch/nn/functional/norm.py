"""``batch_norm`` and ``layer_norm``. Counterparts:
``paddle_tpu/nn/functional/norm.py`` (``batch_norm`` :17-65,
``layer_norm`` :68).

``batch_norm`` follows JAX's order and rounding, in plain torch ops:

- in training (and unless ``use_global_stats``) the batch mean and the
  biased variance over every axis but the channel axis, accumulated in
  float32 and returned in x's dtype (``jnp.mean`` / ``jnp.var``);
- the running stats updated in place outside autograd as ``m * running
  + (1 - m) * batch`` (paddle's ``momentum=0.9`` keeps 0.9 of the old
  value), ``(1 - m) * batch`` in the batch stat's dtype with ``1 - m``
  rounded to it first, as JAX's weakly typed constant is;
- ``inv = rsqrt(var.float() + eps)`` cast to x's dtype;
- ``(x - mean) * inv``, then ``* w``, then ``+ b``, each operand cast
  to x's dtype.

Eval mode and ``use_global_stats`` read the running stats. The channel
axis is 1 for ``NC*`` layouts and the last otherwise; inputs of 2 to 5
dimensions. ``torch.nn.functional.batch_norm`` is not used: it keeps the
unbiased variance in ``running_var``, weighs the new value by its
``momentum`` and keeps bf16 stats in float32, so its running stats
would not be JAX's.

``layer_norm`` rounds as the JAX version does: mean and variance in
float32, the normalized value cast back to the input dtype, then the
gain and the bias applied in the input dtype (each cast to it). The
serving decoder's LayerNorm rounds elsewhere
(``inference/gpt_decode.py``)."""
from __future__ import annotations

import torch

from .activation import _const

__all__ = ["batch_norm", "layer_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Mutates ``running_mean`` / ``running_var`` when it uses the batch
    stats (paddle's in-place semantics)."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    dims = tuple(i for i in range(x.ndim) if i != ch)
    if training and not use_global_stats:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        with torch.no_grad():
            m = momentum
            for run, new in ((running_mean, mean), (running_var, var)):
                upd = run * m + new * _const(1 - m, new.dtype)
                run.copy_(upd.to(run.dtype))
    else:
        mean, var = running_mean, running_var
    shape = [1] * x.ndim
    shape[ch] = -1
    inv = torch.rsqrt(var.float() + epsilon).to(x.dtype)
    out = (x - mean.reshape(shape).to(x.dtype)) * inv.reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(x.dtype)
    return out


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
