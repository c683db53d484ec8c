"""``linear``, ``embedding`` and the dropouts. Counterpart:
``paddle_tpu/nn/functional/common.py`` (``linear`` :24-29, ``dropout``
:32-58, ``dropout2d`` :61-63, ``dropout3d`` :66-68, ``embedding``).

Dropout follows JAX's rule: ``keep ~ Bernoulli(1 - p)`` over x's shape,
or over the axes ``axis`` names with 1 elsewhere (broadcast); in
training ``upscale_in_train`` gives ``where(keep, x / (1 - p), 0)`` and
``downscale_in_infer`` ``where(keep, x, 0)``; in eval the first is the
identity and the second ``x (1 - p)``; ``p == 0`` is the identity; the
constants are rounded to x's dtype, as JAX's weak-typed scalars are.
``p == 1`` gives zeros with zero grads (JAX's ``x / 0`` under the mask
gives NaN grads). The mask draws from the caller's ``torch.Generator``
on x's device (``keep = U[0, 1) < 1 - p``, JAX's ``bernoulli``);
training with ``p > 0`` and no generator raises. JAX draws threefry keys
from its global stream, so a seed gives other masks than JAX's."""
from __future__ import annotations

import torch

from .activation import _const, _div

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d"]

_MODES = ("upscale_in_train", "downscale_in_infer")


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


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """x with each element (or each slice along ``axis``) kept with
    probability 1 - p; the mask drawn from ``generator``."""
    if mode not in _MODES:
        raise ValueError(f"dropout: mode {mode!r}, expected one of {_MODES}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p {p} is not in [0, 1]")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _const(1.0 - p, x.dtype)
        return x
    if generator is None:
        raise ValueError(
            "dropout in training with p > 0 draws its mask from an "
            "explicit torch.Generator: pass generator=")
    if axis is None:
        shape = x.shape
    else:
        axes = {axis} if isinstance(axis, int) else set(axis)
        if not axes or min(axes) < 0 or max(axes) >= x.dim():
            raise ValueError(f"dropout: axis {axis} is not within the "
                             f"{x.dim()} dims of x")
        shape = [n if i in axes else 1 for i, n in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train" and p < 1.0:
        x = _div(x, 1.0 - p)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole channels dropped: the mask is over (N, C)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training, generator=generator)
