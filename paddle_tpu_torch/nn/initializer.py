"""Parameter initializers. Counterpart: ``paddle_tpu/nn/initializer.py``
(``_fans``, ``Constant``, ``Normal``, ``XavierUniform``).

An initializer is a callable ``(shape, dtype, generator, device) ->
tensor`` that draws from the explicit ``torch.Generator`` it is given
(``None``: torch's default generator of the device). The distributions
are JAX's; the bits are not (threefry and Philox differ)."""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "XavierUniform",
           "convert_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def convert_dtype(dtype) -> torch.dtype:
    """A paddle dtype name ("float32", "bfloat16", "float16") or a torch
    dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[dtype]


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *k]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, dtype, generator=None, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator=None, device=None):
        return torch.full(tuple(shape), self.value,
                          dtype=convert_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None, device=None):
        t = torch.empty(tuple(shape), dtype=convert_dtype(dtype),
                        device=device)
        return t.normal_(self.mean, self.std, generator=generator)


class XavierUniform(Initializer):
    def __call__(self, shape, dtype, generator=None, device=None):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        t = torch.empty(tuple(shape), dtype=convert_dtype(dtype),
                        device=device)
        return t.uniform_(-limit, limit, generator=generator)
