"""Parameter initializers. Counterpart: ``paddle_tpu/nn/initializer.py``
(``calculate_gain``, ``_fans``, ``Constant``, ``Normal``, ``Uniform``,
``XavierUniform``, ``KaimingUniform``).

An initializer is a callable ``(shape, dtype, generator, device) ->
tensor`` that draws from the explicit ``torch.Generator`` it is given
(``None``: torch's default generator of the device). The distributions
are JAX's; the bits are not (threefry and Philox differ)."""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierUniform",
           "KaimingUniform", "calculate_gain", "convert_dtype"]

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


def calculate_gain(nonlinearity: str, param=None) -> float:
    table = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return table.get(nonlinearity, 1.0)


def _uniform(shape, dtype, generator, device, low, high):
    t = torch.empty(tuple(shape), dtype=convert_dtype(dtype), device=device)
    return t.uniform_(low, high, generator=generator)


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


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator=None, device=None):
        return _uniform(shape, dtype, generator, device, self.low,
                        self.high)


class XavierUniform(Initializer):
    def __call__(self, shape, dtype, generator=None, device=None):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, generator, device, -limit, limit)


class KaimingUniform(Initializer):
    """U(-gain * sqrt(3 / fan_in), +...), the gain of ``nonlinearity``
    at ``negative_slope`` (the conv layers' default: leaky_relu at 0,
    so sqrt(6 / fan_in))."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def __call__(self, shape, dtype, generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        limit = self.gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, generator, device, -limit, limit)
