"""Activations. Counterpart: ``paddle_tpu/nn/functional/activation.py``.

- ``relu`` (:21, ``jax.nn.relu``): its gradient at exactly 0 is 0, as
  torch's is.
- ``relu6`` (:32, ``jax.nn.relu6``): its gradient at 0 and at 6 is 0 in
  both packages, so ``torch.nn.functional.relu6`` serves.
- ``gelu`` (:48, ``jax.nn.gelu``): the exact form ``0.5 x erfc(-x /
  sqrt 2)`` by default, the tanh form with ``approximate=True``, each
  computed in x's dtype with its constant rounded to that dtype, as
  JAX's are.
- ``silu`` / ``swish`` (:54, :58; ``swish = silu`` as in JAX) and
  ``sigmoid`` (:61).
- ``hardsigmoid`` (:65) and ``hardswish`` (:69): JAX's formulas
  ``clip(slope x + offset, 0, 1)`` and ``x clip(x + 3, 0, 6) / 6`` in
  x's dtype, not torch's own: ``torch.nn.functional.hardsigmoid`` uses
  1/6 where JAX uses 0.1666667 (at x = -2.9999998 JAX gives 0, torch
  3.97e-8). The clip is ``minimum(maximum(., lo), hi)``, as
  ``jnp.clip`` is, so a tie at an edge gives each side half the
  gradient (hardswish's grad at x = 3 is 1.25, not ``torch.clamp``'s
  1.5).

The constants are Python numbers, and the clip bounds and divisors
device fills (no host-to-device copy), so a CUDA graph can capture every
call."""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["relu", "relu6", "gelu", "silu", "swish", "sigmoid",
           "hardsigmoid", "hardswish"]


@functools.lru_cache(maxsize=64)
def _const(value: float, dtype) -> float:
    """value rounded to dtype, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def _div(x, value):
    """x / value in x's dtype, value rounded to it as JAX's weak-typed
    scalar is: a true division on every device (CUDA turns a division by
    a Python number into a product with its reciprocal, one bit off)."""
    return x / torch.full((), _const(value, x.dtype), dtype=x.dtype,
                          device=x.device)


def _clip(x, lo, hi):
    """``jnp.clip``: maximum, then minimum, each tie split evenly in the
    backward."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.nn.functional.relu6(x)


def gelu(x, approximate: bool = False):
    if approximate:
        c = _const(math.sqrt(2.0 / math.pi), x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    return 0.5 * x * torch.erfc(-x * _const(math.sqrt(0.5), x.dtype))


def silu(x):
    return torch.nn.functional.silu(x)


swish = silu


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return _clip(x * _const(slope, x.dtype) + _const(offset, x.dtype),
                 0.0, 1.0)


def hardswish(x):
    return _div(x * _clip(x + 3.0, 0.0, 6.0), 6.0)
