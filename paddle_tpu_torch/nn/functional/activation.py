"""``relu`` and ``gelu``. Counterparts:
``paddle_tpu/nn/functional/activation.py``.

- ``relu`` (:21, ``jax.nn.relu``): its gradient at exactly 0 is 0, as
  torch's is.
- ``gelu`` (:48, ``jax.nn.gelu``): the exact form ``0.5 x erfc(-x /
  sqrt 2)`` by default, the tanh form with ``approximate=True``, each
  computed in x's dtype with its constant rounded to that dtype, as
  JAX's are. The constants are Python numbers (no host-to-device copy),
  so a CUDA graph can capture the call."""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["relu", "gelu"]


@functools.lru_cache(maxsize=64)
def _const(value: float, dtype) -> float:
    """value rounded to dtype, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def relu(x):
    return torch.relu(x)


def gelu(x, approximate: bool = False):
    if approximate:
        c = _const(math.sqrt(2.0 / math.pi), x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    return 0.5 * x * torch.erfc(-x * _const(math.sqrt(0.5), x.dtype))
