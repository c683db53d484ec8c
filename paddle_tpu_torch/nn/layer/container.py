"""``Sequential`` and ``LayerList``. Counterpart:
``paddle_tpu/nn/layer/container.py`` (``Sequential`` :14-42,
``LayerList`` :45-84).

PyTorch's containers are JAX's: children are named "0", "1", ... in
order (or by an ``OrderedDict``'s keys), so parameter names equal the
JAX layers' ``named_parameters()`` names, e.g. ``mlp.0.weight``;
``Sequential[i]`` is the i-th child (negative from the end) and a slice
a new ``Sequential``; a ``LayerList`` has no forward."""
from __future__ import annotations

from torch import nn

__all__ = ["Sequential", "LayerList"]

Sequential = nn.Sequential
LayerList = nn.ModuleList
