"""Activation layers. Counterpart: ``paddle_tpu/nn/layer/activation.py``
(``_simple`` :15-33, the table :36-47): layers over the functionals
with JAX's constructor arguments (GELU's ``approximate``,
Hardsigmoid's ``slope`` and ``offset``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "Silu", "SiLU", "Swish", "Sigmoid", "GELU",
           "Hardsigmoid", "Hardswish"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return F.relu6(x)


class Silu(nn.Module):
    def forward(self, x):
        return F.silu(x)


SiLU = Silu


class Swish(nn.Module):
    def forward(self, x):
        return F.swish(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return F.sigmoid(x)


class Hardswish(nn.Module):
    def forward(self, x):
        return F.hardswish(x)


class GELU(nn.Module):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)

    def extra_repr(self):
        return f"approximate={self.approximate}"


class Hardsigmoid(nn.Module):
    def __init__(self, slope=0.1666667, offset=0.5):
        super().__init__()
        self.slope, self.offset = slope, offset

    def forward(self, x):
        return F.hardsigmoid(x, self.slope, self.offset)

    def extra_repr(self):
        return f"slope={self.slope}, offset={self.offset}"
