"""``ReLU``, ``Silu`` / ``SiLU`` and ``GELU``. Counterpart:
``paddle_tpu/nn/layer/activation.py`` (``_simple`` :15-33, the table
:36-43): layers over the functionals, GELU's exact form by default and
the tanh form with ``approximate=True``."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "Silu", "SiLU", "GELU"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class Silu(nn.Module):
    def forward(self, x):
        return F.silu(x)


SiLU = Silu


class GELU(nn.Module):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)

    def extra_repr(self):
        return f"approximate={self.approximate}"
