"""``RMSNorm``. Counterpart: ``paddle_tpu/nn/layer/norm.py:114-128``:
the gain takes the layer's dtype (the model's, e.g. bfloat16) and
starts at ones."""
from __future__ import annotations

from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(I.Constant(1.0)(
            (hidden_size,), dtype, None, resolve_device(device)))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
