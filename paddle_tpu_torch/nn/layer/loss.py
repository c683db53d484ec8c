"""``MSELoss``. Counterpart: ``paddle_tpu/nn/layer/loss.py:34-40``."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["MSELoss"]


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)
