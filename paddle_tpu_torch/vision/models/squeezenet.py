"""SqueezeNet 1.0 and 1.1. Counterpart:
``paddle_tpu/vision/models/squeezenet.py``: Fire modules (a 1 x 1
squeeze, then 1 x 1 and 3 x 3 expands concatenated), a classifier of
Dropout(0.5), a 1 x 1 conv and ReLU before the pool; the output is
flattened whatever ``num_classes`` and ``with_pool`` are."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU,
                   Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Module):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.squeeze = Conv2D(in_c, squeeze_c, 1, **kw)
        self.relu = ReLU()
        self.expand1 = Conv2D(squeeze_c, e1_c, 1, **kw)
        self.expand3 = Conv2D(squeeze_c, e3_c, 3, padding=1, **kw)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(x)),
                          self.relu(self.expand3(x))], dim=1)


class SqueezeNet(ZooModel):
    def __init__(self, version='1.0', num_classes=1000, with_pool=True,
                 seed: int = 0, device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == '1.0':
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **kw), ReLU(), MaxPool2D(3, 2),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw), MaxPool2D(3, 2),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                MaxPool2D(3, 2), Fire(512, 64, 256, 256, **kw))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **kw), ReLU(), MaxPool2D(3, 2),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                MaxPool2D(3, 2), Fire(128, 32, 128, 128, **kw),
                Fire(256, 32, 128, 128, **kw), MaxPool2D(3, 2),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5, generator=dgen),
                Conv2D(512, num_classes, 1, **kw), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet('1.0', **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet('1.1', **kwargs)
