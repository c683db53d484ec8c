"""GoogLeNet (Inception v1). Counterpart:
``paddle_tpu/vision/models/googlenet.py``: nine Inception modules,
two auxiliary heads (an adaptive 4 x 4 pool, a 1 x 1 conv, fc 1024,
Dropout(0.7), fc) after inc4a and inc4d, Dropout(0.4) before the fc.
``forward`` returns ``(logits, aux1, aux2)``; the aux heads run only in
training (``None`` in eval or without a head, :85-99)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D,
                   ReLU, Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class ConvLayer(Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0,
                 generator=None, device=None):
        super().__init__(
            Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                   generator=generator, device=device),
            ReLU())


class Inception(nn.Module):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.branch1 = ConvLayer(in_c, c1, 1, **kw)
        self.branch2 = Sequential(ConvLayer(in_c, c3r, 1, **kw),
                                  ConvLayer(c3r, c3, 3, padding=1, **kw))
        self.branch3 = Sequential(ConvLayer(in_c, c5r, 1, **kw),
                                  ConvLayer(c5r, c5, 5, padding=2, **kw))
        self.branch4 = Sequential(MaxPool2D(3, 1, padding=1),
                                  ConvLayer(in_c, proj, 1, **kw))

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x),
                          self.branch3(x), self.branch4(x)], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, in_c, num_classes, generator=None, device=None,
                 dropout_generator=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pool = AdaptiveAvgPool2D((4, 4))
        self.conv = ConvLayer(in_c, 128, 1, **kw)
        self.fc1 = Linear(128 * 4 * 4, 1024, **kw)
        self.relu = ReLU()
        self.drop = Dropout(0.7, generator=dropout_generator)
        self.fc2 = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        x = self.drop(self.relu(self.fc1(x)))
        return self.fc2(x)


class GoogLeNet(ZooModel):
    def __init__(self, num_classes=1000, with_pool=True, seed: int = 0,
                 device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            ConvLayer(3, 64, 7, stride=2, padding=3, **kw),
            MaxPool2D(3, 2, padding=1),
            ConvLayer(64, 64, 1, **kw),
            ConvLayer(64, 192, 3, padding=1, **kw),
            MaxPool2D(3, 2, padding=1))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = MaxPool2D(3, 2, padding=1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = MaxPool2D(3, 2, padding=1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.drop = Dropout(0.4, generator=dgen)
            self.fc = Linear(1024, num_classes, **kw)
            self.aux1 = InceptionAux(512, num_classes,
                                     dropout_generator=dgen, **kw)
            self.aux2 = InceptionAux(528, num_classes,
                                     dropout_generator=dgen, **kw)

    def forward(self, x):
        x = self.inc3b(self.inc3a(self.stem(x)))
        x = self.inc4a(self.pool3(x))
        heads = self.num_classes > 0 and self.training
        aux1 = self.aux1(x) if heads else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if heads else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
