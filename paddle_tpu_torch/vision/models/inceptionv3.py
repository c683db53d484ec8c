"""InceptionV3. Counterpart: ``paddle_tpu/vision/models/inceptionv3.py``:
the stem, InceptionA x 3, B, C x 4, D and E x 2 of conv-BatchNorm-ReLU
units (``ConvBN``), Dropout(0.5) before the fc. It has no auxiliary
head, unlike torchvision's; inputs of 75 x 75 or more."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, Linear, MaxPool2D, ReLU, Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["InceptionV3", "inception_v3"]


class ConvBN(Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0,
                 generator=None, device=None):
        super().__init__(
            Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                   bias_attr=False, generator=generator, device=device),
            BatchNorm2D(out_c, device=device), ReLU())


class InceptionA(nn.Module):
    def __init__(self, in_c, pool_features, **kw):
        super().__init__()
        self.b1x1 = ConvBN(in_c, 64, 1, **kw)
        self.b5x5 = Sequential(ConvBN(in_c, 48, 1, **kw),
                               ConvBN(48, 64, 5, padding=2, **kw))
        self.b3x3dbl = Sequential(ConvBN(in_c, 64, 1, **kw),
                                  ConvBN(64, 96, 3, padding=1, **kw),
                                  ConvBN(96, 96, 3, padding=1, **kw))
        self.bpool = Sequential(AvgPool2D(3, 1, padding=1),
                                ConvBN(in_c, pool_features, 1, **kw))

    def forward(self, x):
        return torch.cat([self.b1x1(x), self.b5x5(x), self.b3x3dbl(x),
                          self.bpool(x)], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3x3 = ConvBN(in_c, 384, 3, stride=2, **kw)
        self.b3x3dbl = Sequential(ConvBN(in_c, 64, 1, **kw),
                                  ConvBN(64, 96, 3, padding=1, **kw),
                                  ConvBN(96, 96, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3x3(x), self.b3x3dbl(x), self.pool(x)],
                         dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_c, c7, **kw):
        super().__init__()
        self.b1x1 = ConvBN(in_c, 192, 1, **kw)
        self.b7x7 = Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b7x7dbl = Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.bpool = Sequential(AvgPool2D(3, 1, padding=1),
                                ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        return torch.cat([self.b1x1(x), self.b7x7(x), self.b7x7dbl(x),
                          self.bpool(x)], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3x3 = Sequential(ConvBN(in_c, 192, 1, **kw),
                               ConvBN(192, 320, 3, stride=2, **kw))
        self.b7x7x3 = Sequential(
            ConvBN(in_c, 192, 1, **kw),
            ConvBN(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBN(192, 192, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3x3(x), self.b7x7x3(x), self.pool(x)],
                         dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b1x1 = ConvBN(in_c, 320, 1, **kw)
        self.b3x3_1 = ConvBN(in_c, 384, 1, **kw)
        self.b3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3x3dbl_1 = Sequential(ConvBN(in_c, 448, 1, **kw),
                                    ConvBN(448, 384, 3, padding=1, **kw))
        self.b3x3dbl_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3x3dbl_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bpool = Sequential(AvgPool2D(3, 1, padding=1),
                                ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], dim=1)
        bd = self.b3x3dbl_1(x)
        bd = torch.cat([self.b3x3dbl_2a(bd), self.b3x3dbl_2b(bd)], dim=1)
        return torch.cat([self.b1x1(x), b3, bd, self.bpool(x)], dim=1)


class InceptionV3(ZooModel):
    def __init__(self, num_classes=1000, with_pool=True, seed: int = 0,
                 device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            ConvBN(3, 32, 3, stride=2, **kw), ConvBN(32, 32, 3, **kw),
            ConvBN(32, 64, 3, padding=1, **kw), MaxPool2D(3, 2),
            ConvBN(64, 80, 1, **kw), ConvBN(80, 192, 3, **kw),
            MaxPool2D(3, 2))
        self.blocks = Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = Dropout(0.5, generator=dgen)
            self.fc = Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
