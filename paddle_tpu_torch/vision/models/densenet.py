"""DenseNet-121 / 161 / 169 / 201 / 264. Counterpart:
``paddle_tpu/vision/models/densenet.py``: ``_CFG`` (stem width, growth
rate, layers a block), dense layers of BatchNorm-ReLU-1 x 1 conv
(``bn_size`` x growth) and BatchNorm-ReLU-3 x 3 conv, concatenated onto
their input, an optional Dropout after each, transitions halving the
channels under a 2 x 2 average pool."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, LayerList, Linear, MaxPool2D, ReLU, Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseLayer(nn.Module):
    def __init__(self, in_c, growth_rate, bn_size, dropout=0.0,
                 generator=None, device=None, dropout_generator=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = BatchNorm2D(in_c, device=device)
        self.relu = ReLU()
        self.conv1 = Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False,
                            **kw)
        self.norm2 = BatchNorm2D(bn_size * growth_rate, device=device)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias_attr=False, **kw)
        self.dropout = Dropout(dropout, generator=dropout_generator) \
            if dropout > 0 else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, num_layers, in_c, growth_rate, bn_size, dropout=0.0,
                 **kw):
        super().__init__()
        self.layers = LayerList([
            DenseLayer(in_c + i * growth_rate, growth_rate, bn_size, dropout,
                       **kw)
            for i in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Transition(Sequential):
    def __init__(self, in_c, out_c, generator=None, device=None):
        super().__init__(
            BatchNorm2D(in_c, device=device), ReLU(),
            Conv2D(in_c, out_c, 1, bias_attr=False, generator=generator,
                   device=device),
            AvgPool2D(2, 2))


class DenseNet(ZooModel):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, seed: int = 0, device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        num_init, growth_rate, block_cfg = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv = Sequential(
            Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False,
                   **kw),
            BatchNorm2D(num_init, device=kw["device"]), ReLU(),
            MaxPool2D(3, 2, padding=1))
        blocks = []
        ch = num_init
        for i, n in enumerate(block_cfg):
            blocks.append(DenseBlock(n, ch, growth_rate, bn_size, dropout,
                                     dropout_generator=dgen, **kw))
            ch = ch + n * growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(Transition(ch, ch // 2, **kw))
                ch = ch // 2
        self.blocks = Sequential(*blocks)
        self.norm = BatchNorm2D(ch, device=kw["device"])
        self.relu = ReLU()
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.relu(self.norm(self.blocks(self.conv(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
