"""ShuffleNetV2. Counterpart: ``paddle_tpu/vision/models/shufflenetv2.py``:
units that split the channels in two (stride 1) or feed both branches
(stride 2), concatenate and shuffle them over 2 groups; ReLU or, in
``shufflenet_v2_swish``, Swish; the stage widths of each scale are
JAX's (its table inside ``ShuffleNetV2.__init__``, here ``_CHANNELS``)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                   MaxPool2D, ReLU, Sequential, Swish)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "shufflenet_v2_swish"]

_STAGE_REPEATS = [4, 8, 4]
_CHANNELS = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


class ConvBNReLU(Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, groups=1, act=True,
                 generator=None, device=None):
        layers = [Conv2D(in_c, out_c, kernel, stride=stride,
                         padding=kernel // 2, groups=groups,
                         bias_attr=False, generator=generator,
                         device=device),
                  BatchNorm2D(out_c, device=device)]
        if act:  # True / "relu": ReLU; "swish": Swish
            layers.append(Swish() if act == "swish" else ReLU())
        super().__init__(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, in_c, out_c, stride, act="relu", **kw):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = Sequential(
                ConvBNReLU(branch_c, branch_c, 1, act=act, **kw),
                ConvBNReLU(branch_c, branch_c, 3, stride, branch_c,
                           act=False, **kw),
                ConvBNReLU(branch_c, branch_c, 1, act=act, **kw))
        else:
            self.branch1 = Sequential(
                ConvBNReLU(in_c, in_c, 3, stride, in_c, act=False, **kw),
                ConvBNReLU(in_c, branch_c, 1, act=act, **kw))
            self.branch2 = Sequential(
                ConvBNReLU(in_c, branch_c, 1, act=act, **kw),
                ConvBNReLU(branch_c, branch_c, 3, stride, branch_c,
                           act=False, **kw),
                ConvBNReLU(branch_c, branch_c, 1, act=act, **kw))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(ZooModel):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, seed: int = 0, device=None):
        super().__init__()
        kw, _ = init(seed, device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        out_channels = _CHANNELS[scale]
        self.conv1 = ConvBNReLU(3, out_channels[0], 3, 2, act=act, **kw)
        self.maxpool = MaxPool2D(3, 2, padding=1)
        in_c = out_channels[0]
        stages = []
        for i, repeats in enumerate(_STAGE_REPEATS):
            out_c = out_channels[i + 1]
            blocks = [InvertedResidual(in_c, out_c, 2, act=act, **kw)]
            for _ in range(repeats - 1):
                blocks.append(InvertedResidual(out_c, out_c, 1, act=act,
                                               **kw))
            stages.append(Sequential(*blocks))
            in_c = out_c
        self.stages = Sequential(*stages)
        self.conv_last = ConvBNReLU(in_c, out_channels[-1], 1, act=act, **kw)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(out_channels[-1], num_classes, **kw)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(scale, pretrained, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained, act="swish", **kwargs)
