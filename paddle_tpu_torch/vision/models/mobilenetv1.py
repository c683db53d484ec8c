"""MobileNetV1. Counterpart: ``paddle_tpu/vision/models/mobilenetv1.py``:
13 depthwise-separable blocks (a 3 x 3 conv with groups == channels,
then a 1 x 1 conv, each with BatchNorm and ReLU), widths times
``scale``."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, ReLU,
                   Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]

# in, out1, out2, groups, stride
_CFG = [
    (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
    (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
    (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
    (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
    (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
    (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
    (1024, 1024, 1024, 1024, 1),
]


class ConvBNLayer(nn.Module):
    def __init__(self, in_c, out_c, kernel, stride, padding, groups=1,
                 generator=None, device=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, kernel, stride=stride,
                           padding=padding, groups=groups, bias_attr=False,
                           generator=generator, device=device)
        self.bn = BatchNorm2D(out_c, device=device)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dw = ConvBNLayer(int(in_c * scale), int(out_c1 * scale), 3,
                              stride, 1, groups=int(num_groups * scale), **kw)
        self.pw = ConvBNLayer(int(out_c1 * scale), int(out_c2 * scale),
                              1, 1, 0, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(ZooModel):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 seed: int = 0, device=None):
        super().__init__()
        kw, _ = init(seed, device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1, **kw)
        self.blocks = Sequential(*[
            DepthwiseSeparable(i, o1, o2, g, s, scale, **kw)
            for (i, o1, o2, g, s) in _CFG])
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(int(1024 * scale), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
