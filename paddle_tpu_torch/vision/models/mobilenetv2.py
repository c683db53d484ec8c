"""MobileNetV2. Counterpart: ``paddle_tpu/vision/models/mobilenetv2.py``:
inverted residuals (1 x 1 expansion, 3 x 3 depthwise, 1 x 1 projection,
ReLU6), widths ``make_divisible(c * scale)``, Dropout(0.2) before the
fc."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   ReLU6, Sequential)
from ._utils import ZooModel, init, make_divisible, no_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]

# t, c, n, s
_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class ConvBNReLU(Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 generator=None, device=None):
        super().__init__(
            Conv2D(in_c, out_c, kernel, stride=stride,
                   padding=(kernel - 1) // 2, groups=groups,
                   bias_attr=False, generator=generator, device=device),
            BatchNorm2D(out_c, device=device), ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, **kw))
        layers += [
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, **kw),
            Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            BatchNorm2D(oup, device=device),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(ZooModel):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 seed: int = 0, device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = make_divisible(32 * scale)
        self.last_channel = make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, **kw)]
        for t, c, n, s in _CFG:
            out_c = make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, **kw))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel=1, **kw))
        self.features = Sequential(*features)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2, generator=dgen),
                Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
