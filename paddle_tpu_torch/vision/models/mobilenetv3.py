"""MobileNetV3 small and large. Counterpart:
``paddle_tpu/vision/models/mobilenetv3.py``: inverted residuals with
Hardswish or ReLU, a squeeze-excitation gate (average pool, two 1 x 1
convs, Hardsigmoid, and its broadcast product, :13-24) where the table
says so, widths ``make_divisible(c * scale)``, a Hardswish fc of
``last_channel`` and Dropout(0.2) before the last fc."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   Hardsigmoid, Hardswish, Linear, ReLU, Sequential)
from ._utils import ZooModel, init, make_divisible, no_pretrained

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]

# kernel, exp, out, use_se, use_hs, stride
_SMALL_CFG = [
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]

_LARGE_CFG = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]


class SqueezeExcitation(nn.Module):
    def __init__(self, input_c, squeeze_c, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(input_c, squeeze_c, 1, **kw)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_c, input_c, 1, **kw)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class ConvNormActivation(Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 activation=ReLU, generator=None, device=None):
        layers = [Conv2D(in_c, out_c, kernel, stride=stride,
                         padding=(kernel - 1) // 2, groups=groups,
                         bias_attr=False, generator=generator,
                         device=device),
                  BatchNorm2D(out_c, device=device)]
        if activation is not None:
            layers.append(activation())
        super().__init__(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, use_hs,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.use_res = stride == 1 and in_c == out_c
        act = Hardswish if use_hs else ReLU
        layers = []
        if exp_c != in_c:
            layers.append(ConvNormActivation(in_c, exp_c, 1, activation=act,
                                             **kw))
        layers.append(ConvNormActivation(exp_c, exp_c, kernel, stride,
                                         groups=exp_c, activation=act, **kw))
        if use_se:
            layers.append(SqueezeExcitation(exp_c,
                                            make_divisible(exp_c // 4), **kw))
        layers.append(ConvNormActivation(exp_c, out_c, 1, activation=None,
                                         **kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(ZooModel):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, seed: int = 0, device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        first_c = make_divisible(16 * scale)
        layers = [ConvNormActivation(3, first_c, 3, 2, activation=Hardswish,
                                     **kw)]
        in_c = first_c
        for k, exp, out, se, hs, s in cfg:
            exp_c = make_divisible(exp * scale)
            out_c = make_divisible(out * scale)
            layers.append(InvertedResidual(in_c, exp_c, out_c, k, s, se, hs,
                                           **kw))
            in_c = out_c
        last_conv = make_divisible(6 * in_c)
        layers.append(ConvNormActivation(in_c, last_conv, 1,
                                         activation=Hardswish, **kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_conv, last_channel, **kw), Hardswish(),
                Dropout(0.2, generator=dgen),
                Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_SMALL_CFG, 1024, scale, num_classes, with_pool,
                         **kwargs)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_LARGE_CFG, 1280, scale, num_classes, with_pool,
                         **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
