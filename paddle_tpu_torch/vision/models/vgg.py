"""VGG. Counterpart: ``paddle_tpu/vision/models/vgg.py`` (``_CFGS``,
``make_layers``, ``VGG``, ``vgg11`` / ``13`` / ``16`` / ``19`` with
``batch_norm=``). The classifier draws its weights after the features,
from the features' generator (``_vgg``), or from one seeded from
``seed`` when ``VGG`` is given features of the caller's."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   MaxPool2D, ReLU, Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    'A': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'B': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M',
          512, 512, 'M'],
    'D': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512,
          'M', 512, 512, 512, 'M'],
    'E': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
          512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'],
}


def make_layers(cfg, batch_norm=False, generator=None, device=None):
    layers = []
    in_c = 3
    for v in cfg:
        if v == 'M':
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1, generator=generator,
                                 device=device))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=device))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(ZooModel):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 seed: int = 0, device=None, generator=None,
                 init_generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        if init_generator is not None:
            kw["generator"] = init_generator
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(),
                Dropout(generator=dgen),
                Linear(4096, 4096, **kw), ReLU(), Dropout(generator=dgen),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained, seed=0, device=None, **kwargs):
    no_pretrained(pretrained)
    kw, _ = init(seed, device)
    return VGG(make_layers(_CFGS[cfg], batch_norm, **kw), seed=seed,
               device=kw["device"], init_generator=kw["generator"], **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('A', batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('B', batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('D', batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('E', batch_norm, pretrained, **kwargs)
