"""AlexNet. Counterpart: ``paddle_tpu/vision/models/alexnet.py``: an
adaptive 6 x 6 pool before the classifier, Dropout(``dropout``) before
its first two products."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D,
                   ReLU, Sequential)
from ._utils import ZooModel, init, no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(ZooModel):
    def __init__(self, num_classes=1000, dropout=0.5, seed: int = 0,
                 device=None, generator=None):
        super().__init__()
        kw, dgen = init(seed, device, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, **kw), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
            Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
            Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout, generator=dgen),
                Linear(256 * 6 * 6, 4096, **kw), ReLU(),
                Dropout(dropout, generator=dgen),
                Linear(4096, 4096, **kw), ReLU(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
