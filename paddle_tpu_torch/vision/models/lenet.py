"""LeNet. Counterpart: ``paddle_tpu/vision/models/lenet.py``. For 1 x 28
x 28 inputs (its fc takes 16 x 5 x 5); no activation between the fc
layers, as in JAX."""
from __future__ import annotations

from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ._utils import ZooModel, init

__all__ = ["LeNet"]


class LeNet(ZooModel):
    def __init__(self, num_classes=10, seed: int = 0, device=None):
        super().__init__()
        kw, _ = init(seed, device)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **kw),
                                 Linear(120, 84, **kw),
                                 Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
