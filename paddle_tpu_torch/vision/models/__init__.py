"""The model zoo. Counterpart: ``paddle_tpu/vision/models/__init__.py``:
every class and constructor it exports. Each model takes ``seed=`` and
``device=`` (``None``: cuda), and those with Dropout ``generator=``
(``_utils.init``); ``pretrained=True`` raises ``NotImplementedError``."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (  # noqa: F401
    MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large,
    mobilenet_v3_small,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
)

__all__ = list(_resnet_all) + [
    "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
    "vgg19", "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
    "mobilenet_v3_small", "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish"]
