"""The model zoo's ported part. Counterpart:
``paddle_tpu/vision/models/__init__.py``: the ResNet family."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__  # noqa: F401
