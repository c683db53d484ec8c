"""Vision models. Counterpart: ``paddle_tpu/vision``; of it, only the
ResNet family of ``models`` is ported (``vision/transforms``,
``vision/datasets`` and the other models are not)."""
from . import models  # noqa: F401

__all__ = ["models"]
