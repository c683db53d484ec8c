"""Vision models. Counterpart: ``paddle_tpu/vision``; of it ``models``
is ported, the whole zoo (``vision/transforms`` and ``vision/datasets``
are not)."""
from . import models  # noqa: F401

__all__ = ["models"]
