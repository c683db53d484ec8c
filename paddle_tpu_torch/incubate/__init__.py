"""incubate — the experimental surface. Counterpart:
``paddle_tpu/incubate``; the port has its MoE training utilities only
(``incubate.distributed.models.moe``)."""
from . import distributed  # noqa: F401

__all__ = ["distributed"]
