"""incubate.distributed.models.moe. Counterpart:
``paddle_tpu/incubate/distributed/models/moe``: the MoE layer lives in
``nn`` (``nn.MoELayer``); this namespace carries the MoE-aware
global-norm gradient clip."""
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401

__all__ = ["ClipGradForMOEByGlobalNorm"]
