"""``paddle_tpu_torch.distributed``: the ring-attention slice of
``paddle_tpu/distributed``. ``ProcessMesh`` places one torch device per
process id; ``fleet.init`` builds the hybrid mesh (only its sep axis is
placed); ``ring_attention`` runs zigzag ring attention over a mesh axis,
single-controller, as JAX's does."""
from . import fleet  # noqa: F401
from .mesh import ProcessMesh  # noqa: F401
from .ring_attention import (inverse_zigzag_indices,  # noqa: F401
                             ring_attention, ring_attention_local,
                             zigzag_indices)

__all__ = ["ProcessMesh", "fleet", "ring_attention", "ring_attention_local",
           "zigzag_indices", "inverse_zigzag_indices"]
