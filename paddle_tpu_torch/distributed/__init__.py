"""``paddle_tpu_torch.distributed``: the ring-attention and tensor-parallel
slices of ``paddle_tpu/distributed``. ``ProcessMesh`` places one torch
device per process id; ``fleet.init`` builds the hybrid mesh (its sep or
its mp axis is placed), and ``fleet`` holds training's Megatron layers
and sequence parallelism; ``ring_attention`` runs zigzag ring attention
over a mesh axis, single-controller, as JAX's does; ``spec_layout`` is
the serving placement table and ``collective`` the tp collectives."""
from . import fleet  # noqa: F401
from .mesh import ProcessMesh  # noqa: F401
from .ring_attention import (inverse_zigzag_indices,  # noqa: F401
                             ring_attention, ring_attention_local,
                             zigzag_indices)

__all__ = ["ProcessMesh", "fleet", "ring_attention", "ring_attention_local",
           "zigzag_indices", "inverse_zigzag_indices"]
