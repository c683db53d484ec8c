"""``paddle_tpu_torch.distributed.fleet``: the hybrid-parallel entry.
Counterpart: ``paddle_tpu/distributed/fleet/__init__.py:48-63``.

``init`` reads ``strategy.hybrid_configs`` and builds the
``HybridCommunicateGroup`` that ``get_hybrid_communicate_group``
returns, as JAX's does; it takes ``devices`` (one torch device per
rank) where JAX counts ``jax.devices()``. ``distributed_model`` and
``distributed_optimizer`` raise: their sharding recipes are ROADMAP
queue 1 item 10.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .strategy import DistributedStrategy
from .topology import HybridCommunicateGroup

__all__ = ["init", "fleet", "DistributedStrategy", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer"]

_hcg: Optional[HybridCommunicateGroup] = None
_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         devices: Optional[Sequence] = None):
    """Build the mesh from ``strategy.hybrid_configs`` over ``devices``
    (default: every visible card)."""
    global _hcg, _strategy
    _strategy = strategy or DistributedStrategy()
    hc = _strategy.hybrid_configs
    _hcg = HybridCommunicateGroup(
        dp_degree=hc["dp_degree"], mp_degree=hc["mp_degree"],
        pp_degree=hc["pp_degree"], sharding_degree=hc["sharding_degree"],
        sep_degree=hc["sep_degree"], devices=devices)
    return _hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


def distributed_model(model):
    raise NotImplementedError(
        "fleet.distributed_model is not ported yet (ROADMAP queue 1, "
        "item 10)")


def distributed_optimizer(optimizer, strategy=None):
    raise NotImplementedError(
        "fleet.distributed_optimizer is not ported yet (ROADMAP queue 1, "
        "item 10)")


class _FleetNamespace:
    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)


fleet = _FleetNamespace()
