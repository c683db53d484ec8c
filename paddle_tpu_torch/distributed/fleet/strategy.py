"""``DistributedStrategy``. Counterpart:
``paddle_tpu/distributed/fleet/strategy.py``.

Only ``hybrid_configs`` is ported: JAX's defaults and key order
(:22-23), assignment merging into the current dict, and a loud
``ValueError`` on an unknown key. Setting any other knob of JAX's
strategy raises ``NotImplementedError`` naming its ROADMAP item; an
unknown name raises ``AttributeError``, so a typo is never a silent
no-op.
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}

# JAX's other knobs, each with the ROADMAP queue 1 item that ports it
# (recompute's only reader in JAX is the pipeline, item 10; the model's
# own recompute is LlamaConfig.use_recompute)
_UNPORTED = {
    "recompute": "10", "recompute_configs": "10",
    "amp": "10", "amp_configs": "10", "sharding": "10",
    "sharding_configs": "10", "pipeline": "10", "pipeline_configs": "10",
    "gradient_merge": "10", "gradient_merge_configs": "10",
    "find_unused_parameters": "10", "fuse_grad_size_in_MB": "10",
}


class DistributedStrategy:
    def __init__(self):
        object.__setattr__(self, "hybrid_configs", dict(_DEFAULT_HYBRID))

    def __setattr__(self, name, value):
        if name in _UNPORTED:
            raise NotImplementedError(
                f"DistributedStrategy.{name} is not ported yet (ROADMAP "
                f"queue 1, item {_UNPORTED[name]})")
        if name != "hybrid_configs":
            raise AttributeError(
                f"DistributedStrategy has no knob {name!r}; the port "
                f"knows hybrid_configs")
        if not isinstance(value, dict):
            raise TypeError("hybrid_configs takes a dict")
        unknown = set(value) - set(_DEFAULT_HYBRID)
        if unknown:
            raise ValueError(
                f"unknown hybrid_configs key(s) {sorted(unknown)}; "
                f"known: {sorted(_DEFAULT_HYBRID)}")
        merged: Dict[str, Any] = dict(self.hybrid_configs)
        merged.update(value)
        object.__setattr__(self, name, merged)

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"
