"""``HybridCommunicateGroup``: the hybrid-parallel mesh and paddle's
group-query API. Counterpart:
``paddle_tpu/distributed/fleet/topology.py:43-141``.

The axis order is JAX's, outer to inner: dp, pp, sharding, sep, mp. The
number of devices is the length of ``devices`` (default: every visible
card) where JAX counts ``jax.devices()``, and dp is filled in from it as
JAX fills it. The program is single-controller (``global_rank`` 0).

Only the sep axis is placed: a degree above 1 on any other axis,
an auto-filled dp included, raises ``NotImplementedError`` (tensor
parallelism is ROADMAP queue 1 item 5; dp, pp and sharding item 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..mesh import ProcessMesh

__all__ = ["HybridCommunicateGroup", "hybrid_degrees"]

_AXIS_ORDER = ["dp", "pp", "sharding", "sep", "mp"]
_UNPORTED_AXIS = {"mp": "5", "dp": "10", "pp": "10", "sharding": "10"}


def hybrid_degrees(n: int, dp_degree=1, mp_degree=1, pp_degree=1,
                   sharding_degree=1, sep_degree=1) -> Dict[str, int]:
    """The degree of each axis over n devices, dp filled in as JAX
    fills it (topology.py:52-66): when the product of the degrees is
    not n, dp becomes n over the product of the other axes."""
    degrees = {"dp": dp_degree, "pp": pp_degree,
               "sharding": sharding_degree, "sep": sep_degree,
               "mp": mp_degree}
    if int(np.prod(list(degrees.values()))) != n:
        other = int(np.prod([degrees[a] for a in _AXIS_ORDER if a != "dp"]))
        if n % other:
            raise ValueError(f"hybrid degrees {degrees} don't divide "
                             f"device count {n}")
        degrees["dp"] = n // other
    return degrees


def _visible_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "HybridCommunicateGroup: no CUDA device; pass devices=[...] "
            "(e.g. ['cpu'] * sep_degree) to place the ranks")
    return [torch.device("cuda", i) for i in range(n)]


class HybridCommunicateGroup:
    def __init__(self, *, dp_degree=1, mp_degree=1,
                 pp_degree=1, sharding_degree=1, sep_degree=1,
                 devices: Optional[Sequence] = None):
        devices = _visible_cards() if devices is None else list(devices)
        degrees = hybrid_degrees(len(devices), dp_degree, mp_degree,
                                 pp_degree, sharding_degree, sep_degree)
        unported = {a: d for a, d in degrees.items()
                    if d > 1 and a in _UNPORTED_AXIS}
        if unported:
            items = sorted({_UNPORTED_AXIS[a] for a in unported})
            raise NotImplementedError(
                f"hybrid degrees {degrees}: only the sep axis is placed; "
                f"{sorted(unported)} > 1 is not ported yet (ROADMAP "
                f"queue 1, item {' and '.join(items)}: tensor parallelism "
                f"is item 5, dp / pp / sharding item 10)")
        self._degrees = degrees
        shape = tuple(degrees[a] for a in _AXIS_ORDER)
        self._mesh = ProcessMesh(np.arange(len(devices)).reshape(shape),
                                 _AXIS_ORDER, devices=devices)
        self.global_rank = 0  # single-controller

    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    def get_parallel_mode(self):
        if self._degrees["pp"] > 1:
            return "pipeline"
        if self._degrees["sharding"] > 1:
            return "sharding_parallel"
        if self._degrees["mp"] > 1:
            return "tensor_parallel"
        return "data_parallel"

    def get_data_parallel_world_size(self):
        return self._degrees["dp"]

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    def topology(self):
        return dict(self._degrees)
