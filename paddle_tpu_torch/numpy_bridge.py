"""numpy -> torch for weights carried from the JAX package."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "load_numpy_state"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch on ``device``. A bfloat16 array (numpy has no such
    dtype of its own; JAX hands out an extension dtype named
    "bfloat16") is carried bit for bit through a 16-bit integer view."""
    a = np.array(a)        # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def load_numpy_state(module: torch.nn.Module, state: dict):
    """Copy ``{name: np.ndarray}`` (a JAX model's ``named_parameters()``
    and ``named_buffers()`` as numpy) into ``module``'s parameters and
    buffers: every name must be present and no other, shapes and dtypes
    must be equal; bfloat16 arrays are carried bit for bit. The copy goes
    through ``load_state_dict``, so a module that holds a parameter in
    another form (a tp layer's shards) loads it its own way."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    missing = sorted(set(targets) - set(state))
    extra = sorted(set(state) - set(targets))
    if missing or extra:
        raise ValueError(f"load_numpy_state: missing {missing}, "
                         f"unexpected {extra}")
    tensors = {}
    for name, p in targets.items():
        t = tensor_from_numpy(state[name], p.device)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(
                f"load_numpy_state: {name} is {tuple(t.shape)} "
                f"{t.dtype}, the model holds {tuple(p.shape)} {p.dtype}")
        tensors[name] = t
    # strict=False: a weight tied under two names is loaded once, by the
    # name named_parameters() keeps
    module.load_state_dict(tensors, strict=False)
