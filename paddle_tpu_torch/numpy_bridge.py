"""numpy -> torch for weights carried from the JAX package."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch on ``device``. A bfloat16 array (numpy has no such
    dtype of its own; JAX hands out an extension dtype named
    "bfloat16") is carried bit for bit through a 16-bit integer view."""
    a = np.array(a)        # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)
