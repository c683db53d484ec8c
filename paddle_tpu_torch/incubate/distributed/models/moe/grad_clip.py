"""MoE-aware global-norm gradient clipping. Counterpart:
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``.

Paddle needs a clip of its own for MoE because under expert parallelism
each rank holds only its own experts' gradients, so the expert part of
the norm is summed over the moe group and the dense part is not. On one
controller every gradient is whole, and the norm over all of them,
expert or not, is the global norm: the clip is ``ClipGradByGlobalNorm``,
and ``is_expert_param_func`` and ``moe_group`` are kept for the
signature and for ``partition_norms``.
"""
from __future__ import annotations

import torch

from .....optimizer.clip import ClipGradByGlobalNorm, _sq_norm

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """(clip_norm, is_expert_param_func, moe_group, group_name), as
    Paddle's; ``is_expert_param_func(param) -> bool`` receives the
    parameter tensor."""

    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm=clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group

    def partition_norms(self, params, grads):
        """(expert_sq, dense_sq): the squared global norm split by
        ``is_expert_param_func`` (float32 tensors, summed in list order
        as JAX sums them)."""
        pred = self.is_expert_param_func or (lambda p: False)
        dev = next((g.device for g in grads if g is not None), "cpu")
        ex = dn = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params, grads):
            if g is None:
                continue
            sq = _sq_norm(g).to(dev)
            if pred(p):
                ex = ex + sq
            else:
                dn = dn + sq
        return ex, dn
