"""Gradient clipping. Counterpart: ``paddle_tpu/optimizer/clip.py``
(``ClipGradByValue`` :18, ``ClipGradByNorm`` :28, ``ClipGradByGlobalNorm``
:44).

Each clip takes the gradient list of an optimizer (``None`` entries pass
through) and follows JAX's arithmetic step for step: norms in float32,
the clipped gradient ``(g.float() * scale).to(g.dtype)``. ``apply(grads)``
returns the clipped list; the optimizer reads the same arithmetic one
gradient at a time (``_plan``), so a clipped copy of every gradient never
lives at once (at full width that copy would be as large as the
gradients themselves).

``_plan(grads, groups)`` numbers, in ``groups[i]``, the logical
parameter that gradient i belongs to: a tensor-parallel model's
optimizer steps each logical parameter as its shards
(``distributed/fleet/mpu.py``), and ``ClipGradByNorm`` norms a logical
parameter over all of them. ``apply`` gives every gradient its own
group. The shards may lie on several devices: norms are summed on the
first gradient's device and each scale is applied on its gradient's.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def _plan(self, grads, groups) -> Callable:
        """A function of (gradient, its index i) giving the gradient
        clipped (never called with None); whatever the clip needs from
        the whole list is computed here. ``groups[i]`` numbers the
        logical parameter that gradient i is a shard of."""
        raise NotImplementedError

    def apply(self, grads) -> List[Optional[torch.Tensor]]:
        """grads: list of tensors (None allowed) -> the clipped list."""
        one = self._plan(grads, list(range(len(grads))))
        return [None if g is None else one(g, i) for i, g in enumerate(grads)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _plan(self, grads, groups):
        return lambda g, i: torch.clamp(g, self.min, self.max)


def _sq_norm(g):
    return g.float().square().sum()


def _first_device(grads):
    return next((g.device for g in grads if g is not None), None)


class ClipGradByNorm(ClipGradBase):
    """Each logical parameter's norm, over all of its shards."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _plan(self, grads, groups):
        dev, sq = _first_device(grads), {}
        for g, k in zip(grads, groups):
            if g is not None:
                n = _sq_norm(g).to(dev)
                sq[k] = n if k not in sq else sq[k] + n

        def one(g, i):
            norm = sq[groups[i]].sqrt()
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            return (g.float() * scale.to(g.device)).to(g.dtype)
        return one


class ClipGradByGlobalNorm(ClipGradBase):
    """One norm over every gradient: ``scale = clip_norm / max(norm,
    clip_norm)``. ``last_global_norm`` and ``last_scale`` hold the last
    planned clip's norm and scale (float32 tensors on the first
    gradient's device, None before the first), for a caller to log:
    reading one syncs the host with the card."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.last_global_norm: Optional[torch.Tensor] = None
        self.last_scale: Optional[torch.Tensor] = None

    def _plan(self, grads, groups):
        dev = _first_device(grads)
        sq = [_sq_norm(g).to(dev) for g in grads if g is not None]
        if not sq:
            return lambda g, i: g
        global_norm = torch.stack(sq).sum().sqrt()
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        self.last_global_norm, self.last_scale = global_norm, scale
        return lambda g, i: (g.float() * scale.to(g.device)).to(g.dtype)
