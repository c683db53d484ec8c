"""``TrainStep``: one training step as one call. Counterpart:
``paddle_tpu/jit/__init__.py:520-669``.

JAX compiles forward, backward and the optimizer update into one XLA
program; PyTorch runs eagerly, so the port's step is the same sequence
of calls: forward, ``loss_fn(out, *labels)`` in float32, backward, and
the optimizer's in-place ``update`` on the gradients. Gradient merge and
a device mesh are not ported yet (they raise)."""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["TrainStep"]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class TrainStep:
    """Usage:
        step = TrainStep(model, loss_fn, optimizer)   # loss_fn(out, *labels)
        loss = step(x, y)                             # float32 loss tensor
    """

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 gradient_merge: int = 1):
        if mesh is not None:
            raise NotImplementedError(
                "TrainStep(mesh=...) is not ported yet (ROADMAP queue 1, "
                "item 10)")
        if gradient_merge != 1:
            raise NotImplementedError(
                "TrainStep(gradient_merge=...) is not ported yet (ROADMAP "
                "queue 1, item 10)")
        opt_ids = {id(p) for p in optimizer._parameter_list}
        held = getattr(model, "shard_parameters", model.parameters)()
        if not all(id(p) in opt_ids for p in held if p.requires_grad):
            raise ValueError("optimizer parameters must come from the model")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, inputs, labels):
        """inputs / labels: a tensor or a tuple of tensors. The model is
        called as model(*inputs), the loss as loss_fn(out, *labels).
        Returns the step's loss (float32, detached)."""
        opt = self.optimizer
        opt.clear_grad()
        out = self.model(*_as_tuple(inputs))
        loss = self.loss_fn(out, *_as_tuple(labels)).float()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
