"""What the zoo's models share. Counterpart:
``paddle_tpu/vision/models/_utils.py`` (``make_divisible``, copied: it
imports nothing of JAX).

``init`` gives every model the same rules: weights are drawn from
``seed`` with a ``torch.Generator`` on ``device`` (``None``: cuda,
raising without a card), and the model's Dropout layers share one
generator, the caller's ``generator`` or, without one, the weights'
generator (which goes on from where the weights left it)."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...numpy_bridge import load_numpy_state

__all__ = ["make_divisible", "ZooModel", "init", "no_pretrained"]


def make_divisible(v, divisor=8, min_value=None):
    """Round channel counts to hardware-friendly multiples (the MobileNet
    rule: never round down by more than 10%)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def init(seed, device, generator=None):
    """(``kw``: the ``generator`` and ``device`` every weighted layer is
    made with, the Dropout layers' generator)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return dict(generator=gen, device=dev), \
        gen if generator is None else generator


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not available: there are none to "
            "download")


class ZooModel(nn.Module):
    """A model of the zoo: its parameter and buffer names equal the JAX
    model's ``named_parameters()`` / ``named_buffers()``."""

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}``, the JAX model's
        ``named_parameters()`` and ``named_buffers()`` (the BatchNorm
        layers' ``_mean`` / ``_variance``) as numpy, into this model:
        every name must be present and no other, shapes and dtypes must
        be equal; bfloat16 arrays are carried bit for bit."""
        load_numpy_state(self, state)
