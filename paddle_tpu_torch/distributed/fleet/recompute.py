"""Activation recompute. Counterpart:
``paddle_tpu/distributed/fleet/recompute.py`` (``recompute`` :44-76,
``recompute_sequential`` :79-113).

JAX marks the region with ``jax.checkpoint``; here it runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only the region's inputs, and the backward runs the region
again to rebuild what it needs. The checkpoint restores the global CPU
and CUDA RNG states before the recomputation, but not an explicit
``torch.Generator`` (the port's attention dropout draws from one), so a
region that draws from one names it in ``generators``: its state is
saved before the forward, set back before the recomputation, and put
back afterwards, so the recomputation draws the same bits and the
generator's later draws are those of a run without recompute. JAX gets
the same from its ``fold_in`` counters.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, use_reentrant: bool = True,
              generators: Sequence[torch.Generator] = (), **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward. ``preserve_rng_state`` (default True) is the
    checkpoint's; ``use_reentrant`` is accepted for the signature's sake
    and, as in JAX, changes nothing: the region always runs the
    non-reentrant checkpoint. ``generators``: the explicit generators the
    region draws from."""
    del use_reentrant
    preserve = kwargs.pop("preserve_rng_state", True)
    gens = list(generators)
    saved = [g.get_state() for g in gens]
    calls = []

    def region(*xs):
        if not calls:               # the forward
            calls.append(1)
            return function(*xs, **kwargs)
        after = [g.get_state() for g in gens]
        for g, st in zip(gens, saved):
            g.set_state(st)
        try:
            return function(*xs, **kwargs)
        finally:
            for g, st in zip(gens, after):
                g.set_state(st)

    return checkpoint(region, *args, use_reentrant=False,
                      preserve_rng_state=preserve)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute over a sequence of layers cut into ``ctx["segments"]``
    chunks (default 1), each chunk one ``recompute`` region, as JAX's
    ``recompute_sequential``. A layer that returns a tuple feeds the next
    layer its elements."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(1, len(layers) // segments)

    def run_chunk(*xs, chunk=()):
        y = xs if len(xs) > 1 else xs[0]
        for layer in chunk:
            y = layer(*y) if isinstance(y, tuple) else layer(y)
        return y

    out = args
    for i in range(0, len(layers), per):
        out = recompute(run_chunk, *out, chunk=tuple(layers[i:i + per]),
                        **kwargs)
        out = out if isinstance(out, tuple) else (out,)
    return out[0] if len(out) == 1 else out
