"""The collectives of tensor-parallel serving, over a list of shards.

Counterpart: the collectives the JAX decoders call inside their
fully-manual ``shard_map`` bodies (``jax.lax.psum``,
``paddle_tpu/distributed/collective.py:213-282`` ``int8_all_reduce`` and
``jax.lax.all_gather``). The port's tp program is single controller:
one process holds every shard's tensor, and a collective takes the list
of them, one per shard in shard order, each on its shard's device. They
are plain tensor ops (no kernel: JAX's are XLA collectives), queued on
the current stream, with no host sync, so a CUDA graph may hold them.
Shards on one device (``["cuda:0"] * 2``) exchange nothing; shards on
distinct devices meet through ``.to(device)`` copies.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["all_reduce", "int8_all_reduce", "all_gather_logits"]


def _fanout(x: torch.Tensor, like: Sequence[torch.Tensor]):
    """x on each shard's device (the same tensor where it already is)."""
    return [x.to(t.device, non_blocking=True) for t in like]


def all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' partial products, on every shard's device:
    accumulated in float32 in shard order on shard 0's device, then cast
    to the shards' dtype. One shard passes through untouched."""
    if len(xs) == 1:
        return list(xs)
    dev = xs[0].device
    acc = xs[0].to(torch.float32)
    for x in xs[1:]:
        acc = acc + x.to(dev, torch.float32, non_blocking=True)
    return _fanout(acc.to(xs[0].dtype), xs)


def _quantize_rows(x: torch.Tensor):
    """Symmetric absmax int8 over the last dim: (values, scale [...]);
    a zero row gets scale 1, as in JAX."""
    scale = x.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale


def int8_all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The EQuARX-style quantized all-reduce of ``tp_comm="int8"``, the
    JAX collective step for step. Each shard splits its [..., d] partial
    into n chunks of the last dim and quantizes every (row, chunk) to
    int8 with its own absmax scale; shard j receives chunk j of every
    shard with the sender's scales and sums them dequantized in float32
    (reduce-scatter); it quantizes that sum again per row and every
    shard gathers the n int8 chunks with their scales (all-gather).
    When d does not divide by n it is the exact ``all_reduce``."""
    n = len(xs)
    d = xs[0].shape[-1]
    if n == 1:
        return list(xs)
    if d % n:
        return all_reduce(xs)
    lead = xs[0].shape[:-1]
    dc = d // n
    dev = xs[0].device
    # phase 1: per shard [n, rows, dc] int8 chunks and [n, rows] scales
    sent = []
    for x in xs:
        xf = x.to(torch.float32).reshape(-1, n, dc).transpose(0, 1)
        sent.append(_quantize_rows(xf))
    # reduce-scatter: shard j sums chunk j of every sender
    chunks, scales = [], []
    for j, x in enumerate(xs):
        acc = None
        for q, s in sent:
            part = q[j].to(x.device, non_blocking=True).to(torch.float32) \
                * s[j].to(x.device, non_blocking=True)[:, None]
            acc = part if acc is None else acc + part
        q2, s2 = _quantize_rows(acc)
        chunks.append(q2)
        scales.append(s2)
    # phase 2: all-gather the re-quantized chunks, dequantized on shard 0
    out = torch.cat([q.to(dev, non_blocking=True).to(torch.float32)
                     * s.to(dev, non_blocking=True)[:, None]
                     for q, s in zip(chunks, scales)], dim=-1)
    return _fanout(out.reshape(*lead, d).to(xs[0].dtype), xs)


def all_gather_logits(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-shard vocab slices of the logits (the column-parallel
    head), concatenated along the last dim on shard 0's device: exact,
    under either ``tp_comm``. Sampling reads it there, once."""
    if len(xs) == 1:
        return xs[0]
    dev = xs[0].device
    return torch.cat([x.to(dev, non_blocking=True) for x in xs], dim=-1)
