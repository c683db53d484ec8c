"""Quantized weight carrier with an explicit layout tag.

The JAX package carries a quantized weight as a bare ``(q, scale)``
tuple and tells int8 from int4 by the packed array's row count, which
cannot tell the int4 HALVES packing (single device) from the
even/odd INTERLEAVED packing (tensor parallel). The port tags the
layout instead, and every consumer asserts on the tag. Every int4
weight the port holds is halves-packed: a JAX tp decoder's interleaved
bytes are repacked when they are loaded (``halves_from_interleaved``),
and tensor-parallel placement (``distributed/spec_layout.py``) repacks a
row shard over its own in-dim (``int4_values``, ``pack_int4_halves``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QWeight", "QWEIGHT_KINDS", "halves_from_interleaved",
           "int4_nibbles", "int4_values", "pack_int4_halves"]

# "int8":        q [K, N] int8, per-output-channel scale [N] f32.
# "int4_halves": q [K/2, N] int8; packed row r holds in-row r in the low
#                nibble and in-row r + K/2 in the high nibble, both
#                two's-complement 4-bit values; scale [N] f32.
QWEIGHT_KINDS = ("int8", "int4_halves")


class QWeight(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor
    kind: str

    def check(self):
        if self.kind not in QWEIGHT_KINDS:
            raise ValueError(f"unknown QWeight kind {self.kind!r}; "
                             f"expected one of {QWEIGHT_KINDS}")
        if self.q.dtype != torch.int8 or self.q.dim() != 2:
            raise ValueError(f"QWeight.q must be a 2-d int8 tensor, got "
                             f"{tuple(self.q.shape)} {self.q.dtype}")
        if self.scale.dtype != torch.float32 \
                or tuple(self.scale.shape) != (self.q.shape[1],):
            raise ValueError(f"QWeight.scale must be float32 "
                             f"[{self.q.shape[1]}], got "
                             f"{tuple(self.scale.shape)} "
                             f"{self.scale.dtype}")
        return self

    @property
    def in_features(self) -> int:
        return self.q.shape[0] * (2 if self.kind == "int4_halves" else 1)

    @property
    def out_features(self) -> int:
        return self.q.shape[1]


def int4_nibbles(q: torch.Tensor):
    """(low, high) nibbles of packed int4 bytes, sign-extended by int8
    shifts."""
    return (q << 4) >> 4, q >> 4


def int4_values(w: QWeight) -> torch.Tensor:
    """The integer values [K, N] int8 of an int4 weight, in in-row
    order."""
    if w.kind != "int4_halves":
        raise ValueError(f"int4_values: {w.kind} is not an int4 kind")
    return torch.cat(int4_nibbles(w.q), dim=0)


def halves_from_interleaved(q: torch.Tensor) -> torch.Tensor:
    """JAX's even/odd-packed int4 bytes [K/2, N] (``_quantize_w4``: packed
    row r holds in-row 2r in the low nibble and 2r + 1 in the high)
    repacked as halves; the integer values are unchanged."""
    lo, hi = int4_nibbles(q)
    return pack_int4_halves(torch.stack([lo, hi], dim=1)
                            .reshape(-1, q.shape[1]))


def pack_int4_halves(values: torch.Tensor) -> torch.Tensor:
    """int8 values [K, N] in [-8, 7] -> halves-packed [K/2, N] int8."""
    if values.shape[0] % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got "
                         f"{values.shape[0]}")
    u = values.view(torch.uint8)
    half = values.shape[0] // 2
    return ((u[:half] & 0x0F) | ((u[half:] & 0x0F) << 4)).view(torch.int8)
