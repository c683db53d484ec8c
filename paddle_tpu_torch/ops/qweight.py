"""Quantized weight carrier with an explicit layout tag.

The JAX package carries a quantized weight as a bare ``(q, scale)``
tuple and tells int8 from int4 by the packed array's row count, which
cannot tell the int4 HALVES packing (single device) from the
even/odd INTERLEAVED packing (tensor parallel). The port tags the
layout instead, and every consumer asserts on the tag.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QWeight", "QWEIGHT_KINDS"]

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
