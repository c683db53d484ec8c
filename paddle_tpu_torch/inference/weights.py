"""Carry a JAX decoder's weights into the port.

``weights_from_numpy`` takes the ``weights`` tree of the JAX
``PagedLlamaDecoder`` after the caller turned every leaf into numpy —
``embed`` / ``norm`` / per-layer ``ln1``, ``ln2`` arrays, matmul weights
as arrays or ``(q, scale)`` tuples, ``wqkv`` / ``wgu`` fused or not —
and returns the port's tensors on ``device`` (``None`` means cuda).
A tuple cannot say how its int4 values are packed, so the caller states
``weight_dtype`` and ``int4_layout``: a single-device JAX decoder packs
int4 as halves (the default), a tensor-parallel one (``mesh=``) packs
it even/odd per projection (``int4_layout="interleaved"``, the
``_quantize_w4`` layout). ``int4_layout`` describes only the incoming
tuples: interleaved bytes are repacked as halves here, with the same
integer values and scales, so every int4 weight the port holds is
``int4_halves`` and its products of few rows take the GEMV kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..numpy_bridge import tensor_from_numpy
from ..ops.qweight import QWeight, halves_from_interleaved

__all__ = ["weights_from_numpy", "tensor_from_numpy"]

_KIND_OF = {"int8": "int8", "int4": "int4_halves"}


def weights_from_numpy(tree, *, weight_dtype: Optional[str],
                       device=None, int4_layout: str = "halves") -> dict:
    if weight_dtype not in (None, "int8", "int4"):
        raise ValueError(f"weight_dtype must be None, 'int8' or 'int4', "
                         f"got {weight_dtype!r}")
    if int4_layout not in ("halves", "interleaved"):
        raise ValueError(f"int4_layout must be 'halves' or 'interleaved', "
                         f"got {int4_layout!r}")
    repack = weight_dtype == "int4" and int4_layout == "interleaved"
    dev = resolve_device(device)

    def mat(w):
        if weight_dtype is None:
            if isinstance(w, tuple):
                raise ValueError("a quantized (q, scale) weight was given "
                                 "with weight_dtype=None")
            return tensor_from_numpy(w, dev)
        if not isinstance(w, tuple) or len(w) != 2:
            raise ValueError(f"weight_dtype={weight_dtype!r} expects "
                             f"(q, scale) tuples")
        q, s = w
        q = tensor_from_numpy(q, dev)
        return QWeight(halves_from_interleaved(q) if repack else q,
                       tensor_from_numpy(s, dev).to(torch.float32),
                       _KIND_OF[weight_dtype]).check()

    layers = []
    for lw in tree["layers"]:
        layers.append({k: (tensor_from_numpy(v, dev)
                           if k in ("ln1", "ln2") else mat(v))
                       for k, v in lw.items()})
    return {"embed": tensor_from_numpy(tree["embed"], dev),
            "layers": layers,
            "norm": tensor_from_numpy(tree["norm"], dev),
            "head": mat(tree["head"])}
