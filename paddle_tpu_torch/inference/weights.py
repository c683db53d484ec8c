"""Carry a JAX decoder's weights into the port.

``weights_from_numpy`` takes the ``weights`` tree of a JAX paged
decoder after the caller turned every leaf into numpy and returns the
port's tensors on ``device`` (``None`` means cuda). Matmul weights
(``MATMUL_KEYS`` and ``head``) are arrays or ``(q, scale)`` tuples;
every other leaf is an array carried as it is: the Llama tree's
``embed`` / ``norm`` / per-layer ``ln1``, ``ln2`` (``wqkv`` / ``wgu``
fused or not), and the GPT tree's ``embed``, ``pos``, ``lnf_w`` /
``lnf_b``, per-layer ``ln1_*`` / ``ln2_*`` and the biases ``bqkv`` (or
``bq`` / ``bk`` / ``bv``), ``bo``, ``bi``, ``bf``, which stay at full
precision.
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

__all__ = ["weights_from_numpy", "tensor_from_numpy", "MATMUL_KEYS"]

_KIND_OF = {"int8": "int8", "int4": "int4_halves"}

# per-layer matmul weights of both families ([in, out], quantizable)
MATMUL_KEYS = frozenset({"wq", "wk", "wv", "wqkv", "wo", "wg", "wu", "wgu",
                         "wd", "wi", "wf"})


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
        layers.append({k: (mat(v) if k in MATMUL_KEYS
                           else tensor_from_numpy(v, dev))
                       for k, v in lw.items()})
    out = {k: (mat(v) if k == "head" else tensor_from_numpy(v, dev))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = layers
    return out
