"""Wrapper of the CUDA ragged paged attention kernel
(``csrc/ragged_paged_attention.cu``), which replaces the TPU kernel
``paddle_tpu/ops/pallas/ragged_paged_attention.py:ragged_paged_attention_pallas``.

The plain PyTorch version is
``paddle_tpu_torch.ops.paged_attention.ragged_paged_attention_reference``;
the dispatcher ``ragged_paged_attention`` there sends CUDA tensors here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import check, load_library

__all__ = ["ragged_paged_attention_cuda", "launches"]

# kernel launches since import; callers reset it to 0 to count a run
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 8


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ragged_paged_attention_cuda: {msg}")


def ragged_paged_attention_cuda(q, k_cache, v_cache, block_tables, row_seq,
                                row_ctx, scale: Optional[float] = None):
    """q [rows, num_heads, head_dim] (float32 or bfloat16); pools
    [num_blocks, kv_heads, block_size, head_dim] of q's dtype, or
    (int8 values, float32 scales [num_blocks, kv_heads, block_size])
    tuples; block_tables [num_seqs, max_pages] int32; row_seq / row_ctx
    [rows] int32. Returns [rows, num_heads, head_dim] like q. Raises on
    anything the kernel does not take."""
    global launches
    quantized = isinstance(k_cache, tuple)
    if quantized:
        kv, ks = k_cache
        vv, vs = v_cache
        _require(kv.dtype == torch.int8 and vv.dtype == torch.int8,
                 "quantized pools must hold int8 values")
        _require(ks.dtype == torch.float32 and vs.dtype == torch.float32
                 and tuple(ks.shape) == tuple(kv.shape[:3])
                 and tuple(vs.shape) == tuple(kv.shape[:3]),
                 "pool scales must be float32 [num_blocks, kv_heads, "
                 "block_size]")
    else:
        kv, vv = k_cache, v_cache
        ks = vs = None
        _require(kv.dtype == q.dtype and vv.dtype == q.dtype,
                 f"pool dtype {kv.dtype} differs from q dtype {q.dtype}")
    _require(q.dtype in _DTYPES, f"q dtype {q.dtype} not in "
             f"{tuple(_DTYPES)}")
    _require(q.dim() == 3 and kv.dim() == 4, "q must be 3-d and pools 4-d")
    r, nh, d = q.shape
    nb, kvh, bs, d2 = kv.shape
    _require(d == d2 and tuple(vv.shape) == tuple(kv.shape),
             "q / K / V head dims or pool shapes disagree")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    _require(nh % kvh == 0 and nh // kvh <= _MAX_GROUP,
             f"num_heads {nh} must be a multiple of kv_heads {kvh}, at "
             f"most {_MAX_GROUP} per kv-head")
    _require(block_tables.dim() == 2 and block_tables.dtype == torch.int32,
             "block_tables must be a 2-d int32 tensor")
    _require(row_seq.dtype == torch.int32 and row_ctx.dtype == torch.int32
             and tuple(row_seq.shape) == (r,)
             and tuple(row_ctx.shape) == (r,),
             "row_seq / row_ctx must be int32 [rows]")
    tensors = [q, kv, vv, block_tables, row_seq, row_ctx] \
        + ([ks, vs] if quantized else [])
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every operand must lie on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "every operand must be contiguous")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if r == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_ragged_paged_attention(
            q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
            ks.data_ptr() if quantized else None,
            vs.data_ptr() if quantized else None,
            block_tables.data_ptr(), row_seq.data_ptr(), row_ctx.data_ptr(),
            out.data_ptr(), r, nh, kvh, d, nb, bs, block_tables.shape[0],
            block_tables.shape[1], _DTYPES[q.dtype], int(quantized),
            float(scale), stream)
    check(lib, code, "ragged_paged_attention")
    launches += 1
    return out
