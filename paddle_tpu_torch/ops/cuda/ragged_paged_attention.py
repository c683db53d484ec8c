"""Wrapper of the CUDA ragged paged attention kernel
(``csrc/ragged_paged_attention.cu``), which replaces the TPU kernel
``paddle_tpu/ops/pallas/ragged_paged_attention.py:ragged_paged_attention_pallas``.

The plain PyTorch version is
``paddle_tpu_torch.ops.paged_attention.ragged_paged_attention_reference``;
the dispatcher ``ragged_paged_attention`` there sends CUDA tensors here.
bfloat16 q at head_dim 64 / 128 with pages of a multiple of 16 positions
that tile 64 runs the tensor-core kernel on the grid of
``paged_attention_plan.grid_plan``, with a float32 workspace and the
device's counters when it splits; everything else the kernel takes runs
its CUDA-core form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import check, load_library, sm_count
from .paged_attention_plan import counters, grid_plan, tensor_core_route

__all__ = ["ragged_paged_attention_cuda", "launches", "smem_bytes"]

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
    _require(all(t.is_contiguous() for t in tensors)
             and all(t.data_ptr() % 16 == 0 for t in tensors[:3]
                     + ([ks, vs] if quantized else [])),
             "every operand must be contiguous, q, the pools and their "
             "scales 16-byte aligned")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if r == 0:
        return out
    splits, deep, blocks = grid_plan(r, kvh, block_tables.shape[1],
                                     bs, sm_count(q.device)) \
        if tensor_core_route(q.dtype, d, bs) else (1, False, r)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(splits * r * nh * (d + 2), dtype=torch.float32,
                         device=q.device)
        cnt = counters(q.device, r * kvh)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_ragged_paged_attention(
            q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
            ks.data_ptr() if quantized else None,
            vs.data_ptr() if quantized else None,
            block_tables.data_ptr(), row_seq.data_ptr(), row_ctx.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None, r, nh, kvh, d, nb,
            bs, block_tables.shape[0], block_tables.shape[1],
            _DTYPES[q.dtype], int(quantized), splits, int(deep), blocks,
            float(scale), stream)
    check(lib, code, "ragged_paged_attention")
    launches += 1
    return out


def smem_bytes(head_dim: int, quantized: bool, deep: bool) -> int:
    """Dynamic shared memory a block of the tensor-core kernels takes
    (both entries share it) at head_dim 64 or 128, bf16 or int8 pool,
    with the regular or the deep ring."""
    return load_library().ptt_paged_attention_smem(head_dim, int(quantized),
                                                   int(deep))
