"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention_decode.cu``), which replaces the TPU kernel
``paddle_tpu/ops/pallas/paged_attention.py:paged_attention_decode_pallas``.

The plain PyTorch version is
``paddle_tpu_torch.ops.paged_attention.paged_attention_decode_reference``;
the dispatcher ``paged_attention_decode`` there sends CUDA tensors with
an fp pool here. bfloat16 at head_dim 64 / 128 with pages of a multiple
of 16 positions that tile 64 runs the tensor-core kernel on the grid of
``paged_attention_plan.grid_plan``, with a float32 workspace and the
device's counters when it splits; float32, head_dim 256 and other pages
run its CUDA-core form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import check, load_library, sm_count
from .paged_attention_plan import counters, grid_plan, tensor_core_route

__all__ = ["paged_attention_decode_cuda", "launches", "HEAD_DIMS"]

# kernel launches since import; callers reset it to 0 to count a run
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention_decode_cuda: {msg}")


def paged_attention_decode_cuda(q, k_cache, v_cache, block_tables,
                                context_lens, scale: Optional[float] = None):
    """q [batch, num_heads, head_dim] (float32 or bfloat16); pools
    [num_blocks, kv_heads, block_size, head_dim] of q's dtype;
    block_tables [batch, max_pages] int32; context_lens [batch] int32
    (visible positions, this step's token included). Returns
    [batch, num_heads, head_dim] like q. Raises on anything the kernel
    does not take, an int8 pool included."""
    global launches
    _require(not isinstance(k_cache, tuple) and not isinstance(v_cache,
                                                               tuple),
             "takes fp pools only; an (int8, scales) pool goes to the "
             "ragged kernel")
    _require(q.dtype in _DTYPES, f"q dtype {q.dtype} not in "
             f"{tuple(_DTYPES)}")
    _require(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
             f"pool dtype {k_cache.dtype} differs from q dtype {q.dtype}")
    _require(q.dim() == 3 and k_cache.dim() == 4,
             "q must be 3-d and pools 4-d")
    b, nh, d = q.shape
    nb, kvh, bs, d2 = k_cache.shape
    _require(d == d2 and tuple(v_cache.shape) == tuple(k_cache.shape),
             "q / K / V head dims or pool shapes disagree")
    _require(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    _require(nh % kvh == 0 and nh // kvh <= _MAX_GROUP,
             f"num_heads {nh} must be a multiple of kv_heads {kvh}, at "
             f"most {_MAX_GROUP} per kv-head")
    _require(block_tables.dim() == 2 and block_tables.dtype == torch.int32
             and block_tables.shape[0] == b,
             "block_tables must be int32 [batch, max_pages]")
    _require(context_lens.dtype == torch.int32
             and tuple(context_lens.shape) == (b,),
             "context_lens must be int32 [batch]")
    tensors = [q, k_cache, v_cache, block_tables, context_lens]
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every operand must lie on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors)
             and all(t.data_ptr() % 16 == 0
                     for t in (q, k_cache, v_cache)),
             "every operand must be contiguous, q and the pools 16-byte "
             "aligned")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits, deep, blocks = grid_plan(b, kvh, block_tables.shape[1],
                                     bs, sm_count(q.device)) \
        if tensor_core_route(q.dtype, d, bs) else (1, False, b)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(splits * b * nh * (d + 2), dtype=torch.float32,
                         device=q.device)
        cnt = counters(q.device, b * kvh)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_paged_attention_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None, b, nh, kvh, d, nb,
            bs, block_tables.shape[1], _DTYPES[q.dtype], splits, int(deep),
            blocks, float(scale), stream)
    check(lib, code, "paged_attention_decode")
    launches += 1
    return out
