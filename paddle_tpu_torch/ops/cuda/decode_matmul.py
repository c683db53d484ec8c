"""Weight-streaming matmul for decode-shaped activations: the wrapper of
``csrc/decode_matmul.cu``, which replaces the TPU kernel
``paddle_tpu/ops/pallas/decode_matmul.py:decode_matmul``, plus its gate
``decode_matmul_supported`` and its plain PyTorch version
``decode_matmul_reference``.

``decode_matmul`` runs the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises."""
from __future__ import annotations

import torch

from ..qweight import QWeight
from ._build import check, load_library

__all__ = ["decode_matmul", "decode_matmul_supported",
           "decode_matmul_reference", "dequantize", "unpack_int4_halves",
           "launches"]

_MAX_ROWS = 32
# kernel launches since import; callers reset it to 0 to count a run
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {None: 0, "int8": 1, "int4_halves": 2}
_TILE_N = 128          # output columns per block
_BLOCKS_PER_SM = 4     # K-split target
_MAX_SPLITS = 16
_sm_count = {}


def _splits(rows_w: int, b: int, N: int, device) -> int:
    """K-splits for about _BLOCKS_PER_SM blocks per SM, each split at
    least one x stage (256 weight rows at b <= 8, 64 above): the fixed
    point of the rule the C launcher re-derives."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    tile_k = 256 if b <= 8 else 64
    blocks_n = -(-N // _TILE_N)
    s = max(1, min(_MAX_SPLITS,
                   -(-_BLOCKS_PER_SM * _sm_count[idx] // blocks_n),
                   rows_w // tile_k))
    while True:
        per_split = -(-(-(-rows_w // s)) // tile_k) * tile_k
        s2 = -(-rows_w // per_split)
        if s2 == s:
            return s
        s = s2


def unpack_int4_halves(q, dtype=torch.int8):
    """(lo, hi) of a halves-packed int4 weight [K/2, N] int8: lo holds
    in-rows 0..K/2-1 and hi in-rows K/2..K-1, each sign-extended from its
    nibble by int8 shifts, as the JAX composition does."""
    lo = (q << 4) >> 4
    hi = q >> 4
    return lo.to(dtype), hi.to(dtype)


def dequantize(w):
    """The integer values of a quantized weight as float32 [K, N] (the
    scale is NOT applied), or a dense weight as float32."""
    if not isinstance(w, QWeight):
        return w.to(torch.float32)
    w.check()
    if w.kind == "int8":
        return w.q.to(torch.float32)
    lo, hi = unpack_int4_halves(w.q, torch.float32)
    return torch.cat([lo, hi], dim=0)


def _n_out(w) -> int:
    return w.out_features if isinstance(w, QWeight) else w.shape[1]


def decode_matmul_supported(x, w) -> bool:
    """True when (x, w) fits the kernel: 2-d x of float32 or bfloat16
    with 1..32 rows; w a dense [K, N] weight of x's dtype or a QWeight
    of a kind the kernel takes with K in-features; N a multiple of 4."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= _MAX_ROWS \
            or x.dtype not in _DTYPES:
        return False
    K = x.shape[1]
    if isinstance(w, QWeight):
        if w.kind not in _KINDS or w.in_features != K:
            return False
    elif w.dim() != 2 or w.shape[0] != K or w.dtype != x.dtype:
        return False
    return _n_out(w) % 4 == 0


def decode_matmul_reference(x, w):
    """Plain version: dequantize, multiply in float32, apply the scale in
    float32, cast to x's dtype."""
    y = x.to(torch.float32) @ dequantize(w)
    if isinstance(w, QWeight):
        y = y * w.scale
    return y.to(x.dtype)


def decode_matmul(x, w):
    """x [b, K] @ w -> [b, N]; w dense [K, N] or a QWeight ("int8" or
    "int4_halves")."""
    global launches
    if isinstance(w, QWeight):
        w.check()
    if not x.is_cuda:
        return decode_matmul_reference(x, w)
    if not decode_matmul_supported(x, w):
        raise ValueError(
            f"decode_matmul: x {tuple(x.shape)} {x.dtype} with weight "
            f"{getattr(w, 'kind', 'dense')} is not a shape or type the "
            f"kernel takes")
    wq = w.q if isinstance(w, QWeight) else w
    scale = w.scale if isinstance(w, QWeight) else None
    operands = [x, wq] + ([scale] if scale is not None else [])
    if not all(t.is_cuda and t.device == x.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in operands):
        raise ValueError("decode_matmul: every operand must be a "
                         "contiguous, 16-byte aligned tensor on x's device")
    b, K = x.shape
    N = _n_out(w)
    kind = getattr(w, "kind", None)
    splits = _splits(K // 2 if kind == "int4_halves" else K, b, N,
                     x.device)
    out = torch.empty((b, N), dtype=x.dtype, device=x.device)
    work = torch.empty((splits, b, N), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ptt_decode_matmul(
            x.data_ptr(), wq.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), work.data_ptr() if work is not None else None,
            b, K, N, splits, _KINDS[kind], _DTYPES[x.dtype], stream)
    check(lib, code, "decode_matmul")
    launches += 1
    return out
