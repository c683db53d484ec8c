"""Weight-streaming matmul for decode-shaped activations: the wrapper of
``csrc/decode_matmul.cu``, which replaces the TPU kernel
``paddle_tpu/ops/pallas/decode_matmul.py:decode_matmul``, plus its gate
``decode_matmul_supported``, its split plan ``split_plan`` and its plain
PyTorch version ``decode_matmul_reference``.

``decode_matmul`` runs the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises. bfloat16 x runs the
tensor-core kernel, float32 x the CUDA-core one."""
from __future__ import annotations

import torch

from ..qweight import QWeight, int4_nibbles
from ._build import check, load_library, sm_count

__all__ = ["decode_matmul", "decode_matmul_supported",
           "decode_matmul_reference", "dequantize", "unpack_int4_halves",
           "split_plan", "launches", "launches_by_shape"]

_MAX_ROWS = 32
# kernel launches since import; callers reset it to 0 to count a run
launches = 0
# the same launches by the weight's (K, N), counted at the launch site
# only (a CUDA graph replay adds to ``launches`` alone); callers clear it
launches_by_shape = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {None: 0, "int8": 1, "int4_halves": 2}
_MAX_SPLITS = 16


def split_plan(kind, dtype, b: int, K: int, N: int, sms: int):
    """(splits, weight rows per split) of the kernel's grid along K, for
    ``sms`` SMs: as many splits as keep the grid within one wave of
    resident blocks, at most _MAX_SPLITS, each split a whole number of
    granules and none empty. bfloat16 (csrc/decode_matmul.cu,
    tc::Shape): blocks of 4 warps at b <= 8 (4 resident an SM) and 8
    above (2 resident), each on 256 columns; a granule is one k-step (8
    packed int4 rows or 16 int8/dense rows) and a split holds at least
    one for each of the 2 warps that interleave k-steps over the same
    columns, and at most 256 / NT k-steps (NT = 1, 2, 4 n-tiles of 8
    rows at b <= 8, 16, 32), whose activations a block stages in 64 KB
    of shared memory. The splits' partial sums stay under the weight's
    bytes where the grid still has a block for every SM. float32:
    blocks of 8 warps on 128 columns, a granule one x stage (256 weight
    rows at b <= 8, 64 above). Weight rows are packed rows for int4
    ("int4_halves"). The C launcher takes the plan as given or refuses
    it."""
    rows_w = K // 2 if kind == "int4_halves" else K
    if dtype == torch.bfloat16:
        # blocks an SM holds at once (registers), and the most k-steps
        # whose activations a block stages (64 KB of shared memory)
        tile_n, resident = 256, 4 if b <= 8 else 2
        granule = 8 if kind == "int4_halves" else 16
        least = 2 * granule
        most = 256 // (1 if b <= 8 else 2 if b <= 16 else 4) * granule
    else:
        tile_n, resident = 128, 4
        granule = least = 256 if b <= 8 else 64
        most = rows_w
    blocks_n = -(-N // tile_n)
    # one wave: as many splits as the card holds blocks at once
    want = resident * sms // blocks_n
    # the splits' float32 partial sums stay under the weight's bytes,
    # unless that leaves an SM without a block
    wbytes = rows_w * N * (1 if kind else dtype.itemsize)
    s = max(1, min(_MAX_SPLITS, want, rows_w // least,
                   max(wbytes // (4 * b * N), -(-sms // blocks_n))),
            -(-rows_w // most))
    per = -(-(-(-rows_w // s)) // granule) * granule
    return -(-rows_w // per), per


def unpack_int4_halves(q, dtype=torch.int8):
    """(lo, hi) of a halves-packed int4 weight [K/2, N] int8: lo holds
    in-rows 0..K/2-1 and hi in-rows K/2..K-1, each sign-extended from its
    nibble by int8 shifts, as the JAX composition does."""
    lo, hi = int4_nibbles(q)
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
    of a kind the kernel takes with K in-features; N a multiple of 4
    (float32) or of 16 with K a multiple of 16 (bfloat16: whole
    tensor-core k-steps and 16-column lane groups)."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= _MAX_ROWS \
            or x.dtype not in _DTYPES:
        return False
    K = x.shape[1]
    if isinstance(w, QWeight):
        if w.kind not in _KINDS or w.in_features != K:
            return False
    elif w.dim() != 2 or w.shape[0] != K or w.dtype != x.dtype:
        return False
    if x.dtype == torch.bfloat16:
        return _n_out(w) % 16 == 0 and K % 16 == 0
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
    splits, per = split_plan(kind, x.dtype, b, K, N, sm_count(x.device))
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
            b, K, N, splits, per, _KINDS[kind], _DTYPES[x.dtype], stream)
    check(lib, code, "decode_matmul")
    launches += 1
    launches_by_shape[(K, N)] = launches_by_shape.get((K, N), 0) + 1
    return out
