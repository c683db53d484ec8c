"""Wrappers of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``), which replace the TPU kernels of
``paddle_tpu/ops/pallas/flash_attention.py``: ``_flash_fwd``
(``_fwd_kernel``) and the two calls of ``_bwd_pair_call``
(``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), and ``FlashAttention``, the
``torch.autograd.Function`` that joins them as ``_fa_fwd``/``_fa_bwd``
and ``_fas_fwd``/``_fas_bwd`` do.

The plain PyTorch version is
``paddle_tpu_torch.ops.flash_attention.flash_attention_plain``; the
dispatchers there send CUDA tensors here.

Each kernel's route follows from its kind, dtype and head_dim alone
(``HOPPER_HEAD_DIMS``): bfloat16 runs the Hopper kernels of
``csrc/flash_attention_wg.cu`` (wgmma, TMA) for the forward, dq and
dk/dv at head_dim 64, 72 (DiT-XL/2, its tiles padded to 128 columns in
shared memory) and 128. They walk a work list built here by
``flash_schedule``: the tile arithmetic lives in this one place, where
the CPU tests check it exhaustively. float32 at every head_dim and
bfloat16 at 256 run the CUDA-core kernels of
``csrc/flash_attention.cu``. A call on a route goes to its kernel or
raises: nothing falls back to another route or to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import check, load_library, sm_count

__all__ = ["flash_fwd_cuda", "flash_bwd_cuda", "flash_bwd_delta",
           "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda", "FlashAttention",
           "smem_bytes", "HEAD_DIMS", "launches_fwd", "launches_dq",
           "launches_dkv", "TILES", "flash_schedule", "dkv_pieces",
           "kernel_regs", "HOPPER_HEAD_DIMS"]

# kernel launches since import; callers reset them to 0 to count a run
launches_fwd = 0
launches_dq = 0
launches_dkv = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 72, 128, 256)
# the head_dims of each Hopper (wgmma, TMA) kernel, bfloat16 only
HOPPER_HEAD_DIMS = {"fwd": (64, 72, 128), "dq": (64, 72, 128),
                    "dkv": (64, 72, 128)}

# (own rows, streamed rows) of a CTA's tile in each Hopper kernel: the
# forward and dq own query rows and stream key tiles, dk/dv owns key rows
# and streams query tiles. flash_attention_wg.cu refuses a list built for
# other tiles.
TILES = {"fwd": (128, 128), "dq": (128, 64), "dkv": (128, 64)}


@functools.lru_cache(maxsize=256)
def flash_schedule(kind: str, b: int, sq: int, sk: int, h: int, hk: int,
                   causal: bool, segmented: bool,
                   sms: int | None = None) -> np.ndarray:
    """The work list of a Hopper flash kernel: int32 [n, 8], one row
    (batch, head, tile, lo, hi, free_lo, free_hi, piece) per own tile of
    TILES[kind][0] rows of one head (query heads for "fwd" and "dq",
    kv-heads for "dkv", which visits the head's query group itself).
    The row visits the streamed tiles [lo, hi), the only ones holding a
    pair its rows can see (row r sees column c iff r + (sk - sq) >= c
    under causal); of those, [free_lo, free_hi) hold only visible pairs
    and skip the per-element mask (none when segmented: segment ids are
    data). Rows are ordered longest first (a stable sort, so the order
    is fixed); the kernel's CTA c takes rows c, c + grid, ..., every
    other round walked backwards, so the long rows spread evenly. The tile
    ranges follow JAX's skipping in _fwd_kernel (:86-87),
    _bwd_dq_kernel (:196-197) and _bwd_dkv_kernel (:252-253). Cached:
    the same arguments give the same array, which must not be
    written.

    A "dkv" list of fewer rows than ``sms`` (the card's SM count; None
    never splits) would leave SMs idle for the whole backward, so each
    row's range [lo, hi) is cut into contiguous pieces of at least 2
    streamed tiles, numbered 0, 1, ... in the row's last column: the
    smallest count s per row (fewer where the row is short) that gives
    at least ``sms`` rows, or as many as the rows allow. Each piece
    writes partial dK/dV sums to its own workspace slot, which the
    kernel's second pass adds in piece order (``dkv_pieces``). Every
    other list has piece 0 throughout and is the same with or without
    ``sms``."""
    bm, bn = TILES[kind]
    off = sk - sq
    if kind == "dkv":
        own, stream, heads = sk, sq, hk
    else:
        own, stream, heads = sq, sk, h
    n_stream = -(-stream // bn)
    full = stream // bn  # streamed tiles without a ragged edge
    tiles = []
    for t in range(-(-own // bm)):
        first, last = t * bm, min(t * bm + bm, own) - 1  # its real rows
        lo, hi, flo, fhi = 0, n_stream, 0, full
        if causal and kind != "dkv":
            # query rows [first, last] see keys up to last + off; key tile
            # kt holds only visible pairs if kt * bn + bn - 1 <= first + off
            hi = (0 if last + off < 0
                  else min(n_stream, (last + off) // bn + 1))
            fhi = min(full, max(0, (first + off + 1) // bn))
        elif causal:
            # key rows [first, last] are seen by queries from first - off;
            # query tile qt sees all of them if qt * bn >= last - off
            seen = max(first - off, 0)
            lo = seen // bn if seen < sq else n_stream
            flo = max(0, -(-(last - off) // bn))
        flo, fhi = max(flo, lo), min(fhi, hi)
        if segmented or fhi <= flo:
            flo = fhi = lo
        tiles.append((t, lo, hi, flo, fhi))
    if kind == "dkv" and sms is not None:
        tiles = _split_tiles(tiles, b * heads, sms)
    else:
        tiles = [tile + (0,) for tile in tiles]
    rows = [(bi, hd, t, lo, hi, flo, fhi, piece) for bi in range(b)
            for hd in range(heads) for t, lo, hi, flo, fhi, piece in tiles]
    rows.sort(key=lambda r: r[3] - r[4])
    out = np.asarray(rows, dtype=np.int32).reshape(-1, 8)
    out.flags.writeable = False
    return out


def _split_tiles(tiles, copies: int, sms: int):
    """Cut each tile (t, lo, hi, free_lo, free_hi) of a list that holds
    ``copies`` rows per tile into pieces (t, lo', hi', free_lo',
    free_hi', piece) when copies * len(tiles) < sms: per tile
    min(s, max(1, (hi - lo) // 2)) pieces of near-equal length, s the
    smallest count that reaches sms rows (or the most the tiles take).
    The free range is clipped to each piece (empty: at the piece's lo)."""
    cap = [max(1, (hi - lo) // 2) for _t, lo, hi, _f, _g in tiles]
    s = 1
    while copies * sum(min(s, c) for c in cap) < sms and s < max(cap):
        s += 1
    out = []
    for (t, lo, hi, flo, fhi), c in zip(tiles, cap):
        n = min(s, c)
        for p in range(n):
            plo = lo + (hi - lo) * p // n
            phi = lo + (hi - lo) * (p + 1) // n
            pflo, pfhi = max(flo, plo), min(fhi, phi)
            if pfhi <= pflo:
                pflo = pfhi = plo
            out.append((t, plo, phi, pflo, pfhi, p))
    return out


def dkv_pieces(rows: np.ndarray, sk: int) -> np.ndarray:
    """Pieces per key tile of a "dkv" work list: int32 [tiles of
    TILES["dkv"][0] key rows], each tile's highest piece + 1."""
    n = np.zeros(-(-sk // TILES["dkv"][0]), dtype=np.int32)
    np.maximum.at(n, rows[:, 2], rows[:, 7] + 1)
    return n


@functools.lru_cache(maxsize=None)
def _schedule_on(device, kind, b, sq, sk, h, hk, causal, segmented, sms):
    """flash_schedule's work list as a tensor on device and, for a dk/dv
    list cut into pieces, its pieces per key tile on device and their
    most (None and 1 otherwise). Cached without bound: a captured CUDA
    graph holds the address of every list it launched with."""
    host = flash_schedule(kind, b, sq, sk, h, hk, causal, segmented, sms)
    sched = torch.from_numpy(host.copy()).to(device)
    if kind != "dkv" or not host[:, 7].any():
        return sched, None, 1
    pieces = dkv_pieces(host, sk)
    return sched, torch.from_numpy(pieces).to(device), int(pieces.max())


def _schedule(kind, q, b, sq, sk, h, hk, causal, segmented):
    """(work list on q's device, its rows, pieces per key tile or None,
    workspace slots) for the Hopper kernel of ``kind``, or (None, 0,
    None, 1) for the CUDA-core route (float32; bfloat16 at a head_dim
    HOPPER_HEAD_DIMS[kind] does not name)."""
    if (q.dtype != torch.bfloat16
            or q.shape[-1] not in HOPPER_HEAD_DIMS[kind]):
        return None, 0, None, 1
    t, pieces, slots = _schedule_on(
        q.device, kind, b, sq, sk, h, hk, bool(causal), bool(segmented),
        sm_count(q.device) if kind == "dkv" else None)
    return t, t.shape[0], pieces, slots


def _regs(lib, kernel: str, d: int):
    """A callable giving the registers a thread of the Hopper kernel
    (for check's message; -1 where the kernel has no Hopper route,
    which never reports short registers)."""
    return lambda: lib.ptt_flash_regs(("fwd", "dq", "dkv").index(kernel), d)


def kernel_regs(kernel: str, head_dim: int) -> int:
    """Registers a thread of the Hopper kernel ("fwd", "dq" or "dkv") at
    a head_dim of HOPPER_HEAD_DIMS[kernel] as built: their setmaxnreg
    split needs 168, and a launch with fewer raises. At another head_dim
    the kernel runs only on CUDA cores, which have no such split:
    ValueError."""
    if head_dim not in HOPPER_HEAD_DIMS[kernel]:
        raise ValueError(f"kernel_regs: {kernel} at head_dim {head_dim} has "
                         f"no Hopper kernel (it takes "
                         f"{HOPPER_HEAD_DIMS[kernel]})")
    return _regs(load_library(), kernel, head_dim)()


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check(q, k, v, q_seg, kv_seg, extra=()):
    """Validate what every kernel takes; returns (b, sq, sk, h, hk, d)."""
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k and v must be [batch, seq, heads, head_dim]")
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    _require(tuple(k.shape) == tuple(v.shape) and k.shape[0] == b
             and k.shape[3] == d, f"k {tuple(k.shape)} / v "
             f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"q/k/v must share a dtype in {tuple(_DTYPES)}")
    _require(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    _require(hk > 0 and h % hk == 0,
             f"num_heads {h} must be a multiple of kv_heads {hk}")
    _require(sq > 0 and sk > 0, "empty sequence")
    _require((q_seg is None) == (kv_seg is None),
             "pass both segment id tensors or neither")
    tensors = [q, k, v, *extra]
    if q_seg is not None:
        _require(q_seg.dtype == torch.int32 and kv_seg.dtype == torch.int32
                 and tuple(q_seg.shape) == (b, sq)
                 and tuple(kv_seg.shape) == (b, sk),
                 "segment ids must be int32 [batch, seq]")
        tensors += [q_seg, kv_seg]
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every operand must lie on q's CUDA device")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in tensors),
             "every operand must be contiguous and 16-byte aligned")
    return b, sq, sk, h, hk, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, causal: bool, scale: float, q_seg=None,
                   kv_seg=None):
    """q [b, sq, h, d], k/v [b, sk, hk, d] (float32 or bfloat16);
    optional int32 segment ids [b, sq] / [b, sk]. Returns (out like q,
    lse float32 [b, h, sq])."""
    global launches_fwd
    b, sq, sk, h, hk, d = _check(q, k, v, q_seg, kv_seg)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    sched, n, _, _ = _schedule("fwd", q, b, sq, sk, h, hk, causal,
                               q_seg is not None)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg),
            _ptr(kv_seg), out.data_ptr(), lse.data_ptr(), _ptr(sched), b,
            sq, sk, h, hk, d, _DTYPES[q.dtype], int(causal), n,
            *TILES["fwd"], float(scale), stream)
    check(lib, code, "flash_fwd", _regs(lib, "fwd", d))
    launches_fwd += 1
    return out, lse


def flash_bwd_delta(out, dout):
    """delta = sum(out * dout, -1) as float32 [b, h, sq]: plain torch, as
    JAX computes it outside Pallas (flash_attention.py:398). The plain
    version of the first pass that ``flash_bwd_dq_cuda(..., out=out)``
    runs in its launch."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd(q, k, v, dout, lse, delta, q_seg, kv_seg):
    b, sq, sk, h, hk, d = _check(q, k, v, q_seg, kv_seg,
                                 extra=(dout, lse, delta))
    _require(dout.shape == q.shape and dout.dtype == q.dtype,
             "dout must be like q")
    _require(all(t.dtype == torch.float32 and tuple(t.shape) == (b, h, sq)
                 for t in (lse, delta)),
             "lse and delta must be float32 [batch, heads, seq_q]")
    return b, sq, sk, h, hk, d


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool,
                      scale: float, q_seg=None, kv_seg=None, out=None):
    """dq like q, given the forward's lse and delta. Given ``out`` (the
    forward's output, like q), the launch first writes delta = sum(out *
    dout, -1) into ``delta`` itself (float32 [b, h, sq], allocated by the
    caller), the first pass of the backward."""
    global launches_dq
    b, sq, sk, h, hk, d = _check_bwd(q, k, v, dout, lse, delta, q_seg,
                                     kv_seg)
    _require(out is None or (out.shape == q.shape and out.dtype == q.dtype
                             and out.device == q.device
                             and out.is_contiguous()
                             and out.data_ptr() % 16 == 0),
             "out must be like q, contiguous and 16-byte aligned")
    dq = torch.empty_like(q)
    sched, n, _, _ = _schedule("dq", q, b, sq, sk, h, hk, causal,
                               q_seg is not None)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.ptt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(out), _ptr(q_seg),
            _ptr(kv_seg), dq.data_ptr(), _ptr(sched), b, sq, sk, h, hk, d,
            _DTYPES[q.dtype], int(causal), n, *TILES["dq"], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, code, "flash_bwd_dq", _regs(lib, "dq", d))
    launches_dq += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool,
                       scale: float, q_seg=None, kv_seg=None):
    """(dk, dv) float32 [b, sk, hk, d], each summed over the kv-head's
    group of query heads, given the forward's lse and delta. A work list
    cut into pieces (fewer key tiles than SMs) writes partial sums to a
    workspace that the same launch adds up in piece order."""
    global launches_dkv
    b, sq, sk, h, hk, d = _check_bwd(q, k, v, dout, lse, delta, q_seg,
                                     kv_seg)
    dk = torch.empty((b, sk, hk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    sched, n, pieces, slots = _schedule("dkv", q, b, sq, sk, h, hk, causal,
                                        q_seg is not None)
    ws = None if pieces is None else torch.empty(
        (2, slots, b, sk, hk, d), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.ptt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            dk.data_ptr(), dv.data_ptr(), _ptr(ws), _ptr(pieces),
            _ptr(sched), b, sq, sk, h, hk, d, _DTYPES[q.dtype], int(causal),
            n, *TILES["dkv"], slots, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, code, "flash_bwd_dkv", _regs(lib, "dkv", d))
    launches_dkv += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, out, lse, dout, causal: bool, scale: float,
                   q_seg=None, kv_seg=None):
    """The backward given the forward's out and lse: (dq like q, dk and
    dv float32 [b, sk, hk, d]). The dq launch computes delta first."""
    b, sq, h = q.shape[0], q.shape[1], q.shape[2]
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale, q_seg,
                           kv_seg, out=out.contiguous())
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale,
                                q_seg, kv_seg)
    return dq, dk, dv


def smem_bytes(kernel: str, head_dim: int, dtype) -> int:
    """Dynamic shared memory of one block of kernel ("fwd", "dq" or
    "dkv") at head_dim and dtype, as the launcher asks for it (the
    Hopper kernel's for bfloat16 at HOPPER_HEAD_DIMS[kernel], the
    CUDA-core kernel's otherwise)."""
    return load_library().ptt_flash_smem_bytes(
        ("fwd", "dq", "dkv").index(kernel), head_dim, _DTYPES[dtype])


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention through the kernels. Forward saves
    (q, k, v, segment ids, out, lse); backward runs the dq and dk/dv
    kernels and returns dq in q's dtype and dk/dv cast from float32 to
    k's dtype (``_fa_bwd``, flash_attention.py:469-471)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        out, lse = flash_fwd_cuda(q, k, v, causal, scale, q_seg, kv_seg)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                    ctx.causal, ctx.scale, q_seg, kv_seg)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None
