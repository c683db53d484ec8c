"""Paged (block) KV cache and ragged attention over it.

Counterpart: ``paddle_tpu/ops/paged_attention.py``. A pool plane (one
layer's K or V) is a dense tensor [num_blocks, kv_heads, block_size,
head_dim], or for ``kv_quant="int8"`` an (int8 values, float32 scales
[num_blocks, kv_heads, block_size]) tuple with one absmax scale per
written slot and kv-head. Unlike the JAX package, whose arrays are
immutable, the port updates the pool IN PLACE (``reshape_and_cache`` is
an ``index_put_``), so a serving step never copies a pool.

``ragged_paged_attention`` sends CUDA tensors to the hand-written kernel
(``ops/cuda/ragged_paged_attention.py``) and CPU tensors to its plain
version ``ragged_paged_attention_reference``; there is no other switch.
``paged_attention_decode`` (one token per sequence, the dense engine's
decode) sends a CUDA tensor with an fp pool to its own kernel
(``ops/cuda/paged_attention_decode.py``), a CUDA tensor with an int8
pool to the ragged kernel with one row per sequence (the JAX package
computes quantized dense decode as that ragged call too), and CPU
tensors to ``paged_attention_decode_reference``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["KVCacheExhausted", "PagedKVCache", "pool_index",
           "quantize_kv_rows", "paged_attention_decode",
           "paged_attention_decode_reference", "ragged_paged_attention",
           "ragged_paged_attention_reference", "reshape_and_cache"]

# head dims the dense decode route takes on the card (the JAX gate's)
DECODE_HEAD_DIMS = (64, 128, 256)


def _plane_values(plane):
    """The value tensor of a pool plane (tuple-aware)."""
    return plane[0] if isinstance(plane, tuple) else plane


def quantize_kv_rows(x):
    """Per-row-per-kv-head symmetric absmax int8 of an append batch x
    [n, kv_heads, head_dim]. Returns (int8 [n, kv_heads, head_dim],
    float32 scales [n, kv_heads]). ``torch.round`` rounds half to even,
    as ``jnp.round`` does, so values and scales are bit-identical to the
    JAX package's on the same input."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale


def _dequantize_gather(plane, idx):
    """Gather pages ``idx`` of a pool plane, with the int8 dequant fused
    into the gather. Page ids are CLIPPED into the pool, as the JAX
    gather's mode="clip": unused table entries may hold any id, and the
    per-position mask discards what a clipped read returns."""
    vals = _plane_values(plane)
    idx = idx.long().clamp(0, vals.shape[0] - 1)
    if isinstance(plane, tuple):
        return vals[idx].to(torch.float32) * plane[1][idx][..., None]
    return vals[idx]


class KVCacheExhausted(RuntimeError):
    """The block pool cannot satisfy an allocation."""


def pool_index(slot_mapping, block_size: int, kv_heads: int):
    """The (block, kv-head, offset) index of flat slots into a pool plane,
    shaped to broadcast over [n, kv_heads]."""
    slot_mapping = slot_mapping.long()
    return ((slot_mapping // block_size)[:, None],
            torch.arange(kv_heads, device=slot_mapping.device)[None, :],
            (slot_mapping % block_size)[:, None])


def reshape_and_cache(k, v, k_cache, v_cache, slot_mapping, index=None):
    """Write this step's K/V ([n, kv_heads, head_dim]) into the pool at
    flat slots (block_id * block_size + offset), IN PLACE, and return
    the (same) planes. A quantized plane gets the int8 quantize fused
    into the append: values and per-slot scales are written together.
    ``index``: the slots' ``pool_index``, when the caller shares one
    across layers."""
    if index is None:
        _, h, bs, _ = _plane_values(k_cache).shape
        index = pool_index(slot_mapping, bs, h)
    if isinstance(k_cache, tuple):
        for x, (pv, ps) in ((k, k_cache), (v, v_cache)):
            xq, xs = quantize_kv_rows(x)
            pv.index_put_(index, xq)
            ps.index_put_(index, xs)
        return k_cache, v_cache
    k_cache.index_put_(index, k.to(k_cache.dtype))
    v_cache.index_put_(index, v.to(v_cache.dtype))
    return k_cache, v_cache


def ragged_paged_attention_reference(q, k_cache, v_cache, block_tables,
                                     row_seq, row_ctx,
                                     scale: Optional[float] = None):
    """Ragged mixed prefill+decode attention over the paged pool — the
    plain version of the CUDA kernel.

    q [rows, num_heads, head_dim]; pools [num_blocks, kv_heads,
    block_size, head_dim] (or int8 tuples); block_tables [num_seqs,
    max_pages] int32; row_seq [rows]: the table row each q row reads;
    row_ctx [rows]: pool positions < row_ctx are visible (the context
    bound and the intra-chunk causal mask at once). Online softmax over
    a page walk bounded by the batch's longest visible context; rows
    with row_ctx <= 0 come out exactly zero.
    Returns [rows, num_heads, head_dim] in q's dtype."""
    r, nh, d = q.shape
    nb, kvh, bs, _ = _plane_values(k_cache).shape
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = nh // kvh
    tables_r = block_tables[row_seq.long()]                 # [r, P]
    qg = q.reshape(r, kvh, group, d).to(torch.float32)
    ctx = row_ctx[:, None, None, None]
    m = torch.full((r, kvh, group), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((r, kvh, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((r, kvh, group, d), dtype=torch.float32,
                      device=q.device)
    max_ctx = int(row_ctx.max()) if r else 0
    n_pages = min(-(-max_ctx // bs), max_pages)
    for p in range(max(0, n_pages)):
        pids = tables_r[:, p]
        k = _dequantize_gather(k_cache, pids).to(torch.float32)
        v = _dequantize_gather(v_cache, pids).to(torch.float32)
        sc = torch.einsum("rkgd,rksd->rkgs", qg, k) * scale
        pos = p * bs + torch.arange(bs, device=q.device)
        mask = pos[None, None, None, :] < ctx
        sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        prob = torch.where(mask, torch.exp(sc - m_new[..., None]),
                           torch.zeros_like(sc))
        corr = torch.exp(m - m_new)
        l = l * corr + prob.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("rkgs,rksd->rkgd",
                                                   prob, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(r, nh, d).to(q.dtype)


def ragged_paged_attention(q, k_cache, v_cache, block_tables, row_seq,
                           row_ctx, scale: Optional[float] = None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        from .cuda.ragged_paged_attention import ragged_paged_attention_cuda
        return ragged_paged_attention_cuda(q, k_cache, v_cache,
                                           block_tables, row_seq, row_ctx,
                                           scale)
    return ragged_paged_attention_reference(q, k_cache, v_cache,
                                            block_tables, row_seq, row_ctx,
                                            scale)


def paged_attention_decode_reference(q, k_cache, v_cache, block_tables,
                                     context_lens,
                                     scale: Optional[float] = None):
    """One-token decode attention over the paged pool — the plain version
    of the CUDA decode kernel.

    q [batch, num_heads, head_dim]; pools as for the ragged call;
    block_tables [batch, max_blocks] int32; context_lens [batch] int32:
    visible tokens per sequence, this one included. As in the JAX
    package, this is the ragged oracle with one row per sequence
    (``row_seq = arange(batch)``, ``row_ctx = context_lens``).
    Returns [batch, num_heads, head_dim]."""
    b = q.shape[0]
    return ragged_paged_attention_reference(
        q, k_cache, v_cache, block_tables,
        torch.arange(b, dtype=torch.int32, device=q.device), context_lens,
        scale)


def paged_attention_decode(q, k_cache, v_cache, block_tables, context_lens,
                           scale: Optional[float] = None):
    """One-token decode attention (see the reference for the signature).
    A CUDA q with an fp pool: the decode kernel; with an (int8, scales)
    pool: the ragged kernel with rows ``arange(batch)``; head dims 64,
    128 and 256 only. A CPU q: the plain version. Anything else
    raises."""
    if q.is_cuda:
        if q.shape[-1] not in DECODE_HEAD_DIMS:
            raise ValueError(f"paged_attention_decode: head_dim "
                             f"{q.shape[-1]} not in {DECODE_HEAD_DIMS}")
        if isinstance(k_cache, tuple):
            from .cuda.ragged_paged_attention import \
                ragged_paged_attention_cuda
            rows = torch.arange(q.shape[0], dtype=torch.int32,
                                device=q.device)
            return ragged_paged_attention_cuda(q, k_cache, v_cache,
                                               block_tables, rows,
                                               context_lens, scale)
        from .cuda.paged_attention_decode import paged_attention_decode_cuda
        return paged_attention_decode_cuda(q, k_cache, v_cache,
                                           block_tables, context_lens, scale)
    if q.device.type == "cpu":
        return paged_attention_decode_reference(q, k_cache, v_cache,
                                                block_tables, context_lens,
                                                scale)
    raise ValueError(f"paged_attention_decode: unsupported device "
                     f"{q.device}")


class PagedKVCache:
    """Host-side block allocator plus the device block pool.

    Each sequence owns a list of physical blocks (its table) and a
    context length; ``extend`` hands out one flat slot per new token.
    Pools are per-layer lists of planes on ``device`` (``None`` means
    cuda), updated in place by ``reshape_and_cache``. Prefix caching,
    the cached-block LRU, ``rollback`` and the LoRA plane of the JAX
    allocator come with later slices of the port."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.float32,
                 kv_quant: Optional[str] = None, device=None):
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        dev = resolve_device(device)
        self.device = dev
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_quant = kv_quant
        shape = (num_blocks, kv_heads, block_size, head_dim)

        def _plane():
            if kv_quant == "int8":
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], dtype=torch.float32,
                                    device=dev))
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.k = [_plane() for _ in range(num_layers)]
        self.v = [_plane() for _ in range(num_layers)]
        self._free = list(range(num_blocks - 1, -1, -1))
        self._tables: dict = {}   # seq_id -> [block ids]
        self._lens: dict = {}     # seq_id -> context length
        self._ref: dict = {}      # block -> ref count (present iff > 0)

    def _take_block(self) -> int:
        if self._free:
            return self._free.pop()
        raise KVCacheExhausted("KV cache exhausted")

    def allocate(self, seq_id: int, num_tokens: int):
        """Reserve blocks for a sequence of num_tokens."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        needed = -(-num_tokens // self.block_size)
        if self.available_blocks < needed:
            raise KVCacheExhausted(
                f"KV cache exhausted: need {needed} blocks, "
                f"{self.available_blocks} free")
        blocks = [self._take_block() for _ in range(needed)]
        for b in blocks:
            self._ref[b] = 1
        self._tables[seq_id] = blocks
        self._lens[seq_id] = 0
        return self._tables[seq_id]

    def extend(self, seq_id: int) -> int:
        """Room for one more token; returns its flat slot id."""
        pos = self._lens[seq_id]
        blocks = self._tables[seq_id]
        if pos >= len(blocks) * self.block_size:
            if self.available_blocks == 0:
                raise KVCacheExhausted("KV cache exhausted on extend")
            blk = self._take_block()
            self._ref[blk] = 1
            blocks.append(blk)
        self._lens[seq_id] = pos + 1
        block = blocks[pos // self.block_size]
        return block * self.block_size + pos % self.block_size

    def free(self, seq_id: int):
        """Release a sequence's blocks; a no-op for an unknown seq_id."""
        blocks = self._tables.pop(seq_id, None)
        self._lens.pop(seq_id, None)
        if blocks is None:
            return
        returned = []
        for b in reversed(blocks):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                returned.append(b)
        self._free.extend(returned)

    def context_len(self, seq_id: int) -> int:
        return self._lens.get(seq_id, 0)

    def seq_blocks(self, seq_id: int):
        """The sequence's physical block list (a copy)."""
        return list(self._tables[seq_id])

    def block_table(self, seq_id: int, max_blocks: int) -> np.ndarray:
        t = self._tables[seq_id]
        out = np.zeros(max_blocks, np.int32)
        out[:len(t)] = t
        return out

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Blocks a fresh allocation can claim (no cached blocks yet)."""
        return len(self._free)

    def debug_check(self):
        """Pool invariant: free + referenced == num_blocks, disjoint,
        table contents matching the ref counts, every length inside its
        table. Raises AssertionError on a violation."""
        free = set(self._free)
        referenced = set(self._ref)
        assert len(free) == len(self._free), "duplicate free blocks"
        assert not free & referenced, "block both free and referenced"
        assert len(free) + len(referenced) == self.num_blocks, (
            f"pool leak: free={len(free)} referenced={len(referenced)} "
            f"!= {self.num_blocks}")
        counts = Counter()
        for t in self._tables.values():
            counts.update(t)
        assert dict(counts) == self._ref, "ref counts out of sync"
        assert set(self._lens) == set(self._tables), \
            "length/table bookkeeping out of sync"
        for s, t in self._tables.items():
            ln = self._lens[s]
            assert t and 0 <= ln <= len(t) * self.block_size, (
                f"seq {s}: context length {ln} outside its "
                f"{len(t)}-block table")
            assert all(0 <= b < self.num_blocks for b in t), \
                f"seq {s}: block id out of range"
