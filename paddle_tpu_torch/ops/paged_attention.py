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
from collections import Counter, OrderedDict
from typing import List, Optional, Sequence, Tuple

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
    Pools are lists of shards, each a per-layer list of planes on its
    device: ``k[s][li]`` / ``v[s][li]`` (one shard on ``device``,
    ``None`` meaning cuda, unless ``devices`` is given), updated in
    place by ``reshape_and_cache``.

    Tensor parallelism (``devices``, one per shard): the planes split
    their kv-head dim (``distributed/spec_layout.py``, cache_k / cache_v
    and the int8 scales), shard s holding heads s * kvh / n .. on
    ``devices[s]``. One set of block tables, one prefix index and one
    allocator serve every shard: allocation is host-side and knows no
    shards. ``pool_bytes`` counts the whole (global) pool, as JAX's.

    Automatic prefix caching, as in the JAX allocator: every block
    carries a ref count, and a FULL block whose tokens are known gets a
    chain hash ``hash((parent_hash, block_tokens))`` in a hash-to-block
    index. Full blocks are immutable once written, so a prompt that
    shares a block-aligned prefix with earlier content splices those
    blocks into its table (``allocate_with_prefix``: a ref-count bump,
    no copy). A freed block that still carries a hash is PARKED in an
    LRU of cached, unreferenced blocks; it is evicted (its hash dropped)
    only when the free list runs dry. A ``salt`` (the serving engine
    passes a request's adapter id) roots a chain of its own, so equal
    prompts under two adapters never share blocks.

    Adapter paging (``inference/lora.py``): ``enable_lora_pool`` adds a
    [num_blocks, page_elems] float32 plane whose rows hold adapter pages
    at the block ids an adapter's pseudo-sequence owns; synthetic page
    hashes park an unused adapter in the LRU (``register_page_hashes``,
    ``lookup_hash``, ``adopt_cached_blocks``). The scratch block's row
    stays zero: it is the null adapter."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.float32,
                 kv_quant: Optional[str] = None, device=None,
                 devices: Optional[Sequence] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        devs = ([resolve_device(device)] if devices is None
                else [resolve_device(d) for d in devices])
        if kv_heads % len(devs):
            raise ValueError(f"{kv_heads} kv heads do not divide over "
                             f"{len(devs)} shards")
        self.device = devs[0]
        self.devices = devs
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.kv_quant = kv_quant
        shape = (num_blocks, kv_heads // len(devs), block_size, head_dim)

        def _plane(dev):
            if kv_quant == "int8":
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], dtype=torch.float32,
                                    device=dev))
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.k = [[_plane(d) for _ in range(num_layers)] for d in devs]
        self.v = [[_plane(d) for _ in range(num_layers)] for d in devs]
        self._free = list(range(num_blocks - 1, -1, -1))
        self._tables: dict = {}   # seq_id -> [block ids]
        self._lens: dict = {}     # seq_id -> context length
        self._ref: dict = {}      # block -> ref count (present iff > 0)
        # prefix index: chain hash <-> block, and the LRU of cached,
        # unreferenced blocks (insertion order is park order)
        self._hash_of: dict = {}  # block -> chain hash
        self._block_of: dict = {}  # chain hash -> block
        self._lru: OrderedDict = OrderedDict()   # block -> None
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.prefix_evictions = 0
        # the adapter-page plane (enable_lora_pool)
        self.lora_pool: Optional[torch.Tensor] = None
        self.lora_page_elems = 0
        # fault injection (utils/chaos.py): called at the top of every
        # _take_block, before any mutation, so an injected
        # KVCacheExhausted leaves the pool untouched
        self.fault_hook = None
        # telemetry (utils/telemetry.py): alloc, evict, splice and
        # rollback land as tracer events on the owning engine's pid
        # (ServingEngine.set_telemetry attaches it; None: no-op)
        self.tracer = None
        self.trace_pid = 0

    # -- allocation ----------------------------------------------------------
    def _take_block(self) -> int:
        """Pop a writable block: the free list first, then (free list
        dry) the least recently parked cached block, whose hash is
        dropped so it can never be spliced again."""
        if self.fault_hook is not None:
            self.fault_hook()
        if self._free:
            return self._free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)
            self._block_of.pop(self._hash_of.pop(blk), None)
            self.prefix_evictions += 1
            if self.tracer is not None:
                self.tracer.event("kv_evict", pid=self.trace_pid,
                                  block=int(blk))
            return blk
        raise KVCacheExhausted("KV cache exhausted")

    def _take_blocks(self, n: int) -> List[int]:
        """Pop n blocks, all or none: a failure part-way returns the
        blocks already taken to the free list before it raises."""
        taken: List[int] = []
        try:
            for _ in range(n):
                taken.append(self._take_block())
        except RuntimeError:
            self._free.extend(taken)
            raise
        return taken

    def allocate(self, seq_id: int, num_tokens: int):
        """Reserve blocks for a sequence of num_tokens."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        needed = -(-num_tokens // self.block_size)
        if self.available_blocks < needed:
            raise KVCacheExhausted(
                f"KV cache exhausted: need {needed} blocks, "
                f"{self.available_blocks} free")
        blocks = self._take_blocks(needed)
        for b in blocks:
            self._ref[b] = 1
        self._tables[seq_id] = blocks
        self._lens[seq_id] = 0
        if self.tracer is not None:
            self.tracer.event("kv_alloc", pid=self.trace_pid,
                              seq=int(seq_id), blocks=int(needed),
                              dtype=self.pool_dtype)
        return self._tables[seq_id]

    # -- prefix caching --------------------------------------------------------
    def _chain_hashes(self, tokens, salt=None) -> List[int]:
        """The chain hash of each FULL block of ``tokens``:
        h_i = hash((h_{i-1}, tokens of block i)), h_-1 = None, or
        ("#tenant", salt) with a salt. Python's hash of int tuples is
        not salted per process, so these equal the JAX allocator's for
        the same tokens and salt (a string salt hashes differently in
        each process, in both packages)."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        out: List[int] = []
        h = None if salt is None else ("#tenant", salt)
        for i in range(len(toks) // bs):
            h = hash((h, tuple(toks[i * bs:(i + 1) * bs])))
            out.append(h)
        return out

    def _match(self, hashes: List[int],
               n_tokens: int) -> List[Tuple[int, int]]:
        matched: List[Tuple[int, int]] = []
        for h in hashes:
            blk = self._block_of.get(h)
            if blk is None:
                break
            matched.append((h, blk))
        if matched and len(matched) * self.block_size >= n_tokens:
            matched.pop()
        return matched

    def match_prefix(self, tokens, salt=None) -> List[Tuple[int, int]]:
        """The longest chain of cached full blocks covering a prefix of
        ``tokens`` (under ``salt``), as [(hash, block)], without
        mutation. At least one token is left uncovered: the last
        position's logits must be computed."""
        return self._match(self._chain_hashes(tokens, salt), len(tokens))

    def _prefix_capacity(self, matched, num_tokens: int):
        """(fresh blocks needed, blocks claimable) for an allocation that
        splices ``matched``: matched blocks cost nothing, and cached
        blocks outside the match can be evicted on demand."""
        needed = -(-num_tokens // self.block_size) - len(matched)
        evictable = len(self._lru) - sum(1 for _, b in matched
                                         if b in self._lru)
        return needed, len(self._free) + evictable

    def can_allocate_with_prefix(self, tokens, num_tokens: int,
                                 salt=None) -> bool:
        """The worst-case admission check, crediting reusable blocks."""
        needed, avail = self._prefix_capacity(
            self.match_prefix(tokens, salt), num_tokens)
        return avail >= needed

    def allocate_with_prefix(self, seq_id: int, tokens,
                             num_tokens: Optional[int] = None, salt=None):
        """Reserve blocks for a prompt of ``tokens`` (worst-case capacity
        ``num_tokens`` >= len(tokens)), splicing in every cached block of
        the longest matching block-aligned prefix under ``salt``. Returns
        (reused_blocks, n_cached_tokens); the context length starts at
        n_cached_tokens. The suffix's own full prompt blocks enter the
        hash index at once (their content is fixed by the prompt); the
        caller orders a reader's dispatches after the writer's. A
        refusal raises before any mutation."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        n_tok = len(tokens) if num_tokens is None else int(num_tokens)
        hashes = self._chain_hashes(tokens, salt)
        matched = self._match(hashes, len(tokens))
        needed_new, avail = self._prefix_capacity(matched, n_tok)
        if avail < needed_new:
            raise KVCacheExhausted(
                f"KV cache exhausted: need {needed_new} blocks, "
                f"{avail} free")
        reused = []
        for _, blk in matched:          # revive before taking fresh ones,
            self._lru.pop(blk, None)    # so eviction cannot steal a
            self._ref[blk] = self._ref.get(blk, 0) + 1   # matched block
            reused.append(blk)
        try:
            fresh = self._take_blocks(needed_new)
        except RuntimeError:
            # an injected fault part-way: park the revived blocks again,
            # so the refusal leaves the pool as it was
            for blk in reused:
                self._ref[blk] -= 1
                if self._ref[blk] == 0:
                    del self._ref[blk]
                    self._lru[blk] = None
            raise
        for b in fresh:
            self._ref[b] = 1
        table = reused + fresh
        self._tables[seq_id] = table
        n_cached = len(reused) * self.block_size
        self._lens[seq_id] = n_cached
        self.prefix_query_tokens += len(tokens)
        self.prefix_hit_tokens += n_cached
        if self.tracer is not None:
            self.tracer.event("kv_alloc", pid=self.trace_pid,
                              seq=int(seq_id), blocks=int(needed_new),
                              spliced=len(reused), dtype=self.pool_dtype)
            if reused:
                self.tracer.event(
                    "kv_splice", pid=self.trace_pid, seq=int(seq_id),
                    blocks=len(reused), tokens=int(n_cached))
        for i in range(len(reused), len(hashes)):
            h, b = hashes[i], table[i]
            if h not in self._block_of and b not in self._hash_of:
                self._block_of[h] = b
                self._hash_of[b] = h
        return reused, n_cached

    def clear_prefix_cache(self):
        """Return every cached (unreferenced) block to the free list and
        forget every hash."""
        self._free.extend(self._lru)
        self._lru.clear()
        self._hash_of.clear()
        self._block_of.clear()

    def reset_prefix_stats(self):
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.prefix_evictions = 0

    def unregister_block_hashes(self, blocks):
        """Drop the hash registrations of ``blocks`` (a prefill unwound
        before the dispatch covering them: their content will never be
        written). Only a registration that points at the block goes; a
        parked block that loses its hash returns to the free list."""
        for b in blocks:
            h = self._hash_of.get(b)
            if h is not None and self._block_of.get(h) == b:
                del self._hash_of[b]
                del self._block_of[h]
                if b in self._lru:
                    del self._lru[b]
                    self._free.append(b)

    # -- adapter paging (inference/lora.py) -------------------------------------
    def enable_lora_pool(self, page_elems: int):
        """Add the adapter-page plane, [num_blocks, page_elems] float32
        of zeros (the scratch block's row stays zero: the null adapter).
        Idempotent for one page size; another raises."""
        if self.lora_pool is not None:
            if self.lora_page_elems != int(page_elems):
                raise ValueError(
                    f"lora pool already enabled with page_elems="
                    f"{self.lora_page_elems}, got {page_elems}")
            return
        self.lora_page_elems = int(page_elems)
        self.lora_pool = torch.zeros((self.num_blocks, self.lora_page_elems),
                                     dtype=torch.float32, device=self.device)

    def write_lora_pages(self, blocks: List[int], pages):
        """Upload host pages ([n, page_elems]) into the plane rows of
        ``blocks``. A plain overwrite, so a repeated upload is safe."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.device)
        src = torch.from_numpy(np.ascontiguousarray(pages, np.float32))
        self.lora_pool.index_copy_(0, idx, src.to(self.device))

    def lookup_hash(self, h) -> Optional[int]:
        """The block registered under hash ``h`` (a prompt chain hash or
        an adapter page hash), else None."""
        return self._block_of.get(h)

    def register_page_hashes(self, blocks: List[int], hashes):
        """Register synthetic hashes on referenced blocks (an adapter
        upload), so the blocks park in the LRU when their owner frees;
        hashes or blocks already registered are skipped."""
        for b, h in zip(blocks, hashes):
            if h not in self._block_of and b not in self._hash_of:
                self._block_of[h] = b
                self._hash_of[b] = h

    def adopt_cached_blocks(self, seq_id: int, blocks: List[int]):
        """Claim parked blocks as ``seq_id``'s table (an adapter revived
        without an upload). All or nothing: every block must be
        parked."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        for b in blocks:
            if b not in self._lru:
                raise KeyError(f"block {b} is not parked in the "
                               f"cached-LRU")
        for b in blocks:
            del self._lru[b]
            self._ref[b] = 1
        self._tables[seq_id] = list(blocks)
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

    def rollback(self, seq_id: int, new_len: int, min_blocks: int = 0):
        """Roll a live sequence's context length back to ``new_len`` (the
        speculative-decoding unwind): the next extend re-issues the
        rescinded slots. Blocks wholly past the new length leave the
        table (at ref 0 straight to the free list, never the LRU, with
        any hash dropped), but never below ``min_blocks`` blocks, so an
        admission's up-front reservation survives."""
        blocks = self._tables[seq_id]
        cur = self._lens[seq_id]
        new_len = int(new_len)
        if not 0 <= new_len <= cur:
            raise ValueError(
                f"rollback(seq {seq_id}) to {new_len} outside "
                f"[0, {cur}]")
        keep = max(1, -(-new_len // self.block_size), int(min_blocks))
        dropped = blocks[keep:]
        del blocks[keep:]
        self._lens[seq_id] = new_len
        returned = []
        for b in reversed(dropped):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                h = self._hash_of.pop(b, None)
                if h is not None:
                    self._block_of.pop(h, None)
                returned.append(b)
        self._free.extend(returned)
        if self.tracer is not None:
            self.tracer.event(
                "kv_rollback", pid=self.trace_pid, seq=int(seq_id),
                new_len=new_len, dropped=len(dropped))

    def free(self, seq_id: int):
        """Release a sequence: ref-- on each block; a block reaching ref 0
        is parked in the LRU when it carries a hash, else returned to
        the free list. Blocks park leaf-first, so eviction eats a chain
        from its tail and the shared head stays matchable longest. A
        no-op for an unknown seq_id."""
        blocks = self._tables.pop(seq_id, None)
        self._lens.pop(seq_id, None)
        if blocks is None:
            return
        returned = []
        for b in reversed(blocks):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._hash_of:
                    self._lru[b] = None
                else:
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

    # -- the pool's footprint (JAX ops/paged_attention.py:745-770) -----------
    @property
    def pool_dtype(self) -> str:
        """'int8' for the quantized layout, else the plane dtype's name
        ('float32', 'bfloat16'), as JAX's ``np.dtype`` names it."""
        if self.kv_quant == "int8":
            return "int8"
        return str(_plane_values(self.k[0][0]).dtype) \
            .replace("torch.", "")

    def pool_bytes(self) -> int:
        """Bytes of every K and V plane of every shard, int8 scales
        included."""
        total = 0
        for plane in [p for planes in self.k + self.v
                      for p in planes]:
            for a in plane if isinstance(plane, tuple) else (plane,):
                total += a.numel() * a.element_size()
        return total

    def bytes_per_token(self) -> float:
        """KV bytes one token slot costs over all layers (K and V, scales
        included): ``pool_bytes`` over the pool's slot count."""
        return self.pool_bytes() / float(self.num_blocks * self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Blocks parked in the prefix-cache LRU (reusable, evictable)."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Blocks a fresh allocation can claim: free and evictable."""
        return len(self._free) + len(self._lru)

    def debug_check(self):
        """Pool invariant: free + cached + referenced == num_blocks, the
        three disjoint, table contents matching the ref counts, the hash
        index a bijection with every cached block hashed, every length
        inside its table. Raises AssertionError on a violation."""
        free = set(self._free)
        cached = set(self._lru)
        referenced = set(self._ref)
        assert len(free) == len(self._free), "duplicate free blocks"
        assert not free & cached and not free & referenced \
            and not cached & referenced, "block in two pools at once"
        assert len(free) + len(cached) + len(referenced) \
            == self.num_blocks, (
                f"pool leak: free={len(free)} cached={len(cached)} "
                f"referenced={len(referenced)} != {self.num_blocks}")
        counts = Counter()
        for t in self._tables.values():
            counts.update(t)
        assert dict(counts) == self._ref, "ref counts out of sync"
        assert all(self._block_of.get(h) == b
                   for b, h in self._hash_of.items()) \
            and len(self._block_of) == len(self._hash_of), \
            "hash index not a bijection"
        assert all(b in self._hash_of for b in cached), \
            "cached block without a hash"
        assert set(self._lens) == set(self._tables), \
            "length/table bookkeeping out of sync"
        for s, t in self._tables.items():
            ln = self._lens[s]
            assert t and 0 <= ln <= len(t) * self.block_size, (
                f"seq {s}: context length {ln} outside its "
                f"{len(t)}-block table")
            assert all(0 <= b < self.num_blocks for b in t), \
                f"seq {s}: block id out of range"
