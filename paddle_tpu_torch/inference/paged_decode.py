"""Paged-KV decoder for Llama-family models: the ragged serving step and
the dense per-phase programs.

Counterpart: ``paddle_tpu/inference/paged_decode.py`` (single device
only: no tensor parallel, speculative-decoding or LoRA mixins). The
decoder holds a dict of tensors with
the same shape as the JAX ``weights`` tree — ``embed``, ``layers`` (each
with ``ln1``, ``ln2``, fused ``wqkv``, ``wo``, fused ``wgu``, ``wd``),
``norm`` and ``head`` — so weights carry across one-to-one. Matmul
weights are [in, out]; a quantized one is a ``QWeight`` whose ``kind``
names its layout.

``_ragged_logits`` is one ministep of the ragged serving engine: every
row's K/V is written to the pool (in place) before attention, so the
per-row visible length ``row_ctx`` is the whole causal mask.

The dense per-phase programs serve ``ServingEngine(ragged=False)`` and
``generate()``: ``_prefill_impl`` (a bucketed, right-padded prompt
through causal flash attention), ``_prefill_prefix_impl`` (a prompt
chunk at an offset, attending the pages already written as its prefix;
with ``logits=False`` it is JAX's no-sample ``_prefill_chunk_impl``)
and ``_decode_logits`` (one token per sequence through
``paged_attention_decode``). JAX compiles each as
one program; here each is a Python function that launches its kernels
in order, and JAX's ``lax.scan`` over decode steps is a Python loop
whose sampled token stays on the device from step to step.
"""
from __future__ import annotations

import math
import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.llama import LlamaConfig
from ..ops.cuda.decode_matmul import (_MAX_ROWS, decode_matmul,
                                      unpack_int4_halves)
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (PagedKVCache, _dequantize_gather,
                                   paged_attention_decode, pool_index,
                                   ragged_paged_attention,
                                   reshape_and_cache)
from ..ops.qweight import QWeight
from ..ops.rms_norm import rms_norm
from ..ops.rope import build_rope_cache, rotate_half

__all__ = ["PagedLlamaDecoder"]

_WEIGHT_DTYPES = (None, "int8", "int4")


def _quantize_w(w) -> QWeight:
    """Per-output-channel symmetric absmax int8 over the in dim. Bit-
    identical to the JAX ``_quantize_w``: the same float32 divisions, and
    ``torch.round`` rounds half to even as ``jnp.round`` does."""
    w = w.to(torch.float32)
    scale = w.abs().amax(dim=0) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    wi = torch.clamp(torch.round(w / scale[None, :]), -127, 127) \
        .to(torch.int8)
    return QWeight(wi, scale, "int8")


def _quantize_w4_halves(w) -> QWeight:
    """int4 with HALVES packing: packed row r holds in-row r (low nibble)
    and in-row r + K/2 (high nibble). Bit-identical to the JAX
    ``_quantize_w4_halves`` (round half to even in both)."""
    w = w.to(torch.float32)
    if w.shape[0] % 2:
        raise ValueError(f"int4 packing needs even in_features, "
                         f"got {w.shape[0]}")
    scale = w.abs().amax(dim=0) / 7.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    wi = torch.clamp(torch.round(w / scale[None, :]), -8, 7) \
        .to(torch.int8).view(torch.uint8)
    half = w.shape[0] // 2
    packed = (wi[:half] & 0x0F) | ((wi[half:] & 0x0F) << 4)
    return QWeight(packed.view(torch.int8), scale, "int4_halves")


_QUANTIZERS = {None: lambda w: w, "int8": _quantize_w,
               "int4": _quantize_w4_halves}


def _mm(x, w):
    """x @ w for a dense [in, out] weight or a QWeight. int4 calls with at
    most 32 activation rows go to the weight-streaming kernel (its plain
    version on the CPU), which raises on a CUDA operand it does not
    take; larger int4 calls split the contraction into the two nibble
    halves and leave both products to ``torch.matmul``, as the JAX
    package leaves them to XLA. int8 and dense weights are plain
    products, as in the JAX ``_mm``."""
    if isinstance(w, QWeight):
        w.check()
        if w.in_features != x.shape[-1]:
            raise ValueError(f"_mm: x in-dim {x.shape[-1]} does not match "
                             f"{w.kind} weight in-dim {w.in_features}")
        if w.kind == "int4_halves":
            lead = x.shape[:-1]
            rows = x.numel() // x.shape[-1]
            if 1 <= rows <= _MAX_ROWS:
                return decode_matmul(x.reshape(rows, x.shape[-1]),
                                     w).reshape(*lead, -1)
            lo, hi = unpack_int4_halves(w.q, x.dtype)
            half = x.shape[-1] // 2
            y = x[..., :half] @ lo + x[..., half:] @ hi
            return y * w.scale.to(x.dtype)
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


def _prefix_suffix_attention(q, k_suf, v_suf, k_pre, v_pre, n_cached,
                             scale: Optional[float] = None):
    """Causal attention of a SUFFIX prefill over a cached prefix, in
    float32 (the JAX function of the same name is einsums too, so no
    kernel belongs to it).

    The suffix's queries sit at positions ``n_cached + i``; their keys
    are the prefix K/V (gathered pool pages, flattened) then the
    suffix's own. Every prefix key at a position < n_cached is visible
    to every suffix query, and suffix against suffix is causal, which
    also hides right-padded rows from real queries.
    q / k_suf / v_suf [b, s, (kv)h, d]; k_pre / v_pre [b, kvh, P, d];
    n_cached [b] int32. Returns [b, s, nh, d] in q's dtype."""
    b, s, nh, d = q.shape
    kvh = k_suf.shape[2]
    group = nh // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    p = k_pre.shape[2]
    dev = q.device
    qg = q.reshape(b, s, kvh, group, d).to(torch.float32)
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    sp = torch.einsum("bskgd,bkpd->bskgp", qg,
                      k_pre.to(torch.float32)) * scale
    pvalid = torch.arange(p, device=dev)[None] < n_cached.long()[:, None]
    sp = torch.where(pvalid[:, None, None, None, :], sp, neg)
    ss = torch.einsum("bskgd,btkd->bskgt", qg,
                      k_suf.to(torch.float32)) * scale
    causal = torch.arange(s, device=dev)[:, None] \
        >= torch.arange(s, device=dev)[None, :]
    ss = torch.where(causal[None, :, None, None, :], ss, neg)
    probs = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
    out = torch.einsum("bskgp,bkpd->bskgd", probs[..., :p],
                       v_pre.to(torch.float32)) \
        + torch.einsum("bskgt,btkd->bskgd", probs[..., p:],
                       v_suf.to(torch.float32))
    return out.reshape(b, s, nh, d).to(q.dtype)


def _gather_prefix_pages(pool, prefix_tables):
    """A pool plane [num_blocks, kvh, bs, d] (or an int8 tuple, which
    dequantizes at the gather) and page ids [b, P] -> the rows' prefix
    K/V as one contiguous [b, kvh, P * bs, d]."""
    g = _dequantize_gather(pool, prefix_tables)    # [b, P, kvh, bs, d]
    b, p, kvh, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, kvh, p * bs, d)


def _fuse_out(ws):
    """Concatenate weights along the OUT dim (dense, or QWeights of one
    kind with matching in-dims)."""
    if isinstance(ws[0], QWeight):
        kinds = {w.kind for w in ws}
        if len(kinds) != 1:
            raise ValueError(f"cannot fuse QWeights of kinds {kinds}")
        return QWeight(torch.cat([w.q for w in ws], dim=1),
                       torch.cat([w.scale for w in ws], dim=0),
                       ws[0].kind)
    return torch.cat(ws, dim=1)


def _weight_specs(cfg):
    """(name, shape, quantized?) for every serving weight, in load
    order; [in, out] layout, head [hidden, vocab]."""
    hd = cfg.hidden_size // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    h, it = cfg.hidden_size, cfg.intermediate_size
    specs = [("embed", (cfg.vocab_size, h), False)]
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."
        specs += [(p + "ln1", (h,), False), (p + "ln2", (h,), False),
                  (p + "wq", (h, h), True), (p + "wk", (h, kv), True),
                  (p + "wv", (h, kv), True), (p + "wo", (h, h), True),
                  (p + "wg", (h, it), True), (p + "wu", (h, it), True),
                  (p + "wd", (it, h), True)]
    specs += [("norm", (h,), False), ("head", (h, cfg.vocab_size), True)]
    return specs


def _fuse_layers(weights):
    """Fuse q/k/v and gate/up along the out dim (idempotent)."""
    for lw in weights["layers"]:
        if "wq" in lw:
            lw["wqkv"] = _fuse_out([lw.pop("wq"), lw.pop("wk"),
                                    lw.pop("wv")])
            lw["wgu"] = _fuse_out([lw.pop("wg"), lw.pop("wu")])
    return weights


class PagedLlamaDecoder:
    """Paged-KV Llama decoder on one device (``device=None``: cuda)."""

    def __init__(self, cfg: LlamaConfig, weights: dict,
                 num_blocks: int = 512, block_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 weight_dtype: Optional[str] = None,
                 kv_quant: Optional[str] = None, device=None):
        if weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be None, 'int8' or "
                             f"'int4', got {weight_dtype!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.block_size = block_size
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_pages = max_pages_per_seq or \
            -(-cfg.max_position_embeddings // block_size)
        self.weight_dtype = weight_dtype
        self.kv_quant = kv_quant
        self.weights = _fuse_layers(weights)
        self.cache = PagedKVCache(
            num_layers=cfg.num_hidden_layers, num_blocks=num_blocks,
            block_size=block_size, kv_heads=cfg.num_key_value_heads,
            head_dim=self.head_dim, dtype=self.weights["embed"].dtype,
            kv_quant=kv_quant, device=self.device)
        cos, sin = build_rope_cache(cfg.max_position_embeddings,
                                    self.head_dim, cfg.rope_theta,
                                    torch.float32, device=self.device)
        self._cos = cos[0, :, 0, :]   # [max_len, head_dim]
        self._sin = sin[0, :, 0, :]

    # -- construction --------------------------------------------------------
    @classmethod
    def from_weight_loader(cls, cfg, load, weight_dtype: Optional[str] = None,
                           device=None, **kw):
        """Build from ``load(name, shape)``, which returns one raw [in, out]
        tensor per weight (names as in ``_weight_specs``). Each matmul
        weight is quantized on the device as it arrives and the full-
        precision original dropped, so the peak is about the quantized
        total plus one layer in full precision."""
        if weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be None, 'int8' or "
                             f"'int4', got {weight_dtype!r}")
        dev = resolve_device(device)
        qf = _QUANTIZERS[weight_dtype]
        layers = [dict() for _ in range(cfg.num_hidden_layers)]
        flat = {}
        for name, shape, is_mat in _weight_specs(cfg):
            arr = load(name, shape).to(dev)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"loader returned {tuple(arr.shape)} for "
                                 f"{name}; expected {shape}")
            val = qf(arr) if is_mat else arr
            if name.startswith("layers."):
                _, li, key = name.split(".")
                layers[int(li)][key] = val
            else:
                flat[name] = val
            del arr
        weights = {"embed": flat["embed"], "layers": layers,
                   "norm": flat["norm"], "head": flat["head"]}
        return cls(cfg, weights, weight_dtype=weight_dtype, device=dev,
                   **kw)

    @classmethod
    def from_config(cls, cfg, seed: int = 0, init_scale: float = 0.02,
                    device=None, **kw):
        """Randomly initialized decoder from a config: norm gains are
        ones, every other weight N(0, init_scale) in the config's dtype,
        drawn per weight from a ``torch.Generator`` on the device seeded
        by (seed, crc32(name)). Not the JAX package's threefry bits."""
        dev = resolve_device(device)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        gen = torch.Generator(device=dev)

        def load(name, shape):
            if len(shape) == 1:
                return torch.ones(shape, dtype=dtype, device=dev)
            gen.manual_seed((seed * 1000003
                             + (zlib.crc32(name.encode()) & 0x7FFFFFFF))
                            & 0x7FFFFFFFFFFFFFFF)
            return (torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=dev) * init_scale).to(dtype)

        return cls.from_weight_loader(cfg, load, device=dev, **kw)

    @classmethod
    def from_numpy_weights(cls, cfg, tree, weight_dtype: Optional[str] = None,
                           device=None, **kw):
        """Build from the JAX decoder's ``weights`` tree turned into numpy
        (see ``inference.weights.weights_from_numpy``)."""
        from .weights import weights_from_numpy
        dev = resolve_device(device)
        weights = weights_from_numpy(tree, weight_dtype=weight_dtype,
                                     device=dev)
        return cls(cfg, weights, weight_dtype=weight_dtype, device=dev,
                   **kw)

    # -- building blocks ------------------------------------------------------
    def _proj_qkv(self, w, hn):
        cfg = self.cfg
        nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       self.head_dim)
        qkv = _mm(hn, w["wqkv"])
        q, k, v = torch.split(qkv, [nh * hd, kvh * hd, kvh * hd], dim=-1)
        lead = hn.shape[:-1]
        return (q.reshape(*lead, nh, hd), k.reshape(*lead, kvh, hd),
                v.reshape(*lead, kvh, hd))

    def _mlp(self, w, hn):
        gu = _mm(hn, w["wgu"])
        g_, u_ = torch.split(gu, [self.cfg.intermediate_size,
                                  gu.shape[-1] - self.cfg.intermediate_size],
                             dim=-1)
        return _mm(F.silu(g_) * u_, w["wd"])

    def _rope_tables(self, positions, dtype):
        """(cos, sin) [*positions.shape, 1, head_dim] at positions, in
        dtype."""
        return (self._cos[positions][..., None, :].to(dtype),
                self._sin[positions][..., None, :].to(dtype))

    def _rope(self, x, positions, tables=None):
        """x [..., heads, head_dim] at positions broadcasting over its
        leading dims ([rows] for [rows, heads, head_dim], [s] or [b, s]
        for [b, s, heads, head_dim]); ``tables`` are the
        ``_rope_tables`` of those positions when already gathered."""
        cos, sin = tables or self._rope_tables(positions, x.dtype)
        return x * cos + rotate_half(x) * sin

    def _ragged_logits(self, weights, k_pool, v_pool, ids, positions, slots,
                       row_seq, row_ctx, tables):
        """One ragged ministep up to the logits. ids / positions / slots /
        row_seq / row_ctx [rows] int32 on the decoder's device; tables
        [num_seqs, max_pages] int32. The pools are updated in place and
        returned for symmetry with the JAX signature.
        Returns (logits [rows, vocab] float32, k_pool, v_pool)."""
        cfg = self.cfg
        r = ids.shape[0]
        nh = cfg.num_attention_heads
        h = weights["embed"][ids.long()]                   # [r, d]
        pos = positions.long().clamp(max=cfg.max_position_embeddings - 1)
        # per-ministep constants shared by every layer: the RoPE rows of
        # these positions and the pool index of these slots
        rope = self._rope_tables(pos, h.dtype)
        index = pool_index(slots, self.block_size, cfg.num_key_value_heads)
        for li, w in enumerate(weights["layers"]):
            hn = rms_norm(h, w["ln1"], cfg.rms_norm_eps)
            q, k, v = self._proj_qkv(w, hn)
            # one rotation for q and k together
            qk = self._rope(torch.cat([q, k], dim=1), pos, rope)
            q, k = qk[:, :nh].contiguous(), qk[:, nh:]
            reshape_and_cache(k, v, k_pool[li], v_pool[li], slots,
                              index=index)
            attn = ragged_paged_attention(q, k_pool[li], v_pool[li], tables,
                                          row_seq, row_ctx)
            h = h + _mm(attn.reshape(r, -1), w["wo"])
            hn = rms_norm(h, w["ln2"], cfg.rms_norm_eps)
            h = h + self._mlp(w, hn)
        h = rms_norm(h, weights["norm"], cfg.rms_norm_eps)
        logits = _mm(h, weights["head"]).to(torch.float32)
        return logits, k_pool, v_pool

    # -- dense per-phase programs ----------------------------------------------
    def _final_logits(self, weights, h, last_idx):
        """Float32 logits of h [b, s, hidden] at each row's last_idx
        (None: the last position)."""
        b = h.shape[0]
        if last_idx is None:
            hl = h[:, -1]
        else:
            hl = h[torch.arange(b, device=h.device), last_idx.long()]
        hl = rms_norm(hl, weights["norm"], self.cfg.rms_norm_eps)
        return _mm(hl, weights["head"]).to(torch.float32)

    def _prefill_impl(self, weights, k_pool, v_pool, ids, slots,
                      last_idx=None, *, logits: bool = True):
        """A bucketed prefill from position 0. ids [b, s]; slots [b, s]
        flat pool slots (right-padding rows aim at the scratch page);
        last_idx [b] each row's final REAL token (None: s - 1). Causal
        attention over the chunk itself through ``flash_attention`` (the
        flash forward kernel on the card). The pools are written in
        place. Returns (logits [b, vocab] float32, or None when
        ``logits`` is False, k_pool, v_pool)."""
        cfg = self.cfg
        b, s = ids.shape
        kvh, hd = cfg.num_key_value_heads, self.head_dim
        h = weights["embed"][ids.long()]                    # [b, s, d]
        # clamped like the offset programs: a bucket's padding rows may
        # sit past max_position_embeddings (JAX's gather clamps them)
        pos = torch.arange(s, device=ids.device).clamp(
            max=cfg.max_position_embeddings - 1)
        rope = self._rope_tables(pos, h.dtype)
        index = pool_index(slots.reshape(-1), self.block_size, kvh)
        for li, w in enumerate(weights["layers"]):
            hn = rms_norm(h, w["ln1"], cfg.rms_norm_eps)
            q, k, v = self._proj_qkv(w, hn)
            q = self._rope(q, pos, rope)
            k = self._rope(k, pos, rope)
            v = v.contiguous()
            attn = flash_attention(q, k, v, causal=True)
            h = h + _mm(attn.reshape(b, s, -1), w["wo"])
            hn = rms_norm(h, w["ln2"], cfg.rms_norm_eps)
            h = h + self._mlp(w, hn)
            reshape_and_cache(k.reshape(b * s, kvh, hd),
                              v.reshape(b * s, kvh, hd), k_pool[li],
                              v_pool[li], None, index=index)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _prefill_prefix_impl(self, weights, k_pool, v_pool, ids, slots,
                             last_idx, n_cached, prefix_tables, *,
                             logits: bool = True):
        """A prefill at an offset: row i's ids [s] sit at positions
        ``n_cached[i] + j`` and attend the prefix already in the pool
        (``prefix_tables`` [b, P], scratch-padded past the prefix) plus
        themselves, causally. Rows with n_cached 0 are an ordinary
        bucketed prefill. Returns (logits at last_idx [b, vocab] float32,
        or None, k_pool, v_pool)."""
        cfg = self.cfg
        b, s = ids.shape
        kvh, hd = cfg.num_key_value_heads, self.head_dim
        h = weights["embed"][ids.long()]
        pos = (torch.arange(s, device=ids.device)[None]
               + n_cached.long()[:, None]).clamp(
                   max=cfg.max_position_embeddings - 1)     # [b, s]
        rope = self._rope_tables(pos, h.dtype)
        index = pool_index(slots.reshape(-1), self.block_size, kvh)
        for li, w in enumerate(weights["layers"]):
            hn = rms_norm(h, w["ln1"], cfg.rms_norm_eps)
            q, k, v = self._proj_qkv(w, hn)
            q = self._rope(q, pos, rope)
            k = self._rope(k, pos, rope)
            k_pre = _gather_prefix_pages(k_pool[li], prefix_tables)
            v_pre = _gather_prefix_pages(v_pool[li], prefix_tables)
            attn = _prefix_suffix_attention(q, k, v, k_pre, v_pre, n_cached)
            h = h + _mm(attn.reshape(b, s, -1), w["wo"])
            hn = rms_norm(h, w["ln2"], cfg.rms_norm_eps)
            h = h + self._mlp(w, hn)
            reshape_and_cache(k.reshape(b * s, kvh, hd),
                              v.reshape(b * s, kvh, hd), k_pool[li],
                              v_pool[li], None, index=index)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _decode_logits(self, weights, k_pool, v_pool, last_ids, tables,
                       ctx_lens, slots):
        """One decode token per sequence, up to the logits. last_ids /
        ctx_lens / slots [b] int32 (ctx_lens counts the tokens already
        cached, EXCLUDING this one, so RoPE runs at position ctx and
        attention sees ctx + 1 positions); tables [b, max_pages] int32.
        This token's K/V is written to the pool before attention.
        Returns (logits [b, vocab] float32, k_pool, v_pool)."""
        cfg = self.cfg
        b = last_ids.shape[0]
        nh = cfg.num_attention_heads
        h = weights["embed"][last_ids.long()]               # [b, d]
        pos = ctx_lens.long().clamp(max=cfg.max_position_embeddings - 1)
        rope = self._rope_tables(pos, h.dtype)
        index = pool_index(slots, self.block_size, cfg.num_key_value_heads)
        visible = ctx_lens + 1
        for li, w in enumerate(weights["layers"]):
            hn = rms_norm(h, w["ln1"], cfg.rms_norm_eps)
            q, k, v = self._proj_qkv(w, hn)
            qk = self._rope(torch.cat([q, k], dim=1), pos, rope)
            q, k = qk[:, :nh].contiguous(), qk[:, nh:]
            reshape_and_cache(k, v, k_pool[li], v_pool[li], slots,
                              index=index)
            attn = paged_attention_decode(q, k_pool[li], v_pool[li], tables,
                                          visible)
            h = h + _mm(attn.reshape(b, -1), w["wo"])
            hn = rms_norm(h, w["ln2"], cfg.rms_norm_eps)
            h = h + self._mlp(w, hn)
        h = rms_norm(h, weights["norm"], cfg.rms_norm_eps)
        logits = _mm(h, weights["head"]).to(torch.float32)
        return logits, k_pool, v_pool

    def _decode_scan_impl(self, weights, k_pool, v_pool, first_ids,
                          tables_all, ctx_all, slots_all, sample=None):
        """T decode steps from a host-precomputed schedule (tables_all
        [T, b, max_pages], ctx_all / slots_all [T, b]); each step's token
        feeds the next on the device, with no host sync. ``sample`` maps
        a step's float32 logits [b, vocab] to its int32 tokens (None:
        greedy argmax). Returns (tokens [b, T] int32, k_pool, v_pool)."""
        cur = first_ids
        out = []
        for t in range(tables_all.shape[0]):
            logits, k_pool, v_pool = self._decode_logits(
                weights, k_pool, v_pool, cur, tables_all[t], ctx_all[t],
                slots_all[t])
            cur = (logits.argmax(dim=-1).to(torch.int32) if sample is None
                   else sample(logits))
            out.append(cur)
        if not out:
            return (torch.zeros((first_ids.shape[0], 0), dtype=torch.int32,
                                device=first_ids.device), k_pool, v_pool)
        return torch.stack(out, dim=1), k_pool, v_pool

    # -- public API ------------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 32,
                 timings: Optional[dict] = None) -> np.ndarray:
        """Greedy batched generation. input_ids [b, prompt_len]
        (numpy, list or tensor) of EQUAL-length prompts (mixed lengths
        are the ServingEngine's job); returns numpy int32 [b, prompt_len
        + max_new_tokens]. A ``timings`` dict receives prefill_s and
        decode_s wall times (taken after a device synchronize)."""
        with torch.inference_mode():
            return _paged_generate(self, input_ids, max_new_tokens, timings)


def _paged_generate(dec, input_ids, max_new_tokens, timings=None):
    """Page allocation (sequence ids 0..b-1), one prefill, a host-
    precomputed decode schedule, one decode loop, page free."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    ids = np.asarray(input_ids).astype(np.int32)
    if ids.ndim != 2 or ids.shape[1] == 0:
        raise ValueError(f"generate needs input_ids [batch, prompt_len], "
                         f"got shape {ids.shape}")
    b, s = ids.shape
    dev = dec.device
    cache = dec.cache

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seqs = list(range(b))
    slot_rows = []
    for i in seqs:
        cache.allocate(i, s + max(0, max_new_tokens))
        slot_rows.append([cache.extend(i) for _ in range(s)])
    try:
        t0 = time.perf_counter()
        logits, _, _ = dec._prefill_impl(
            dec.weights, cache.k, cache.v,
            torch.from_numpy(ids).to(dev),
            torch.as_tensor(slot_rows, dtype=torch.int32, device=dev))
        next_ids = logits.argmax(dim=-1).to(torch.int32)
        if timings is not None:
            sync()
            timings["prefill_s"] = time.perf_counter() - t0
        if max_new_tokens <= 0:
            return ids
        T = max_new_tokens - 1
        ctx_all = np.zeros((T, b), np.int32)
        slots_all = np.zeros((T, b), np.int32)
        tables_all = np.zeros((T, b, dec.max_pages), np.int32)
        for t in range(T):
            ctx_all[t] = [cache.context_len(i) for i in seqs]
            slots_all[t] = [cache.extend(i) for i in seqs]
            tables_all[t] = np.stack(
                [cache.block_table(i, dec.max_pages) for i in seqs])
        t1 = time.perf_counter()
        toks, _, _ = dec._decode_scan_impl(
            dec.weights, cache.k, cache.v, next_ids,
            torch.from_numpy(tables_all).to(dev),
            torch.from_numpy(ctx_all).to(dev),
            torch.from_numpy(slots_all).to(dev))
        toks = toks.cpu().numpy()
        if timings is not None:
            timings["decode_s"] = time.perf_counter() - t1
        return np.concatenate(
            [ids, next_ids.cpu().numpy()[:, None], toks], axis=1)
    finally:
        for i in seqs:
            cache.free(i)
