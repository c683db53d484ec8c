"""Paged-KV decoder for Llama-family models: the ragged serving step.

Counterpart: ``paddle_tpu/inference/paged_decode.py`` (single device
only: no tensor parallel, speculative-decoding or LoRA mixins, and no
dense per-phase programs yet). The decoder holds a dict of tensors with
the same shape as the JAX ``weights`` tree — ``embed``, ``layers`` (each
with ``ln1``, ``ln2``, fused ``wqkv``, ``wo``, fused ``wgu``, ``wd``),
``norm`` and ``head`` — so weights carry across one-to-one. Matmul
weights are [in, out]; a quantized one is a ``QWeight`` whose ``kind``
names its layout.

``_ragged_logits`` is one ministep of the ragged serving engine: every
row's K/V is written to the pool (in place) before attention, so the
per-row visible length ``row_ctx`` is the whole causal mask.
"""
from __future__ import annotations

import zlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.llama import LlamaConfig
from ..ops.cuda.decode_matmul import (_MAX_ROWS, decode_matmul,
                                      unpack_int4_halves)
from ..ops.paged_attention import (PagedKVCache, pool_index,
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
        """(cos, sin) [rows, 1, head_dim] at positions, in dtype."""
        return (self._cos[positions][:, None, :].to(dtype),
                self._sin[positions][:, None, :].to(dtype))

    def _rope(self, x, positions, tables=None):
        """x [rows, heads, head_dim] at positions [rows]; ``tables`` are
        the ``_rope_tables`` of those positions when already gathered."""
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
