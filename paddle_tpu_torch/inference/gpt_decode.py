"""Paged-KV decoder for the GPT / ERNIE family: the ragged serving step
and the dense per-phase programs.

Counterpart: ``paddle_tpu/inference/gpt_decode.py``. The decoder holds
the JAX ``weights`` tree's shape: ``embed`` [vocab, hidden], ``pos``
[max_positions, hidden], ``lnf_w`` / ``lnf_b``, ``head`` [hidden,
vocab] and per layer ``ln1_w`` / ``ln1_b``, ``ln2_w`` / ``ln2_b``, the
fused ``wqkv`` [hidden, 3 * hidden] with ``bqkv``, ``wo`` / ``bo``,
``wi`` / ``bi`` and ``wf`` / ``bf``. Matmul weights may be quantized
(``QWeight``); biases, norms and both embeddings stay at full precision.
JAX's tensor-parallel tree splits the fused projection into ``wq`` /
``wk`` / ``wv`` with ``bq`` / ``bk`` / ``bv`` (a column cut of the fused
weight would hand a shard a mix of q, k and v features); the port cuts a
fused tree the same way before sharding, and fuses each shard's three
projections again, so every program reads ``wqkv`` / ``bqkv``.

The family differs from Llama in learned position embeddings (gathered
at each row's position), LayerNorm with bias, the biases of every
projection, an exact-erf GELU MLP and multi-head attention: the pool
holds as many kv heads as there are heads, so the paged kernels run
with one query head per kv head. The decoder's ``_layer_norm`` applies
gain and bias in float32 and casts last (JAX ``gpt_decode.py:38-45``);
the model's ``layer_norm`` casts before the affine. The row-parallel
biases ``bo`` and ``bf`` are added after their block's reduce, so they
count once under tensor parallelism.

Learned positions are never indexed out of range: every program clamps
the positions it gathers to ``max_position_embeddings - 1``. JAX clamps
in ``_prefill_prefix_impl`` and ``_ragged_logits``; its ``_decode_logits``
gathers unclamped (NaN past the table) and its ``_prefill_impl`` slices
the table (a prompt past it fails to broadcast). Real rows never reach
past the table in either package, so only padding rows, whose outputs
are discarded, see the difference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.collective import all_gather_logits
from ..distributed.spec_layout import cut
from ..models.gpt import GPTConfig
from ..nn.functional import gelu
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (paged_attention_decode, pool_index,
                                   ragged_paged_attention,
                                   reshape_and_cache)
from ..ops.qweight import QWeight
from .paged_decode import (_PagedDecoder, _fuse_out, _gather_prefix_pages,
                           _mm, _prefix_suffix_attention)

__all__ = ["PagedGPTDecoder"]


def _layer_norm(x, w, b, eps: float):
    """The decoder's LayerNorm (JAX ``gpt_decode._layer_norm``): float32
    statistics, gain and bias applied in float32, one cast at the end."""
    acc = x.to(torch.float32)
    centered = acc - acc.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _weight_specs(cfg: GPTConfig):
    """(name, shape, quantized?) for every serving weight, in load
    order; [in, out] layout, head [hidden, vocab]."""
    h, it, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    specs = [("embed", (v, h), False),
             ("pos", (cfg.max_position_embeddings, h), False)]
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."
        specs += [(p + "ln1_w", (h,), False), (p + "ln1_b", (h,), False),
                  (p + "wqkv", (h, 3 * h), True),
                  (p + "bqkv", (3 * h,), False),
                  (p + "wo", (h, h), True), (p + "bo", (h,), False),
                  (p + "ln2_w", (h,), False), (p + "ln2_b", (h,), False),
                  (p + "wi", (h, it), True), (p + "bi", (it,), False),
                  (p + "wf", (it, h), True), (p + "bf", (h,), False)]
    specs += [("lnf_w", (h,), False), ("lnf_b", (h,), False),
              ("head", (h, v), True)]
    return specs


def _split_out(w, n: int = 3):
    """n equal out-column pieces of a dense weight, a bias or a
    ``QWeight`` (its per-column scales cut with it)."""
    if isinstance(w, QWeight):
        return [QWeight(cut(w.q, 1, i, n), cut(w.scale, 0, i, n), w.kind)
                for i in range(n)]
    return [cut(w, w.dim() - 1, i, n) for i in range(n)]


def _split_qkv(weights):
    """The tree with each fused ``wqkv`` / ``bqkv`` split into JAX's
    tensor-parallel ``wq`` / ``wk`` / ``wv`` and ``bq`` / ``bk`` /
    ``bv``; a split tree passes through."""
    layers = []
    for lw in weights["layers"]:
        lw = dict(lw)
        if "wqkv" in lw:
            lw["wq"], lw["wk"], lw["wv"] = _split_out(lw.pop("wqkv"))
            lw["bq"], lw["bk"], lw["bv"] = _split_out(lw.pop("bqkv"))
        layers.append(lw)
    return {**weights, "layers": layers}


def _fuse_qkv(weights):
    """The tree with ``wq`` / ``wk`` / ``wv`` (and their biases) fused
    along the out dim; a fused tree passes through and the given tree is
    left as it was."""
    layers = []
    for lw in weights["layers"]:
        lw = dict(lw)
        if "wq" in lw:
            lw["wqkv"] = _fuse_out([lw.pop("wq"), lw.pop("wk"),
                                    lw.pop("wv")])
            lw["bqkv"] = torch.cat([lw.pop("bq"), lw.pop("bk"),
                                    lw.pop("bv")])
        layers.append(lw)
    return {**weights, "layers": layers}


class PagedGPTDecoder(_PagedDecoder):
    """Paged-KV GPT decoder on one device (``device=None``: cuda), or
    tensor-parallel over the ``mp_axis`` of a ``ProcessMesh`` with
    ``tp_shard_map=True``: JAX's only tensor-parallel GPT path (a mesh
    without it raises, as in JAX, and so does ``tp_comm="int8"`` off
    it). Under tp each shard holds its heads' q/k/v columns, its slice
    of ``wi`` / ``bi``, its rows of ``wo`` / ``wf`` and the whole
    replicated rest; each block's row-parallel product is reduced once
    (``_block_reduce``) before its bias is added. ``weights`` is the
    list of shard trees and ``cache.k`` / ``cache.v`` the lists of the
    shards' planes (one shard on one device)."""

    _MP_AXIS = "tp"
    _fuse = staticmethod(_fuse_qkv)
    _weight_specs = staticmethod(_weight_specs)

    @staticmethod
    def _is_gain(name: str) -> bool:
        return name.endswith("_w")

    def __init__(self, cfg: GPTConfig, weights: dict,
                 num_blocks: int = 512, block_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 weight_dtype: Optional[str] = None,
                 kv_quant: Optional[str] = None, device=None, mesh=None,
                 mp_axis: str = "tp", tp_shard_map: bool = False,
                 tp_comm: str = "fp32"):
        if mesh is not None and not tp_shard_map:
            raise ValueError(
                "PagedGPTDecoder tensor parallelism is the manual "
                "shard_map path only — pass tp_shard_map=True with the "
                "mesh (no GSPMD fallback is implemented for the fused-"
                "qkv layout)")
        if mesh is not None:
            weights = _split_qkv(weights)
        super().__init__(cfg, weights, num_blocks=num_blocks,
                         block_size=block_size,
                         max_pages_per_seq=max_pages_per_seq,
                         weight_dtype=weight_dtype, kv_quant=kv_quant,
                         device=device, mesh=mesh, mp_axis=mp_axis,
                         tp_shard_map=tp_shard_map, tp_comm=tp_comm)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_model(cls, model, num_blocks: int = 512, block_size: int = 16,
                   max_pages_per_seq: Optional[int] = None,
                   weight_dtype: Optional[str] = None,
                   kv_quant: Optional[str] = None, device=None, **tp_kw):
        """Serve a ``GPTForCausalLM`` (JAX: ``PagedGPTDecoder(model)``
        through ``_extract_gpt_weights``) by way of
        ``from_weight_loader``: the Linear weights are [in, out], with
        ``weight_dtype`` quantized per channel; biases, norms and both
        embeddings stay as they are. A tied model's head is the
        embedding transposed. The pool takes the embedding's dtype
        (float32: the model's parameters are). ``tp_kw``: ``mesh``,
        ``mp_axis``, ``tp_shard_map``, ``tp_comm``. On ``device`` the
        decoder shares the model's tensors wherever it keeps a weight as
        it is."""
        m = model.gpt
        embed = m.embed_tokens.weight
        params = {"embed": embed, "pos": m.embed_positions.weight,
                  "lnf_w": m.ln_f.weight, "lnf_b": m.ln_f.bias,
                  "head": embed.t() if model.lm_head is None
                  else model.lm_head.weight}
        for li, lyr in enumerate(m.layers):
            a, mlp = lyr.attn, lyr.mlp
            for key, t in (("ln1_w", lyr.ln_1.weight),
                           ("ln1_b", lyr.ln_1.bias),
                           ("wqkv", a.qkv_proj.weight),
                           ("bqkv", a.qkv_proj.bias),
                           ("wo", a.out_proj.weight),
                           ("bo", a.out_proj.bias),
                           ("ln2_w", lyr.ln_2.weight),
                           ("ln2_b", lyr.ln_2.bias),
                           ("wi", mlp.fc_in.weight), ("bi", mlp.fc_in.bias),
                           ("wf", mlp.fc_out.weight),
                           ("bf", mlp.fc_out.bias)):
                params[f"layers.{li}.{key}"] = t
        return cls.from_weight_loader(
            model.cfg, lambda name, shape: params[name].detach(),
            weight_dtype=weight_dtype, device=device, num_blocks=num_blocks,
            block_size=block_size, max_pages_per_seq=max_pages_per_seq,
            kv_quant=kv_quant, **tp_kw)

    # -- building blocks ------------------------------------------------------
    def _qkv(self, w, hn):
        """q, k, v [..., heads, head_dim] of this shard's heads, each with
        its bias (JAX ``_qkv``)."""
        nh = self.cfg.num_attention_heads // self.n_shards
        qkv = _mm(hn, w["wqkv"]) + w["bqkv"].to(hn.dtype)
        qkv = qkv.reshape(*hn.shape[:-1], 3, nh, self.head_dim)
        return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]

    def _embed(self, w, ids, pos):
        """Token plus learned position embeddings at clamped positions."""
        return w["embed"][ids.long()] + w["pos"][pos]

    def _positions(self, pos):
        return pos.long().clamp(0, self.cfg.max_position_embeddings - 1)

    def _layers(self, ws, h, attn, lora=None, row_seq=None):
        """The layer stack over the shards (JAX ``_block`` per layer). h:
        the hidden state on each shard's device; ``attn(s, li, w, hn)``
        runs shard s's attention of layer li (writing its K/V) and
        returns its [..., heads * hd] output. Each block's shard products
        meet in one ``_block_reduce``, then the replicated bias is added.
        ``lora``/``row_seq``: the adapters' deltas on wo, wi and wf.
        Returns the final h per shard."""
        eps = self.cfg.layer_norm_epsilon
        for li in range(self.cfg.num_hidden_layers):
            lws = [w["layers"][li] for w in ws]
            parts = []
            for s, lw in enumerate(lws):
                af = attn(s, li, lw, _layer_norm(h[s], lw["ln1_w"],
                                                 lw["ln1_b"], eps))
                o = _mm(af, lw["wo"])
                if lora is not None:
                    o = o + self._lora_delta(lora, row_seq[s], af, li, "wo",
                                             shard=s)
                parts.append(o)
            h = [a + (r + lw["bo"].to(a.dtype))
                 for a, r, lw in zip(h, self._block_reduce(parts), lws)]
            parts = []
            for s, lw in enumerate(lws):
                hn = _layer_norm(h[s], lw["ln2_w"], lw["ln2_b"], eps)
                mi = _mm(hn, lw["wi"])
                if lora is not None:
                    mi = mi + self._lora_delta(lora, row_seq[s], hn, li,
                                               "wi", shard=s)
                mid = gelu(mi + lw["bi"].to(h[s].dtype))
                f = _mm(mid, lw["wf"])
                if lora is not None:
                    f = f + self._lora_delta(lora, row_seq[s], mid, li, "wf",
                                             shard=s)
                parts.append(f)
            h = [a + (r + lw["bf"].to(a.dtype))
                 for a, r, lw in zip(h, self._block_reduce(parts), lws)]
        return h

    def _head_logits(self, ws, h):
        """Float32 logits of the final hidden rows h (per shard): the
        final LayerNorm, each shard's vocab slice, the gather on shard
        0's device."""
        eps = self.cfg.layer_norm_epsilon
        return all_gather_logits(
            [_mm(_layer_norm(hs, w["lnf_w"], w["lnf_b"], eps),
                 w["head"]).to(torch.float32) for w, hs in zip(ws, h)])

    # -- many-LoRA serving ----------------------------------------------------
    def lora_target_modules(self):
        """(name, din, dout, kind) of the six modules an adapter may
        change, in the JAX decoder's order, over the whole dims. The q /
        k / v deltas add to the three pieces of the fused projection."""
        cfg = self.cfg
        h = cfg.hidden_size
        it = cfg.intermediate_size
        return (("wq", h, h, "col"), ("wk", h, h, "col"),
                ("wv", h, h, "col"), ("wo", h, h, "row"),
                ("wi", h, it, "col"), ("wf", it, h, "row"))

    # -- programs -------------------------------------------------------------
    def _ragged_logits(self, weights, k_pool, v_pool, ids, positions, slots,
                       row_seq, row_ctx, tables, lora=None):
        """One ragged ministep up to the logits; the same contract as
        ``PagedLlamaDecoder._ragged_logits``, with the learned position
        rows gathered at each row's (clamped) position. ``lora`` adds
        each row's adapter delta to q / k / v (after their biases), to
        the wo product and to the wi and wf products. Returns (logits
        [rows, vocab] float32, k_pool, v_pool)."""
        r = ids.shape[0]
        nh = self.cfg.num_attention_heads // self.n_shards
        ops = self._on_shards(ids, self._positions(positions), slots,
                              row_seq, row_ctx, tables)
        index = [pool_index(o[2], self.block_size, nh) for o in ops]

        def attn(s, li, w, hn):
            _, _, sl, rs, rc, tb = ops[s]
            q, k, v = self._qkv(w, hn)
            if lora is not None:
                q = q + self._lora_delta(lora, rs, hn, li, "wq",
                                         s).reshape(q.shape)
                k = k + self._lora_delta(lora, rs, hn, li, "wk",
                                         s).reshape(k.shape)
                v = v + self._lora_delta(lora, rs, hn, li, "wv",
                                         s).reshape(v.shape)
            reshape_and_cache(k, v, k_pool[s][li], v_pool[s][li], sl,
                              index=index[s])
            return ragged_paged_attention(q.contiguous(), k_pool[s][li],
                                          v_pool[s][li], tb, rs,
                                          rc).reshape(r, -1)

        h = [self._embed(w, o[0], o[1]) for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn, lora, [o[3] for o in ops])
        return self._head_logits(weights, h), k_pool, v_pool

    def _prefill_impl(self, weights, k_pool, v_pool, ids, slots,
                      last_idx=None, *, logits: bool = True):
        """A bucketed prefill from position 0 through causal flash
        attention; the same contract as
        ``PagedLlamaDecoder._prefill_impl``."""
        b, s = ids.shape
        nh = self.cfg.num_attention_heads // self.n_shards
        hd = self.head_dim
        pos = self._positions(torch.arange(s, device=ids.device))
        ops = self._on_shards(ids, pos, slots.reshape(-1))
        index = [pool_index(o[2], self.block_size, nh) for o in ops]

        def attn(i, li, w, hn):
            q, k, v = (t.contiguous() for t in self._qkv(w, hn))
            out = flash_attention(q, k, v, causal=True)
            reshape_and_cache(k.reshape(b * s, nh, hd),
                              v.reshape(b * s, nh, hd), k_pool[i][li],
                              v_pool[i][li], None, index=index[i])
            return out.reshape(b, s, -1)

        h = [self._embed(w, o[0], o[1]) for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _prefill_prefix_impl(self, weights, k_pool, v_pool, ids, slots,
                             last_idx, n_cached, prefix_tables, *,
                             logits: bool = True):
        """A prefill at an offset over the prefix already in the pool;
        the same contract as ``PagedLlamaDecoder._prefill_prefix_impl``
        (with ``logits=False`` it is JAX's ``_prefill_chunk_impl``)."""
        b, s = ids.shape
        nh = self.cfg.num_attention_heads // self.n_shards
        hd = self.head_dim
        pos = self._positions(torch.arange(s, device=ids.device)[None]
                              + n_cached.long()[:, None])          # [b, s]
        ops = self._on_shards(ids, pos, slots.reshape(-1), n_cached,
                              prefix_tables)
        index = [pool_index(o[2], self.block_size, nh) for o in ops]

        def attn(i, li, w, hn):
            _, _, _, ncv, ptab = ops[i]
            q, k, v = self._qkv(w, hn)
            k_pre = _gather_prefix_pages(k_pool[i][li], ptab)
            v_pre = _gather_prefix_pages(v_pool[i][li], ptab)
            out = _prefix_suffix_attention(q, k, v, k_pre, v_pre, ncv)
            reshape_and_cache(k.reshape(b * s, nh, hd),
                              v.reshape(b * s, nh, hd), k_pool[i][li],
                              v_pool[i][li], None, index=index[i])
            return out.reshape(b, s, -1)

        h = [self._embed(w, o[0], o[1]) for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _decode_logits(self, weights, k_pool, v_pool, last_ids, tables,
                       ctx_lens, slots):
        """One decode token per sequence up to the logits, through
        ``paged_attention_decode``; the same contract as
        ``PagedLlamaDecoder._decode_logits`` (the position row is
        ctx_lens', clamped)."""
        b = last_ids.shape[0]
        nh = self.cfg.num_attention_heads // self.n_shards
        ops = self._on_shards(last_ids, self._positions(ctx_lens), slots,
                              tables, ctx_lens + 1)
        index = [pool_index(o[2], self.block_size, nh) for o in ops]

        def attn(i, li, w, hn):
            _, _, sl, tb, visible = ops[i]
            q, k, v = self._qkv(w, hn)
            reshape_and_cache(k, v, k_pool[i][li], v_pool[i][li], sl,
                              index=index[i])
            return paged_attention_decode(q.contiguous(), k_pool[i][li],
                                          v_pool[i][li], tb,
                                          visible).reshape(b, -1)

        h = [self._embed(w, o[0], o[1]) for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        return self._head_logits(weights, h), k_pool, v_pool
