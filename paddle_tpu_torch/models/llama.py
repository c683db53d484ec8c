"""Llama: the configuration, the training model and its KV-cached
forward.

Counterpart: ``paddle_tpu/models/llama.py`` (``LlamaConfig`` :34-72,
``_sep_mesh`` :80-97, ``LlamaMLP``, ``LlamaAttention`` with its cache
:171-258, ``LlamaDecoderLayer`` with recompute :261-327, ``LlamaModel``,
``LlamaForCausalLM`` with ``forward``/``loss``/``_chunked_loss``/
``num_params``/``generate`` :360-455, and the ``llama_*`` configs
:457-509). The port keeps its own copy so that it never imports the JAX
package; fields, defaults and parameter names are the same, so JAX
weights carry over one to one (``load_numpy_state``).

Dtypes follow the JAX code, not its docs: every ``Linear`` and
``Embedding`` weight is float32; only the RMSNorm gains take
``cfg.dtype``; activations turn ``cfg.dtype`` after the embedding and
``F.linear`` casts each weight to the activation's dtype in the product.
A tied model's logits are ``h @ embed.T`` in the promoted dtype, as
``jnp.matmul`` gives them (float32 under bfloat16 activations).

JAX's options, ported:
- ``tie_word_embeddings``: no ``lm_head``; the head is the embedding.
- ``use_recompute`` with ``recompute_granularity`` "full" (the whole
  block), "full_attn" (ln1 + attention; the MLP's activations kept) or
  "core_attn" (the plain forward: the flash backward already recomputes
  the scores from q, k and v), through ``distributed.fleet.recompute``.
- ``sep_degree > 1`` (context parallelism): with a fleet mesh whose sep
  axis has that size (``distributed.fleet.init``), attention runs zigzag
  ring attention over it, RoPE applied on global positions first;
  without a fleet mesh, plain attention, as in JAX.
- ``chunked_ce_tokens > 0``: ``forward`` returns the hidden states and
  ``loss`` runs the head product and cross entropy in chunks of that
  many tokens.
- ``forward(input_ids, caches=, pos=)``: static [b, max_len, kv_heads,
  head_dim] caches written in place at ``pos``, RoPE at that offset and
  GQA attention over the cache in float32 (plain ops: JAX's is einsums,
  not a kernel); ``generate`` and beam search are ``models/generation.py``.
- ``tensor_parallel`` with a fleet mesh whose mp axis is larger than 1
  (JAX's ``_mp_active()``): q/k/v and gate/up are column-parallel, o and
  down row-parallel, the embedding vocab-parallel and the head
  column-parallel (``distributed/fleet/mpu.py``); each rank runs RoPE and
  attention on its own contiguous block of q heads and of kv heads, so
  GQA's groups stay inside a rank, and the MLP's gate on its own
  columns. The cached forward runs on the logical q/k/v. Without such a
  mesh the flag builds the plain model, as in JAX;
  ``sequence_parallel`` is read by nothing, as in JAX.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..distributed.fleet import get_hybrid_communicate_group, recompute
from ..distributed.fleet.mpu import (ColumnParallelLinear, LogicalParameters,
                                     RowParallelLinear,
                                     VocabParallelEmbedding, mp_devices)
from ..distributed.ring_attention import ring_attention
from ..nn import functional as F
from ..numpy_bridge import load_numpy_state
from ..ops.rope import build_rope_cache, rope_reference

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_tiny",
           "llama_small", "llama_mid", "llama_1b", "llama_3_8b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    use_recompute: bool = False
    recompute_granularity: str = "full"
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    sep_degree: int = 1
    chunked_ce_tokens: int = 0


def _tp(cfg) -> bool:
    """``tensor_parallel`` under a fleet mesh with mp > 1."""
    return bool(cfg.tensor_parallel) and mp_devices() is not None


_GRANULARITIES = ("full", "full_attn", "core_attn")


def _sep_mesh(sep_degree: int):
    """The fleet mesh when context parallelism is asked for and a fleet
    mesh exists (None without one: single-device runs keep plain
    attention); raises when its sep axis is not of that size."""
    if sep_degree <= 1:
        return None
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    mesh = hcg.mesh
    if "sep" not in mesh.dim_names or \
            mesh.get_dim_size("sep") != sep_degree:
        raise ValueError(
            f"sep_degree={sep_degree} needs a fleet mesh with a 'sep' "
            f"axis of that size; got {mesh.dim_names} "
            f"{[mesh.get_dim_size(a) for a in mesh.dim_names]}: set "
            "hybrid_configs sep_degree")
    return mesh


class LlamaMLP(LogicalParameters, nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self._tp = _tp(cfg)
        if self._tp:
            col = dict(has_bias=False, gather_output=False, generator=gen,
                       device=dev)
            self.gate_proj = ColumnParallelLinear(h, i, **col)
            self.up_proj = ColumnParallelLinear(h, i, **col)
            self.down_proj = RowParallelLinear(
                i, h, has_bias=False, input_is_parallel=True, generator=gen,
                device=dev)
            return
        lin = dict(bias_attr=False, generator=gen, device=dev)
        self.gate_proj = pnn.Linear(h, i, **lin)
        self.up_proj = pnn.Linear(h, i, **lin)
        self.down_proj = pnn.Linear(i, h, **lin)

    def forward(self, x):
        if self._tp:
            acts = [F.silu(g) * u for g, u in zip(
                self.gate_proj.shard_forward(x),
                self.up_proj.shard_forward(x))]
            return self.down_proj.shard_forward(acts, like=x)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(LogicalParameters, nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.rope_theta = cfg.rope_theta
        self.sep_degree = cfg.sep_degree
        h, kv_out = cfg.hidden_size, self.num_kv_heads * self.head_dim
        self._tp = _tp(cfg)
        if self._tp:
            mp = len(mp_devices())
            if self.num_kv_heads % mp or self.num_heads % mp:
                raise ValueError(
                    f"num_heads {self.num_heads} / num_kv_heads "
                    f"{self.num_kv_heads} must divide mp degree {mp}")
            col = dict(has_bias=False, gather_output=False, generator=gen,
                       device=dev)
            self.q_proj = ColumnParallelLinear(h, h, **col)
            self.k_proj = ColumnParallelLinear(h, kv_out, **col)
            self.v_proj = ColumnParallelLinear(h, kv_out, **col)
            self.o_proj = RowParallelLinear(h, h, has_bias=False,
                                            input_is_parallel=True,
                                            generator=gen, device=dev)
            return
        lin = dict(bias_attr=False, generator=gen, device=dev)
        self.q_proj = pnn.Linear(h, h, **lin)
        self.k_proj = pnn.Linear(h, kv_out, **lin)
        self.v_proj = pnn.Linear(h, kv_out, **lin)
        self.o_proj = pnn.Linear(h, h, **lin)

    def forward(self, x, past_kv=None, pos=None):
        """Without ``past_kv``: causal attention over x's own positions.
        With ``past_kv`` = (k_cache, v_cache), each [b, max_len, kv_heads,
        head_dim], and ``pos`` (tokens already cached, an int): x's K/V
        are written into the caches in place at ``pos``, and its queries
        attend cache[:pos + s]; returns (out, (k_cache, v_cache))."""
        b, s = x.shape[0], x.shape[1]
        if self._tp and past_kv is None:
            outs = [self._attend(q, k, v) for q, k, v in zip(
                self.q_proj.shard_forward(x), self.k_proj.shard_forward(x),
                self.v_proj.shard_forward(x))]
            return self.o_proj.shard_forward(outs, like=x)
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if past_kv is not None:
            out, new_kv = self._cached_attention(q, k, v, past_kv, int(pos))
            return self.o_proj(out), new_kv
        return self.o_proj(self._attend(q, k, v))

    def _attend(self, q, k, v):
        """RoPE and causal attention over q [b, s, *, d] / k, v: all of
        the heads, or one mp rank's block of them. Returns [b, s, heads *
        d]."""
        b, s, d = q.shape[0], q.shape[1], self.head_dim
        q = q.reshape(b, s, -1, d)
        k = k.reshape(b, s, -1, d)
        v = v.reshape(b, s, -1, d)
        cos, sin = build_rope_cache(s, d, self.rope_theta, torch.float32,
                                    device=q.device)
        q = rope_reference(q, cos.to(q.dtype), sin.to(q.dtype))
        k = rope_reference(k, cos.to(k.dtype), sin.to(k.dtype))
        sep_mesh = _sep_mesh(self.sep_degree)
        if sep_mesh is not None:
            out = ring_attention(q, k, v, sep_mesh, axis="sep", causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return out.reshape(b, s, -1)

    def _cached_attention(self, q, k, v, past_kv, pos: int):
        """JAX's ``cached_attn`` (:227-254): RoPE from a max_len table
        sliced at pos, the caches updated at pos, and GQA attention of
        the s new queries over every cache position <= theirs, in
        float32."""
        k_cache, v_cache = past_kv
        b, s = q.shape[0], q.shape[1]
        max_len = k_cache.shape[1]
        cos, sin = build_rope_cache(max_len, self.head_dim, self.rope_theta,
                                    torch.float32, device=q.device)
        cos, sin = cos[:, pos:pos + s], sin[:, pos:pos + s]
        q = rope_reference(q, cos.to(q.dtype), sin.to(q.dtype))
        k = rope_reference(k, cos.to(k.dtype), sin.to(k.dtype))
        k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
        group = self.num_heads // self.num_kv_heads
        qg = q.reshape(b, s, self.num_kv_heads, group, self.head_dim)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                              k_cache.float())
        # jnp.sqrt of a Python float is a float32 scalar
        scores = scores / torch.tensor(math.sqrt(self.head_dim),
                                       dtype=torch.float32)
        kpos = torch.arange(max_len, device=q.device)
        qpos = pos + torch.arange(s, device=q.device)
        visible = kpos[None, :] <= qpos[:, None]              # [s, max_len]
        scores = torch.where(visible, scores,
                             torch.full((), -1e30, device=q.device))
        probs = torch.softmax(scores, dim=-1)
        og = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.float())
        out = og.reshape(b, s, self.num_heads * self.head_dim).to(q.dtype)
        return out, (k_cache, v_cache)


class LlamaDecoderLayer(LogicalParameters, nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        self.input_layernorm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                           dtype=cfg.dtype, device=dev)
        self.self_attn = LlamaAttention(cfg, gen, dev)
        self.post_attention_layernorm = pnn.RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, dtype=cfg.dtype, device=dev)
        self.mlp = LlamaMLP(cfg, gen, dev)
        self.use_recompute = cfg.use_recompute
        self.recompute_granularity = cfg.recompute_granularity

    def _attn(self, x):
        return self.self_attn(self.input_layernorm(x))

    def _block(self, x):
        h = x + self._attn(x)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x, past_kv=None, pos=None):
        if past_kv is not None:
            attn, new_kv = self.self_attn(self.input_layernorm(x),
                                          past_kv=past_kv, pos=pos)
            h = x + attn
            return h + self.mlp(self.post_attention_layernorm(h)), new_kv
        if not self.use_recompute:
            return self._block(x)
        gran = self.recompute_granularity
        if gran == "full":
            return recompute(self._block, x)
        if gran == "full_attn":
            h = x + recompute(self._attn, x)
            return h + self.mlp(self.post_attention_layernorm(h))
        if gran == "core_attn":
            return self._block(x)
        raise ValueError(f"unknown recompute_granularity {gran!r}; "
                         f"expected one of {_GRANULARITIES}")


class LlamaModel(LogicalParameters, nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        self.cfg = cfg
        if _tp(cfg):
            # the plain Embedding's initializer: one seed, one table at
            # every mp degree
            self.embed_tokens = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size,
                weight_attr=pnn.initializer.Normal(0.0, 1.0), generator=gen,
                device=dev)
        else:
            self.embed_tokens = pnn.Embedding(cfg.vocab_size,
                                              cfg.hidden_size,
                                              generator=gen, device=dev)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, gen, dev)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                dtype=cfg.dtype, device=dev)

    def forward(self, input_ids, caches=None, pos=None):
        h = self.embed_tokens(input_ids)
        if self.cfg.dtype != "float32":
            h = h.to(pnn.initializer.convert_dtype(self.cfg.dtype))
        if caches is not None:
            new_caches = []
            for layer, kv in zip(self.layers, caches):
                h, nkv = layer(h, past_kv=kv, pos=pos)
                new_caches.append(nkv)
            return self.norm(h), new_caches
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(LogicalParameters, nn.Module):
    """The causal LM. Weights are made from ``seed`` with a
    ``torch.Generator`` on ``device`` (``None``: cuda, raising without a
    card); ``load_numpy_state`` replaces them with JAX's."""

    def __init__(self, cfg: LlamaConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, gen, dev)
        if cfg.tie_word_embeddings:
            self.lm_head = None
        elif _tp(cfg):
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False,
                gather_output=True, generator=gen, device=dev)
        else:
            self.lm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                      bias_attr=False, generator=gen,
                                      device=dev)

    def forward(self, input_ids, caches=None, pos=None):
        """Logits [b, s, vocab]; with ``chunked_ce_tokens`` the hidden
        states (``loss`` owns the head product). With ``caches`` (one
        (k, v) pair a layer, see ``LlamaAttention.forward``) and ``pos``:
        (logits, caches), the head always applied."""
        if caches is not None:
            h, new_caches = self.model(input_ids, caches=caches, pos=pos)
        else:
            h = self.model(input_ids)
            if self.cfg.chunked_ce_tokens:
                return h
        embed = self.model.embed_tokens
        if self.lm_head is None and isinstance(embed,
                                               VocabParallelEmbedding):
            logits = embed.head(h)
        elif self.lm_head is None:
            w = embed.weight
            dt = torch.promote_types(h.dtype, w.dtype)
            logits = torch.matmul(h.to(dt), w.t().to(dt))
        else:
            logits = self.lm_head(h)
        if caches is not None:
            return logits, new_caches
        return logits

    def loss(self, logits, labels):
        """Shifted causal-LM cross entropy (float32). With
        ``chunked_ce_tokens`` > 0, ``logits`` are the hidden states that
        ``forward`` returned and the head product runs chunk by chunk."""
        if self.cfg.chunked_ce_tokens:
            return self._chunked_loss(logits, labels)
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1))

    def _chunked_loss(self, hidden, labels):
        return F.chunked_causal_lm_loss(
            hidden, labels,
            None if self.lm_head is None else self.lm_head.weight,
            self.model.embed_tokens.weight, int(self.cfg.chunked_ce_tokens))

    def num_params(self) -> int:
        """Logical parameters (a tp model's shards add up to them)."""
        return sum(p.numel() for p in self.shard_parameters())

    def generate(self, input_ids, max_new_tokens: int = 32,
                 max_length: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 num_beams: int = 1, length_penalty: float = 0.0):
        """KV-cached generation on the model's device: [b, prompt_len +
        generated] int32 ids, the prompt included. Greedy at temperature
        0, else JAX's seeded key stream with top_k / top_p / repetition
        penalty; ``num_beams > 1`` is beam search, which takes no
        sampling argument (JAX :420-455)."""
        from . import generation
        if num_beams > 1:
            if temperature > 0 or top_k > 0 or top_p < 1.0 \
                    or repetition_penalty != 1.0:
                raise ValueError(
                    "num_beams > 1 is deterministic beam search; "
                    "temperature/top_k/top_p/repetition_penalty do not "
                    "apply: drop them or use num_beams=1 sampling")
            return generation.beam_search(
                self, input_ids, num_beams=num_beams,
                max_new_tokens=max_new_tokens,
                length_penalty=length_penalty, eos_token_id=eos_token_id,
                max_length=max_length)
        return generation.generate(
            self, input_ids, max_new_tokens=max_new_tokens,
            max_length=max_length, temperature=temperature, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            eos_token_id=eos_token_id, seed=seed)

    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}`` (the JAX model's
        ``named_parameters()`` as numpy) into this model: every name must
        be present and no other (a tied model has no ``lm_head.weight``),
        shapes and dtypes must be equal; bfloat16 arrays are carried bit
        for bit."""
        load_numpy_state(self, state)


def llama_tiny(**kw) -> LlamaConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    base.update(kw)
    return LlamaConfig(**base)


def llama_small(**kw) -> LlamaConfig:
    base = dict(vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_hidden_layers=8,
                num_attention_heads=16, num_key_value_heads=8,
                max_position_embeddings=2048)
    base.update(kw)
    return LlamaConfig(**base)


def llama_1b(**kw) -> LlamaConfig:
    base = dict(vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_hidden_layers=18,
                num_attention_heads=16, num_key_value_heads=8,
                max_position_embeddings=4096)
    base.update(kw)
    return LlamaConfig(**base)


def llama_mid(**kw) -> LlamaConfig:
    """~0.65B: hidden 2048, 11 layers, 16 heads, 8 kv heads."""
    base = dict(vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_hidden_layers=11,
                num_attention_heads=16, num_key_value_heads=8,
                max_position_embeddings=2048)
    base.update(kw)
    return LlamaConfig(**base)


def llama_3_8b(**kw) -> LlamaConfig:
    base = dict(vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8,
                max_position_embeddings=8192, rope_theta=500000.0)
    base.update(kw)
    return LlamaConfig(**base)
