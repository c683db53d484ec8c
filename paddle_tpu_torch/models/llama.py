"""Llama: the configuration (serving and training) and the training
model.

Counterpart: ``paddle_tpu/models/llama.py`` (``LlamaConfig`` :34-72,
``_sep_mesh`` :80-97, ``LlamaMLP``, ``LlamaAttention`` without a cache
:194-222, ``LlamaDecoderLayer``, ``LlamaModel``, ``LlamaForCausalLM``
with ``forward``/``loss``/``_chunked_loss``/``num_params``, and the
``llama_*`` configs :465-500). The port keeps its own copy so that it
never imports the JAX package; fields, defaults and parameter names are
the same, so JAX weights carry over one to one (``load_numpy_state``).

Dtypes follow the JAX code, not its docs: every ``Linear`` and
``Embedding`` weight is float32; only the RMSNorm gains take
``cfg.dtype``; activations turn ``cfg.dtype`` after the embedding and
``F.linear`` casts each weight to the activation's dtype in the product.

Training without recompute is ported, with two options of JAX's:
- ``sep_degree > 1`` (context parallelism): with a fleet mesh whose sep
  axis has that size (``distributed.fleet.init``), attention runs zigzag
  ring attention over it, RoPE applied on global positions first;
  without a fleet mesh, plain attention, as in JAX.
- ``chunked_ce_tokens > 0``: ``forward`` returns the hidden states and
  ``loss`` runs the head product and cross entropy in chunks of that
  many tokens.
A config that asks for recompute, tensor or sequence parallelism or
tied embeddings raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..distributed.fleet import get_hybrid_communicate_group
from ..distributed.ring_attention import ring_attention
from ..nn import functional as F
from ..numpy_bridge import tensor_from_numpy
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


def _check_ported(cfg: LlamaConfig):
    asked = [name for name, on in (
        ("tie_word_embeddings", cfg.tie_word_embeddings),
        ("use_recompute", cfg.use_recompute),
        ("tensor_parallel", cfg.tensor_parallel),
        ("sequence_parallel", cfg.sequence_parallel)) if on]
    if asked:
        raise NotImplementedError(
            f"LlamaConfig asks for {', '.join(asked)}: not ported yet "
            f"(ROADMAP queue 1, item 9: recompute, tied embeddings; "
            f"tensor parallelism is item 5)")


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


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        lin = dict(bias_attr=False, generator=gen, device=dev)
        self.gate_proj = pnn.Linear(h, i, **lin)
        self.up_proj = pnn.Linear(h, i, **lin)
        self.down_proj = pnn.Linear(i, h, **lin)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.rope_theta = cfg.rope_theta
        self.sep_degree = cfg.sep_degree
        h, kv_out = cfg.hidden_size, self.num_kv_heads * self.head_dim
        lin = dict(bias_attr=False, generator=gen, device=dev)
        self.q_proj = pnn.Linear(h, h, **lin)
        self.k_proj = pnn.Linear(h, kv_out, **lin)
        self.v_proj = pnn.Linear(h, kv_out, **lin)
        self.o_proj = pnn.Linear(h, h, **lin)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        cos, sin = build_rope_cache(s, self.head_dim, self.rope_theta,
                                    torch.float32, device=x.device)
        q = rope_reference(q, cos.to(q.dtype), sin.to(q.dtype))
        k = rope_reference(k, cos.to(k.dtype), sin.to(k.dtype))
        sep_mesh = _sep_mesh(self.sep_degree)
        if sep_mesh is not None:
            out = ring_attention(q, k, v, sep_mesh, axis="sep", causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        self.input_layernorm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                           dtype=cfg.dtype, device=dev)
        self.self_attn = LlamaAttention(cfg, gen, dev)
        self.post_attention_layernorm = pnn.RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, dtype=cfg.dtype, device=dev)
        self.mlp = LlamaMLP(cfg, gen, dev)

    def forward(self, x):
        h = x + self.self_attn(self.input_layernorm(x))
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, dev):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed_tokens = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                          generator=gen, device=dev)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, gen, dev)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                dtype=cfg.dtype, device=dev)

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        if self.cfg.dtype != "float32":
            h = h.to(pnn.initializer.convert_dtype(self.cfg.dtype))
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
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
        self.lm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, generator=gen, device=dev)

    def forward(self, input_ids):
        h = self.model(input_ids)
        if self.cfg.chunked_ce_tokens:
            return h                    # loss() owns the head product
        return self.lm_head(h)

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
            hidden, labels, self.lm_head.weight,
            self.model.embed_tokens.weight, int(self.cfg.chunked_ce_tokens))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}`` (the JAX model's
        ``named_parameters()`` as numpy) into this model: every name must
        be present and no other, shapes and dtypes must be equal;
        bfloat16 arrays are carried bit for bit."""
        params = dict(self.named_parameters())
        missing = sorted(set(params) - set(state))
        extra = sorted(set(state) - set(params))
        if missing or extra:
            raise ValueError(f"load_numpy_state: missing {missing}, "
                             f"unexpected {extra}")
        for name, p in params.items():
            t = tensor_from_numpy(state[name], p.device)
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"load_numpy_state: {name} is {tuple(t.shape)} "
                    f"{t.dtype}, the model holds {tuple(p.shape)} {p.dtype}")
            p.copy_(t)


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
