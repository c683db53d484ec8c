"""GPT / ERNIE: the configuration and the training model.

Counterpart: ``paddle_tpu/models/gpt.py`` (``GPTConfig`` :27-44,
``GPTAttention``, ``GPTMLP``, ``GPTDecoderLayer`` with recompute
:111-165, ``GPTModel`` :169-197, ``GPTForCausalLM`` :200-235, and the
configs :238-258). The port keeps its own copy so that it never imports
the JAX package; fields, defaults and parameter names are the same, so
JAX weights carry over one to one (``load_numpy_state``).

The family differs from Llama in learned absolute position embeddings,
pre-LN LayerNorm with bias, a fused q/k/v projection with biases, an
exact-erf GELU MLP with biases and multi-head attention (as many kv
heads as heads). Dtypes follow the JAX code: every parameter is float32,
LayerNorm's included; activations turn ``cfg.dtype`` after the summed
token and position embeddings, and ``F.linear`` casts each weight and
bias to the activation's dtype. A tied model's logits are ``h @
embed.T`` in the promoted dtype, as ``jnp.matmul`` gives them.

JAX's options, ported: ``tie_word_embeddings``, ``use_recompute`` with
the three granularities of ``LlamaConfig`` ("full", "full_attn",
"core_attn") through ``distributed.fleet.recompute``,
``chunked_ce_tokens``, and ``tensor_parallel`` under a fleet mesh whose
mp axis is larger than 1 (inert without one, as in JAX): qkv_proj and
fc_in column-parallel, out_proj and fc_out row-parallel, the token
embedding vocab-parallel, the position embedding and the untied head
plain, as JAX's. JAX's qkv_proj is one column layer over [q | k | v]
whose output GSPMD reshuffles onto the heads; the port cuts its weight
and bias strided (``qkv_groups=3``), so rank r holds the q, k and v
columns of its own heads and attends them without a reshuffle, while
the logical parameter keeps JAX's [hidden, 3 * hidden] layout. Not
ported: nonzero ``hidden_dropout`` / ``attention_dropout``; a config
asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..distributed.fleet import recompute
from ..distributed.fleet.mpu import (ColumnParallelLinear, LogicalParameters,
                                     RowParallelLinear,
                                     VocabParallelEmbedding, mp_devices)
from ..nn import functional as F
from ..numpy_bridge import load_numpy_state

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_345m", "ernie_45_dense_3b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    tie_word_embeddings: bool = True
    dtype: str = "float32"
    use_recompute: bool = False
    # 'full' | 'full_attn' | 'core_attn' (see LlamaConfig)
    recompute_granularity: str = "full"
    tensor_parallel: bool = False
    # >0: forward() returns hidden states; loss() runs the chunked
    # head-matmul + CE (see nn.functional.chunked_softmax_cross_entropy)
    chunked_ce_tokens: int = 0

    @property
    def num_key_value_heads(self) -> int:
        """Multi-head attention: one kv head per query head."""
        return self.num_attention_heads


_GRANULARITIES = ("full", "full_attn", "core_attn")


def _tp(cfg) -> bool:
    """``tensor_parallel`` under a fleet mesh with mp > 1."""
    return bool(cfg.tensor_parallel) and mp_devices() is not None


def _check_ported(cfg: GPTConfig):
    if cfg.hidden_dropout or cfg.attention_dropout:
        raise NotImplementedError(
            "GPTConfig asks for hidden_dropout / attention_dropout > 0: "
            "dropout in GPT training is not ported yet")


class GPTAttention(LogicalParameters, nn.Module):
    def __init__(self, cfg: GPTConfig, gen, dev):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        h = cfg.hidden_size
        self._tp = _tp(cfg)
        if self._tp:
            mp = len(mp_devices())
            if self.num_heads % mp:
                raise ValueError(f"num_heads {self.num_heads} must divide "
                                 f"mp degree {mp}")
            self.qkv_proj = ColumnParallelLinear(
                h, 3 * h, gather_output=False, generator=gen, device=dev,
                qkv_groups=3)
            self.out_proj = RowParallelLinear(h, h, input_is_parallel=True,
                                              generator=gen, device=dev)
            return
        self.qkv_proj = pnn.Linear(h, 3 * h, generator=gen, device=dev)
        self.out_proj = pnn.Linear(h, h, generator=gen, device=dev)

    def _attend(self, qkv):
        """Causal attention of [b, s, 3 * heads * d] (all heads, or one
        mp rank's) -> [b, s, heads * d]."""
        b, s = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(b, s, 3, -1, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return out.reshape(b, s, -1)

    def forward(self, x):
        if self._tp:
            return self.out_proj.shard_forward(
                [self._attend(y) for y in self.qkv_proj.shard_forward(x)],
                like=x)
        return self.out_proj(self._attend(self.qkv_proj(x)))


class GPTMLP(LogicalParameters, nn.Module):
    def __init__(self, cfg: GPTConfig, gen, dev):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self._tp = _tp(cfg)
        if self._tp:
            self.fc_in = ColumnParallelLinear(h, i, gather_output=False,
                                              generator=gen, device=dev)
            self.fc_out = RowParallelLinear(i, h, input_is_parallel=True,
                                            generator=gen, device=dev)
            return
        self.fc_in = pnn.Linear(h, i, generator=gen, device=dev)
        self.fc_out = pnn.Linear(i, h, generator=gen, device=dev)

    def forward(self, x):
        if self._tp:
            return self.fc_out.shard_forward(
                [F.gelu(y) for y in self.fc_in.shard_forward(x)], like=x)
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTDecoderLayer(LogicalParameters, nn.Module):
    def __init__(self, cfg: GPTConfig, gen, dev):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = pnn.LayerNorm(cfg.hidden_size, epsilon=eps, device=dev)
        self.attn = GPTAttention(cfg, gen, dev)
        self.ln_2 = pnn.LayerNorm(cfg.hidden_size, epsilon=eps, device=dev)
        self.mlp = GPTMLP(cfg, gen, dev)
        self.use_recompute = cfg.use_recompute
        self.recompute_granularity = cfg.recompute_granularity

    def _attn_sub(self, x):
        return self.attn(self.ln_1(x))

    def _mlp_sub(self, x):
        return self.mlp(self.ln_2(x))

    def _block(self, x):
        h = x + self._attn_sub(x)
        return h + self._mlp_sub(h)

    def forward(self, x):
        if not self.use_recompute:
            return self._block(x)
        gran = self.recompute_granularity
        if gran == "full":
            return recompute(self._block, x)
        if gran == "full_attn":
            h = x + recompute(self._attn_sub, x)
            return h + self._mlp_sub(h)
        if gran == "core_attn":
            return self._block(x)
        raise ValueError(f"unknown recompute_granularity {gran!r}; "
                         f"expected one of {_GRANULARITIES}")


class GPTModel(LogicalParameters, nn.Module):
    def __init__(self, cfg: GPTConfig, gen, dev):
        super().__init__()
        _check_ported(cfg)
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
        self.embed_positions = pnn.Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, generator=gen,
                                             device=dev)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(cfg, gen, dev)
             for _ in range(cfg.num_hidden_layers)])
        self.ln_f = pnn.LayerNorm(cfg.hidden_size,
                                  epsilon=cfg.layer_norm_epsilon, device=dev)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        if s > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        pos = torch.arange(s, device=input_ids.device)
        h = self.embed_tokens(input_ids) + self.embed_positions(pos)[None]
        if self.cfg.dtype != "float32":
            h = h.to(pnn.initializer.convert_dtype(self.cfg.dtype))
        for layer in self.layers:
            h = layer(h)
        return self.ln_f(h)


class GPTForCausalLM(LogicalParameters, nn.Module):
    """The causal LM. Weights are made from ``seed`` with a
    ``torch.Generator`` on ``device`` (``None``: cuda, raising without a
    card); ``load_numpy_state`` replaces them with JAX's."""

    def __init__(self, cfg: GPTConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, gen, dev)
        self.lm_head = None if cfg.tie_word_embeddings else pnn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias_attr=False, generator=gen,
            device=dev)

    def forward(self, input_ids):
        """Logits [b, s, vocab]; with ``chunked_ce_tokens`` the hidden
        states (``loss`` owns the head product)."""
        h = self.gpt(input_ids)
        if self.cfg.chunked_ce_tokens:
            return h
        if self.lm_head is None and isinstance(self.gpt.embed_tokens,
                                               VocabParallelEmbedding):
            return self.gpt.embed_tokens.head(h)
        if self.lm_head is None:
            w = self.gpt.embed_tokens.weight
            dt = torch.promote_types(h.dtype, w.dtype)
            return torch.matmul(h.to(dt), w.t().to(dt))
        return self.lm_head(h)

    def loss(self, logits, labels):
        """Shifted causal-LM cross entropy (float32). With
        ``chunked_ce_tokens`` > 0, ``logits`` are the hidden states that
        ``forward`` returned and the head product runs chunk by chunk."""
        if self.cfg.chunked_ce_tokens:
            return F.chunked_causal_lm_loss(
                logits, labels,
                None if self.lm_head is None else self.lm_head.weight,
                self.gpt.embed_tokens.weight,
                int(self.cfg.chunked_ce_tokens))
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1))

    def num_params(self) -> int:
        """Logical parameters (a tp model's shards add up to them)."""
        return sum(p.numel() for p in self.shard_parameters())

    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}`` (the JAX model's
        ``named_parameters()`` as numpy) into this model: every name must
        be present and no other (a tied model has no ``lm_head.weight``),
        shapes and dtypes must be equal."""
        load_numpy_state(self, state)


def gpt_tiny(**kw) -> GPTConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=256)
    base.update(kw)
    return GPTConfig(**base)


def gpt_345m(**kw) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=1024, intermediate_size=4096,
                num_hidden_layers=24, num_attention_heads=16,
                max_position_embeddings=1024)
    base.update(kw)
    return GPTConfig(**base)


def ernie_45_dense_3b(**kw) -> GPTConfig:
    """ERNIE-4.5-style dense config (hidden 2560, 28 layers, 20 heads of
    128, vocab 103424, untied head)."""
    base = dict(vocab_size=103424, hidden_size=2560,
                intermediate_size=12288, num_hidden_layers=28,
                num_attention_heads=20, max_position_embeddings=4096,
                tie_word_embeddings=False)
    base.update(kw)
    return GPTConfig(**base)
