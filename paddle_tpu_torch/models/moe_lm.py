"""The Mixture-of-Experts causal LM (DeepSeekMoE / Qwen2-MoE style): the
configuration and the training model.

Counterpart: ``paddle_tpu/models/moe_lm.py`` (``MoEConfig`` :26-66,
``_DenseMLP`` :69, ``MoEBlock`` :80, ``MoEDecoderLayer`` :108,
``MoEModel`` :172, ``MoEForCausalLM`` :200 and the configs :250-278).
The port keeps its own copy so that it never imports the JAX package;
fields, defaults and parameter names are the same, so JAX weights carry
over one to one (``load_numpy_state``), and ``num_activated_params``
counts by those names.

Llama-style blocks (the port's ``LlamaAttention``: RoPE, GQA, the flash
kernels on the card) whose MLP is, from layer ``first_k_dense_replace``
on, an ``nn.MoELayer`` (top-k routed experts, dense GShard or ragged
dropless dispatch) plus ``num_shared_experts`` always-on experts as one
SiLU-gated MLP of that many expert widths; the first layers keep a dense
SiLU-gated MLP of ``intermediate_size``. The loss is the shifted cross
entropy (dense, or chunked with ``chunked_ce_tokens``) plus
``aux_loss_weight`` times the sum of the MoE layers' load-balancing
losses from the same forward.

Dtypes follow the JAX code: every weight is float32 (experts and the
router included), the RMSNorm gains take ``cfg.dtype``, activations turn
``cfg.dtype`` after the embedding; the router runs in float32.

``use_recompute`` runs each layer under ``distributed.fleet.recompute``
at ``recompute_granularity`` "full" (the whole layer; a MoE layer
through ``_MoEBlockFn``, whose aux loss leaves the checkpoint as an
output and so keeps its gradient path to the router), "full_attn" (the
attention only) or "core_attn" (the plain forward), as JAX's
``MoEDecoderLayer.forward`` does.

``tensor_parallel`` without a fleet mesh, or at mp 1, builds the plain
model, as in JAX. Under an mp mesh the MoE layer raises: JAX shards its
experts over mp when there is no ep axis, which is expert parallelism
(ROADMAP queue 1, item 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..nn import functional as F
from ..numpy_bridge import load_numpy_state
from ..distributed.fleet import recompute
from .llama import LlamaAttention, LlamaConfig

__all__ = ["MoEConfig", "MoEForCausalLM", "MoEModel", "MoEBlock",
           "MoEDecoderLayer", "moe_tiny", "deepseek_moe_16b_like",
           "qwen2_moe_a14b_like"]


@dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632        # shared-expert/dense FFN width
    moe_intermediate_size: int = 1408    # per-expert FFN width
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 8
    num_experts_per_tok: int = 2
    num_shared_experts: int = 1          # DeepSeek-style dense experts
    first_k_dense_replace: int = 1       # first k layers use dense MLP
    capacity_factor: float = 1.25
    # 'dense' = GShard one-hot dispatch; 'ragged' = sort-based dropless
    moe_dispatch_mode: str = "dense"
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    aux_loss_weight: float = 0.01
    dtype: str = "float32"
    use_recompute: bool = False
    recompute_granularity: str = "full"
    tensor_parallel: bool = False
    # >0: forward() returns hidden states; loss() runs the chunked
    # head product + cross entropy
    chunked_ce_tokens: int = 0

    def _attn_cfg(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            dtype=self.dtype, tensor_parallel=self.tensor_parallel)


class _DenseMLP(nn.Module):
    """The SiLU-gated MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, d_model, d_hidden, gen, dev):
        super().__init__()
        lin = dict(bias_attr=False, generator=gen, device=dev)
        self.gate_proj = pnn.Linear(d_model, d_hidden, **lin)
        self.up_proj = pnn.Linear(d_model, d_hidden, **lin)
        self.down_proj = pnn.Linear(d_hidden, d_model, **lin)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEBlock(nn.Module):
    """Routed experts plus the optional shared (always-on) experts."""

    def __init__(self, cfg: MoEConfig, gen, dev):
        super().__init__()
        self.moe = pnn.MoELayer(
            d_model=cfg.hidden_size, d_hidden=cfg.moe_intermediate_size,
            num_experts=cfg.num_experts, gate="gshard",
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor,
            dispatch_mode=cfg.moe_dispatch_mode, generator=gen, device=dev)
        self.shared = _DenseMLP(
            cfg.hidden_size,
            cfg.moe_intermediate_size * cfg.num_shared_experts,
            gen, dev) if cfg.num_shared_experts > 0 else None

    def forward(self, x):
        routed = self.moe(x)
        if self.shared is not None:
            routed = routed + self.shared(x)
        return routed

    @property
    def aux_loss(self):
        return self.moe.aux_loss


class MoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MoEConfig, layer_idx: int, gen, dev):
        super().__init__()
        self.input_layernorm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                           dtype=cfg.dtype, device=dev)
        self.self_attn = LlamaAttention(cfg._attn_cfg(), gen, dev)
        self.post_attention_layernorm = pnn.RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, dtype=cfg.dtype, device=dev)
        self.is_dense = layer_idx < cfg.first_k_dense_replace
        if self.is_dense:
            self.mlp = _DenseMLP(cfg.hidden_size, cfg.intermediate_size,
                                 gen, dev)
        else:
            self.mlp = MoEBlock(cfg, gen, dev)
        self.use_recompute = cfg.use_recompute
        self.recompute_granularity = cfg.recompute_granularity

    def _attn(self, x):
        return self.self_attn(self.input_layernorm(x))

    def _block(self, x):
        h = x + self._attn(x)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x):
        if not self.use_recompute:
            return self._block(x)
        gran = self.recompute_granularity
        if gran == "full":
            if isinstance(self.mlp, MoEBlock):
                # the aux loss crosses the checkpoint as an output; the
                # layer keeps the forward's, not the recomputation's
                out, aux = recompute(_MoEBlockFn(self), x)
                self.mlp.moe._aux_loss = aux
                return out
            return recompute(self._block, x)
        if gran == "full_attn":
            h = x + recompute(self._attn, x)
            return h + self.mlp(self.post_attention_layernorm(h))
        if gran == "core_attn":
            return self._block(x)
        raise ValueError(
            f"unknown recompute_granularity {gran!r}; expected 'full', "
            "'full_attn' or 'core_attn'")


class _MoEBlockFn:
    """A MoE decoder layer as a recompute region returning (output, aux
    loss). The backward runs it again, and the MoE layer's forward stores
    its aux loss and routing stats on itself each time: a rerun puts the
    forward's back, so ``aux_losses()`` and ``routing_stats`` read the
    same before and after the backward."""

    def __init__(self, layer):
        self.layer = layer
        self.ran = False

    def __call__(self, x):
        moe = self.layer.mlp.moe
        kept = moe._aux_loss, moe._last_stats
        try:
            out = self.layer._block(x)
            return out, moe._aux_loss
        finally:
            # the checkpoint may stop a rerun early by raising once it
            # has what the backward needs
            if self.ran:
                moe._aux_loss, moe._last_stats = kept
            self.ran = True


class MoEModel(nn.Module):
    def __init__(self, cfg: MoEConfig, gen, dev):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                          generator=gen, device=dev)
        self.layers = nn.ModuleList(
            [MoEDecoderLayer(cfg, i, gen, dev)
             for i in range(cfg.num_hidden_layers)])
        self.norm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                dtype=cfg.dtype, device=dev)

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        if self.cfg.dtype != "float32":
            h = h.to(pnn.initializer.convert_dtype(self.cfg.dtype))
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)

    def aux_losses(self):
        """The MoE layers' load-balancing losses of the last forward, in
        layer order."""
        return [layer.mlp.aux_loss for layer in self.layers
                if isinstance(layer.mlp, MoEBlock)
                and layer.mlp.aux_loss is not None]


class MoEForCausalLM(nn.Module):
    """The causal LM. Weights are made from ``seed`` with a
    ``torch.Generator`` on ``device`` (``None``: cuda, raising without a
    card); ``load_numpy_state`` replaces them with JAX's."""

    def __init__(self, cfg: MoEConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.model = MoEModel(cfg, gen, dev)
        self.lm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, generator=gen, device=dev)

    def forward(self, input_ids):
        """Logits [b, s, vocab]; with ``chunked_ce_tokens`` the hidden
        states (``loss`` owns the head product)."""
        h = self.model(input_ids)
        if self.cfg.chunked_ce_tokens:
            return h
        return self.lm_head(h)

    def loss(self, logits, labels):
        """Shifted cross entropy (float32) plus ``aux_loss_weight`` times
        the summed load-balancing losses of the forward that made
        ``logits``."""
        if self.cfg.chunked_ce_tokens:
            ce = F.chunked_causal_lm_loss(
                logits, labels, self.lm_head.weight, None,
                int(self.cfg.chunked_ce_tokens))
        else:
            v = logits.shape[-1]
            ce = F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                                 labels[:, 1:].reshape(-1))
        aux = self.model.aux_losses()
        if aux and self.cfg.aux_loss_weight:
            total_aux = aux[0]
            for a in aux[1:]:
                total_aux = total_aux + a
            ce = ce + self.cfg.aux_loss_weight * total_aux
        return ce

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def num_activated_params(self) -> int:
        """Parameters a token activates: each MoE layer's experts count
        top_k / num_experts of their size."""
        total = 0
        for name, p in self.named_parameters():
            if ".moe." in name and ("w1" in name or "w2" in name
                                    or "experts" in name):
                total += p.numel() * self.cfg.num_experts_per_tok \
                    // self.cfg.num_experts
            else:
                total += p.numel()
        return total

    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}`` (the JAX model's
        ``named_parameters()`` as numpy) into this model: every name must
        be present and no other, shapes and dtypes must be equal;
        bfloat16 arrays are carried bit for bit."""
        load_numpy_state(self, state)


def moe_tiny(**kw) -> MoEConfig:
    base = dict(vocab_size=512, hidden_size=128,
                intermediate_size=256, moe_intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, num_experts=4,
                num_experts_per_tok=2, first_k_dense_replace=1,
                max_position_embeddings=256)
    base.update(kw)
    return MoEConfig(**base)


def deepseek_moe_16b_like(**kw) -> MoEConfig:
    """DeepSeek-MoE-16B's widths. Any field may be overridden, depth
    too (JAX's raises on a field it sets itself, such as
    ``num_hidden_layers``)."""
    base = dict(vocab_size=102400, hidden_size=2048,
                intermediate_size=10944, moe_intermediate_size=1408,
                num_hidden_layers=28, num_attention_heads=16,
                num_key_value_heads=16, num_experts=64,
                num_experts_per_tok=6, num_shared_experts=2,
                first_k_dense_replace=1, max_position_embeddings=4096)
    base.update(kw)
    return MoEConfig(**base)


def qwen2_moe_a14b_like(**kw) -> MoEConfig:
    """Qwen2-MoE-A14B's widths; any field may be overridden, as in
    ``deepseek_moe_16b_like``."""
    base = dict(vocab_size=151936, hidden_size=3584,
                intermediate_size=18944, moe_intermediate_size=2560,
                num_hidden_layers=28, num_attention_heads=28,
                num_key_value_heads=4, num_experts=64,
                num_experts_per_tok=8, num_shared_experts=1,
                first_k_dense_replace=0, max_position_embeddings=8192)
    base.update(kw)
    return MoEConfig(**base)
