"""DiT, the diffusion transformer: the configuration and the training
model.

Counterpart: ``paddle_tpu/models/dit.py`` (``DiTConfig`` :28-41,
``TimestepEmbedder`` :44-63, ``LabelEmbedder`` :66-87, ``DiTBlock``
:94-132, ``FinalLayer`` :135-151, ``DiT`` :154-212 and the configs
:226-239). The port keeps its own copy so that it never imports the JAX
package; fields, defaults and parameter names are the same, so JAX
weights carry over one to one (``load_numpy_state``).

The model: a stride-p ``Conv2D`` patchify plus a learned position table,
a timestep embedding (sinusoidal frequencies, then a two-layer MLP) and
a class-label embedding summed into the conditioning ``c``, then
``depth`` blocks with adaLN-Zero conditioning (six modulation vectors
from ``c`` shift, scale and gate the attention and the tanh-GELU MLP),
a final adaLN layer and the unpatchify to [B, out_C, H, W] (the noise,
and sigma with ``learn_sigma``). The last ``adaLN_modulation`` Linear of
every block and the final ``linear`` start at zero, so a new model's
blocks are identities and its output is 0.

Dtypes follow the JAX code: every parameter is float32; the patchify
runs in x's dtype, and the position table, the frequencies (always
float32) and the embedders keep float32 until ``h`` and ``c`` are
narrowed to ``cfg.dtype`` after the sums. Attention (head_dim
hidden / heads: 72 at DiT-XL/2) runs the port's flash kernels on the
card and their plain version on the CPU.

Label dropout (classifier-free guidance) in training draws from the
caller's ``torch.Generator`` (``forward(..., generator=)``), as the
port's attention dropout does; JAX draws from its threefry stream, so a
seed gives other masks. Training with ``class_dropout_prob > 0`` and no
generator raises; eval never drops. ``use_recompute`` recomputes each
block through ``distributed.fleet.recompute``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..distributed.fleet import recompute
from ..nn import functional as F
from ..numpy_bridge import load_numpy_state

__all__ = ["DiTConfig", "DiT", "TimestepEmbedder", "LabelEmbedder",
           "DiTBlock", "FinalLayer", "dit_tiny", "dit_s_2", "dit_xl_2"]


@dataclass
class DiTConfig:
    input_size: int = 32           # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = True
    dtype: str = "float32"
    use_recompute: bool = False


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequencies (float32) -> Linear, SiLU, Linear."""

    def __init__(self, hidden_size, freq_dim=256, generator=None,
                 device=None):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = pnn.Sequential(
            pnn.Linear(freq_dim, hidden_size, generator=generator,
                       device=device),
            pnn.Silu(),
            pnn.Linear(hidden_size, hidden_size, generator=generator,
                       device=device))

    def forward(self, t):
        half = self.freq_dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], -1))


class LabelEmbedder(nn.Module):
    """Class-label embedding with classifier-free-guidance dropout to an
    extra "null" class (``num_classes``)."""

    def __init__(self, num_classes, hidden_size, dropout_prob,
                 generator=None, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = pnn.Embedding(
            num_classes + 1, hidden_size, generator=generator, device=device)

    def forward(self, labels, generator=None):
        if self.training and self.dropout_prob > 0:
            if generator is None:
                raise ValueError(
                    "LabelEmbedder: class dropout in training needs a "
                    "torch.Generator (DiT.forward(..., generator=))")
            keep = torch.rand(labels.shape, generator=generator,
                              device=labels.device) >= self.dropout_prob
            labels = torch.where(keep, labels, self.num_classes)
        return self.embedding_table(labels)


def _modulate(x, shift, scale):
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def _zero_(linear):
    with torch.no_grad():
        linear.weight.zero_()
        linear.bias.zero_()


class DiTBlock(nn.Module):
    """Transformer block with adaLN-Zero conditioning."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0,
                 generator=None, device=None):
        super().__init__()
        gen, dev = generator, device
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.norm1 = pnn.LayerNorm(hidden_size, epsilon=1e-6,
                                   weight_attr=False, bias_attr=False,
                                   device=dev)
        self.qkv = pnn.Linear(hidden_size, 3 * hidden_size, generator=gen,
                              device=dev)
        self.proj = pnn.Linear(hidden_size, hidden_size, generator=gen,
                               device=dev)
        self.norm2 = pnn.LayerNorm(hidden_size, epsilon=1e-6,
                                   weight_attr=False, bias_attr=False,
                                   device=dev)
        mlp_hidden = int(hidden_size * mlp_ratio)
        self.mlp = pnn.Sequential(
            pnn.Linear(hidden_size, mlp_hidden, generator=gen, device=dev),
            pnn.GELU(approximate=True),
            pnn.Linear(mlp_hidden, hidden_size, generator=gen, device=dev))
        # adaLN-Zero: six modulation vectors, the projection zeroed so the
        # block starts as the identity
        self.adaLN_modulation = pnn.Sequential(
            pnn.Silu(), pnn.Linear(hidden_size, 6 * hidden_size,
                                   generator=gen, device=dev))
        _zero_(self.adaLN_modulation[1])

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        b, s = x.shape[0], x.shape[1]
        h = _modulate(self.norm1(x), shift_msa, scale_msa)
        qkv = self.qkv(h).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = F.scaled_dot_product_attention(q, k, v)
        attn = self.proj(attn.reshape(b, s, -1))
        x = x + gate_msa.unsqueeze(1) * attn
        h = _modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp.unsqueeze(1) * self.mlp(h)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size, patch_size, out_channels,
                 generator=None, device=None):
        super().__init__()
        self.norm_final = pnn.LayerNorm(hidden_size, epsilon=1e-6,
                                        weight_attr=False, bias_attr=False,
                                        device=device)
        self.linear = pnn.Linear(hidden_size,
                                 patch_size * patch_size * out_channels,
                                 generator=generator, device=device)
        _zero_(self.linear)
        self.adaLN_modulation = pnn.Sequential(
            pnn.Silu(), pnn.Linear(hidden_size, 2 * hidden_size,
                                   generator=generator, device=device))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(_modulate(self.norm_final(x), shift, scale))


class DiT(nn.Module):
    """The diffusion transformer. Weights are made from ``seed`` with a
    ``torch.Generator`` on ``device`` (``None``: cuda, raising without a
    card); ``load_numpy_state`` replaces them with JAX's."""

    def __init__(self, cfg: DiTConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.out_channels = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.x_embedder = pnn.Conv2D(cfg.in_channels, cfg.hidden_size,
                                     cfg.patch_size, stride=cfg.patch_size,
                                     generator=gen, device=dev)
        self.t_embedder = TimestepEmbedder(cfg.hidden_size, generator=gen,
                                           device=dev)
        self.y_embedder = LabelEmbedder(cfg.num_classes, cfg.hidden_size,
                                        cfg.class_dropout_prob,
                                        generator=gen, device=dev)
        n_patches = (cfg.input_size // cfg.patch_size) ** 2
        self.pos_embed = nn.Parameter(0.02 * pnn.initializer.Normal()(
            (1, n_patches, cfg.hidden_size), torch.float32, gen, dev))
        self.blocks = pnn.LayerList([
            DiTBlock(cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                     generator=gen, device=dev) for _ in range(cfg.depth)])
        self.final_layer = FinalLayer(cfg.hidden_size, cfg.patch_size,
                                      self.out_channels, generator=gen,
                                      device=dev)

    def unpatchify(self, x):
        """[B, N, p * p * c] -> [B, c, H, W] (JAX's bhwpqc -> bchpwq)."""
        c, p = self.out_channels, self.cfg.patch_size
        b, hw = x.shape[0], math.isqrt(x.shape[1])
        x = x.reshape(b, hw, hw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, hw * p, hw * p)

    def forward(self, x, t, y, generator=None):
        """x: [B, C, H, W] noisy latents; t: [B] timesteps; y: [B]
        labels; ``generator``: the label dropout's draws (training with
        ``class_dropout_prob > 0`` needs one). Returns the predicted
        noise [B, out_C, H, W]."""
        h = self.x_embedder(x).flatten(2).transpose(1, 2)  # [B, N, hidden]
        h = h + self.pos_embed
        c = self.t_embedder(t) + self.y_embedder(y, generator)
        if self.cfg.dtype != "float32":
            # the float32 tables and embedders are summed first; the
            # blocks run at the configured precision
            dt = pnn.initializer.convert_dtype(self.cfg.dtype)
            h, c = h.to(dt), c.to(dt)
        for block in self.blocks:
            h = recompute(block, h, c) if self.cfg.use_recompute \
                else block(h, c)
        return self.unpatchify(self.final_layer(h, c))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def load_numpy_state(self, state: dict):
        """Copy ``{name: np.ndarray}`` (the JAX model's
        ``named_parameters()`` as numpy) into this model: every name must
        be present and no other, shapes and dtypes must be equal."""
        load_numpy_state(self, state)


def dit_tiny(**kw) -> DiTConfig:
    base = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                depth=2, num_heads=4, num_classes=10)
    base.update(kw)
    return DiTConfig(**base)


def dit_s_2(**kw) -> DiTConfig:
    base = dict(patch_size=2, hidden_size=384, depth=12, num_heads=6)
    base.update(kw)
    return DiTConfig(**base)


def dit_xl_2(**kw) -> DiTConfig:
    base = dict(patch_size=2, hidden_size=1152, depth=28, num_heads=16)
    base.update(kw)
    return DiTConfig(**base)
