"""Rotary position embedding tables. Counterpart:
``paddle_tpu/ops/rope.py`` (``build_rope_cache``): float32 tables and
the same ``inv_freq`` formula; layout [1, seq, 1, head_dim]."""
from __future__ import annotations

import torch

__all__ = ["build_rope_cache", "rotate_half"]


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     dtype=torch.float32, device=None):
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                      # [s, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)               # [s, d]
    cos = emb.cos()[None, :, None, :].to(dtype)
    sin = emb.sin()[None, :, None, :].to(dtype)
    return cos, sin
