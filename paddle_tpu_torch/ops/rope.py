"""Rotary position embedding. Counterpart: ``paddle_tpu/ops/rope.py``
(``rope_reference``, ``build_rope_cache``, ``apply_rotary_pos_emb``):
float32 tables and the same ``inv_freq`` formula; layout
[1, seq, 1, head_dim]; the tables are cast to the activation's dtype
before the multiply."""
from __future__ import annotations

import torch

__all__ = ["build_rope_cache", "rotate_half", "rope_reference",
           "apply_rotary_pos_emb"]


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


def rope_reference(x, cos, sin):
    """x: [b, s, h, d]; cos/sin: broadcastable [1, s, 1, d]."""
    return x * cos + rotate_half(x) * sin


def apply_rotary_pos_emb(q, k, cos=None, sin=None, position_ids=None,
                         base: float = 10000.0):
    """Fused-RoPE API: q/k [b, s, h, d]; builds the tables if absent;
    position_ids [b, s] pick rows of [1, s, 1, d] tables."""
    if cos is None:
        cos, sin = build_rope_cache(q.shape[1], q.shape[-1], base,
                                    q.dtype, device=q.device)
    if position_ids is not None and cos.shape[0] == 1:
        cos = cos[0, :, 0][position_ids][:, :, None, :]
        sin = sin[0, :, 0][position_ids][:, :, None, :]
    return (rope_reference(q, cos.to(q.dtype), sin.to(q.dtype)),
            rope_reference(k, cos.to(k.dtype), sin.to(k.dtype)))
