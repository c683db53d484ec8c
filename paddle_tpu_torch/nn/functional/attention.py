"""Attention functionals in paddle's layout [batch, seq, heads,
head_dim]. Counterpart: ``paddle_tpu/nn/functional/attention.py:18-66``
(``scaled_dot_product_attention``, ``flash_attn_unpadded``).

Attention dropout in training draws from the caller's
``torch.Generator`` (JAX draws a key from its RNG stream); dropout > 0
in training without one raises."""
from __future__ import annotations

from ...ops import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attn_unpadded"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    p = float(dropout_p) if training else 0.0
    if p and generator is None:
        raise ValueError(
            "scaled_dot_product_attention: dropout_p > 0 in training "
            "needs a torch.Generator")
    return _fa.flash_attention(query, key, value, attn_mask=attn_mask,
                               causal=is_causal, dropout=p,
                               generator=generator)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, training=True):
    """Varlen (packed-sequence) attention: query/key/value packed
    [total_tokens, heads, head_dim], cu_seqlens_* [n_seqs + 1]; the
    max_seqlen_* arguments of paddle's API are not needed. Returns
    (out, None) like the padded API."""
    if dropout and float(dropout) != 0.0 and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not implemented "
            "on the packed varlen kernel; pass dropout=0.0 (or "
            "training=False)")
    out = _fa.flash_attn_varlen(query, key, value, cu_seqlens_q,
                                cu_seqlens_k, scale=scale, causal=causal)
    return out, None
