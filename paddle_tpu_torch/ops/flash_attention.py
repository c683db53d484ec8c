"""Flash attention on tensors. Counterpart:
``paddle_tpu/ops/flash_attention.py`` (the whole file).

Layout is paddle's: q/k/v [batch, seq, num_heads, head_dim]; k/v may
have fewer heads (GQA). Causal masking aligns the queries to the END of
the keys (row r sees column c iff r + sk - sq >= c).

- ``_sdpa_core`` / ``flash_attention_reference``: the dense reference
  with an optional additive mask and dropout on the probabilities.
- ``_sdpa_segmented_core``: the dense oracle for segment-masked
  (packed, "varlen") attention.
- ``flash_attention_plain``: the plain PyTorch version of the CUDA
  kernels (``ops/cuda/flash_attention.py``), computing what the TPU
  kernel ``_flash_fwd`` computes, differentiable by autograd.
- ``flash_attention`` / ``flash_attention_segmented``: the dispatchers.
  Without a mask or dropout a CUDA tensor goes to the kernels
  (``FlashAttention``) and a CPU tensor to ``flash_attention_plain``; a
  mask or dropout goes to ``_sdpa_core`` on either device, as in JAX.
  JAX's ``min_seq`` and block-divisibility tests are TPU tiling limits:
  the CUDA kernels mask ragged edges, so there are none here.
- ``flash_attention_with_lse`` / ``flash_attention_bwd_block``: the ring
  attention blocks (``paddle_tpu/ops/pallas/flash_attention.py:526-560``),
  the same three kernels with the lse exposed and the backward run
  against a given (merged) lse. A CUDA tensor goes to the kernels, a CPU
  tensor to ``flash_attention_plain`` / ``flash_attention_bwd_plain``.
"""
from __future__ import annotations

import math

import torch

from .cuda import flash_attention as _cuda

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_plain", "flash_attention_segmented",
           "segments_from_cu_seqlens", "flash_attn_varlen",
           "flash_attention_with_lse", "flash_attention_bwd_block",
           "flash_attention_bwd_plain"]

_NEG_INF = -1e30


def _repeat_kv(k, v, h):
    rep = h // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _causal_mask(sq, sk, device):
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return qi >= torch.arange(sk, device=device)[None, :]


def _sdpa_core(q, k, v, bias, causal, scale, dropout=0.0, generator=None):
    """[b, s, h, d] reference attention with float32 softmax. Dropout
    (with a generator) is applied to the probabilities, upscale in
    train."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = torch.where(_causal_mask(sq, sk, q.device), logits,
                             torch.full((), _NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    if dropout and generator is not None:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros((), device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def flash_attention_reference(q, k, v, attn_mask=None, causal=False,
                              scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _sdpa_core(q, k, v, attn_mask, causal, scale)


def flash_attention_plain(q, k, v, causal, scale, q_seg=None, kv_seg=None):
    """The kernels' plain version: (out like q, lse float32 [b, h, sq]).

    q is scaled in float32 before the product, probabilities are float32
    with the finite -1e30 mask and the guard s > -0.5e30, so a row that
    sees no key gives out 0 and lse -1e30. GQA groups the query heads of
    a kv-head without repeating K/V. Differentiable by autograd."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qf = q.float().reshape(b, sq, hk, g, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())   # [b,hk,g,sq,sk]
    mask = None
    if causal:
        mask = _causal_mask(sq, sk, q.device)[None, None, None]
    if q_seg is not None:
        seg = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    # the max is a constant shift of the softmax: no gradient flows
    # through it (d lse / d m = 0), as in the kernels' backward
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(s > _NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros((), device=q.device))
    l_safe = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) \
        / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, sq)
    return o.reshape(b, sq, h, d).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale):
    """The backward kernels' plain version given the forward's out and a
    lse that may come from elsewhere (the ring's merged one), by the
    explicit formula of JAX's ``_jnp_blk_bwd`` (ring_attention.py:107):
    p = exp(s - lse), delta = sum(out * dout), ds = p (dp - delta) scale.
    Causal is end-aligned, as in the kernels. Returns (dq like q, dk and
    dv float32 [b, sk, hk, d], summed over each kv-head's group)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qf = q.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if causal:
        s = torch.where(_causal_mask(sq, sk, q.device)[None, None, None], s,
                        torch.full((), _NEG_INF, device=q.device))
    lse5 = lse.float().reshape(b, hk, g, sq, 1)
    p = torch.where(s > _NEG_INF * 0.5, torch.exp(s - lse5),
                    torch.zeros((), device=q.device))
    do = dout.float().reshape(b, sq, hk, g, d)
    delta = (out.float() * dout.float()).sum(-1).reshape(b, sq, hk, g) \
        .permute(0, 2, 3, 1)                               # [b,hk,g,sq]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk, dv


def _kernel_route(q, what):
    """True when q goes to the CUDA kernels, False for the plain version
    (a CPU tensor); raises for a CUDA tensor the kernels do not take."""
    if not q.is_cuda:
        return False
    if q.shape[-1] not in _cuda.HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} not in "
                         f"{_cuda.HEAD_DIMS}, which the CUDA kernels take")
    return True


def flash_attention(q, k, v, attn_mask=None, causal=False, dropout=0.0,
                    scale=None, generator=None):
    """Differentiable attention on [b, s, h, d] tensors.

    No mask and no dropout: the CUDA kernels for a CUDA tensor, the plain
    version for a CPU tensor. A mask or dropout: ``_sdpa_core``. Dropout
    > 0 needs a ``torch.Generator``; without one it raises, never a
    silent no-op."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout and generator is None:
        raise ValueError(
            "flash_attention: dropout > 0 needs a generator (the "
            "nn.functional wrappers pass the caller's when training)")
    if attn_mask is not None or dropout:
        return _sdpa_core(q, k, v, attn_mask, causal, scale, dropout,
                          generator)
    if _kernel_route(q, "flash_attention"):
        return _cuda.FlashAttention.apply(q, k, v, None, None, causal,
                                          scale)
    return flash_attention_plain(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """The ring's forward block: (out like q, lse float32 [b, h, sq]) on
    [b, s, h, d] tensors. Not differentiable; ring attention runs its
    own backward over the ring with ``flash_attention_bwd_block``. A
    CUDA tensor goes to the forward kernel (views are copied to the
    contiguous operands it takes), a CPU tensor to
    ``flash_attention_plain``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _kernel_route(q, "flash_attention_with_lse"):
        return _cuda.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale)
    return flash_attention_plain(q, k, v, causal, scale)


def flash_attention_bwd_block(q, k, v, out, lse, dout, causal=False,
                              scale=None):
    """The ring's backward block for one (q-shard, kv-shard) pair given
    the MERGED out and lse: (dq like q, dk and dv float32
    [b, sk, hk, d]). A CUDA tensor goes to the dq and dk/dv kernels, a
    CPU tensor to ``flash_attention_bwd_plain``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _kernel_route(q, "flash_attention_bwd_block"):
        return _cuda.flash_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), out,
            lse.contiguous(), dout.contiguous(), causal, scale)
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale)


def _sdpa_segmented_core(q, k, v, q_seg, kv_seg, causal, scale):
    """Dense oracle for segment-masked attention. q/k/v [b, s, h, d];
    segment ids [b, s]. Fully-masked query rows yield zero output."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    if causal:
        mask = mask & _causal_mask(sq, sk, q.device)[None, None]
    logits = torch.where(mask, logits,
                         torch.full((), _NEG_INF, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m),
                    torch.zeros((), device=q.device))
    probs = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def flash_attention_segmented(q, k, v, q_segment_ids, kv_segment_ids,
                              causal=False, scale=None):
    """Segment-masked attention: tokens attend only to equal segment ids
    (intersected with causal); rows with no visible key output zeros.
    The CUDA kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_seg = q_segment_ids.to(torch.int32)
    kv_seg = kv_segment_ids.to(torch.int32)
    if _kernel_route(q, "flash_attention_segmented"):
        return _cuda.FlashAttention.apply(q, k, v, q_seg.contiguous(),
                                          kv_seg.contiguous(), causal, scale)
    return flash_attention_plain(q, k, v, causal, scale, q_seg, kv_seg)[0]


def segments_from_cu_seqlens(cu_seqlens, total: int, pad_id: int = -1):
    """cu_seqlens [n+1] (cumulative lengths, cu[0] = 0) -> per-token
    segment ids [total] int32; tokens at or after cu[-1] get pad_id."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu[1:], pos, right=True).to(torch.int32)
    return torch.where(pos < cu[-1], seg,
                       torch.full((), pad_id, dtype=torch.int32,
                                  device=cu.device))


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, scale=None,
                      causal=False):
    """Unpadded (packed) attention. q [total_q, h, d]; k/v
    [total_k, hk, d]; cu_seqlens_* [n+1] int32. Causal is per sequence
    (q and k positions aligned, as in self-attention packing). Padding
    ids differ between q (-1) and kv (-2), so padded rows see nothing.
    Returns packed out [total_q, h, d]."""
    seg_q = segments_from_cu_seqlens(cu_seqlens_q, q.shape[0], pad_id=-1)
    seg_k = segments_from_cu_seqlens(cu_seqlens_k, k.shape[0], pad_id=-2)
    out = flash_attention_segmented(
        q[None], k[None], v[None], seg_q[None].to(q.device),
        seg_k[None].to(q.device), causal=causal, scale=scale)
    return out[0]
