"""Cross entropy. Counterparts in ``paddle_tpu/nn/functional/loss.py``:

- ``cross_entropy`` with hard labels (:29-75): log-softmax in float32
  over the last axis, the label's log-probability picked,
  ``ignore_index`` labels masked out, and ``reduction="mean"`` averaging
  over the valid labels only (at least one). Soft labels, class weights
  and label smoothing are not ported.
- ``chunked_softmax_cross_entropy`` / ``chunked_causal_lm_loss``
  (:342-402): the head product and the shifted cross entropy in chunks
  of tokens, each chunk under ``torch.utils.checkpoint`` (JAX: a scan of
  ``jax.checkpoint`` bodies), so that the [N, V] logits are never held
  whole; the backward recomputes one chunk's logits at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["cross_entropy", "chunked_softmax_cross_entropy",
           "chunked_causal_lm_loss"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, label_smoothing=0.0):
    """input [..., classes]; label [...] of class ids."""
    if soft_label or weight is not None or label_smoothing:
        raise NotImplementedError(
            "cross_entropy: soft labels, class weights and label "
            "smoothing are not ported yet (ROADMAP queue 1, item 9)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros((), device=logp.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    if reduction == "sum":
        return loss.sum()
    return loss


def _chunk_loss(hc, yc, mc, weight, transpose_weight):
    """Summed cross entropy of one chunk: hc [c, D], yc [c] (ids, 0 where
    masked), mc [c] float32 mask."""
    wm = weight.t() if transpose_weight else weight
    logits = (hc @ wm.to(hc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, yc[:, None].long())[:, 0]
    return ((lse - tgt) * mc).sum()


def chunked_softmax_cross_entropy(hidden, labels, weight, chunk_tokens: int,
                                  transpose_weight: bool = False,
                                  ignore_index: int = -100):
    """Head product + shifted cross entropy in chunks of
    ``chunk_tokens`` tokens. hidden [B, S, D]; labels [B, S] (shifted
    here, like the dense loss); weight [D, V] (or [V, D] with
    transpose_weight=True, the tied-embedding layout), cast to the
    hidden dtype in the product. The tokens are padded to whole chunks
    with ``ignore_index``, which is masked from the sum and the count:
    the mean over valid tokens, as ``cross_entropy`` gives it."""
    b, s, d = hidden.shape
    hs = hidden[:, :-1].reshape(b * (s - 1), d)
    ys = labels[:, 1:].reshape(-1)
    n = hs.shape[0]
    nc = -(-n // chunk_tokens)
    pad = nc * chunk_tokens - n
    if pad:
        hs = torch.nn.functional.pad(hs, (0, 0, 0, pad))
        ys = torch.nn.functional.pad(ys, (0, pad), value=ignore_index)
    valid = ys != ignore_index
    mask = valid.float()
    ys_safe = torch.where(valid, ys, torch.zeros_like(ys))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * chunk_tokens, (c + 1) * chunk_tokens)
        total = total + checkpoint(_chunk_loss, hs[sl], ys_safe[sl],
                                   mask[sl], weight, transpose_weight,
                                   use_reentrant=False)
    return total / mask.sum().clamp(min=1.0)


def chunked_causal_lm_loss(hidden, labels, lm_head_weight, embedding_weight,
                           chunk_tokens: int, ignore_index: int = -100):
    """The causal LM's chunked loss: the lm_head weight, or (None: tied
    embeddings) the embedding table transposed."""
    if lm_head_weight is not None:
        return chunked_softmax_cross_entropy(
            hidden, labels, lm_head_weight, chunk_tokens,
            ignore_index=ignore_index)
    return chunked_softmax_cross_entropy(
        hidden, labels, embedding_weight, chunk_tokens,
        transpose_weight=True, ignore_index=ignore_index)
