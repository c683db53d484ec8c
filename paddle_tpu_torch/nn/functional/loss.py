"""``cross_entropy`` with hard labels. Counterpart:
``paddle_tpu/nn/functional/loss.py:29-75``: log-softmax in float32 over
the last axis, the label's log-probability picked, ``ignore_index``
labels masked out, and ``reduction="mean"`` averaging over the valid
labels only (at least one). Soft labels, class weights and label
smoothing are not ported."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


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
