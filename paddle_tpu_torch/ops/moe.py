"""Mixture-of-Experts dispatch and combine on tensors. Counterpart:
``paddle_tpu/ops/moe.py`` (``topk_gating`` :23, ``moe_dispatch_combine``
:79, ``_grouped_mm`` :112, ``moe_ragged_forward`` :127 and the
``moe_mlp_forward`` alias).

Nothing here is a Pallas kernel in JAX: the expert products are
``jax.lax.ragged_dot`` and einsums, dispatch and combine einsums and a
scatter-add, all XLA. The port computes them with PyTorch calls.

- GShard gating (``topk_gating``): softmax in float32, top-k as k rounds
  of argmax (the first index wins a tie; a chosen expert's probability
  is zeroed for the next round), each token's queue position within its
  expert from a running count that carries over from one round to the
  next, capacity slots ``[T, E, C]``. The masks and positions are
  constants (no gradient through argmax or the counts); the gates and
  their normaliser carry gradient. The load-balancing loss reads the
  top-1 mask only: ``E * sum(mean(probs) * mean(top1 mask))``.
- ``moe_dispatch_combine``: the dense GShard FFN. Dispatch and combine
  are the one-hot ``[T, E, C]`` tensors in x's dtype, applied by
  einsums, as JAX does. They are built by one scatter of the k rounds'
  slots, not by JAX's one-hot arithmetic; every slot holds at most one
  token, so the values are JAX's.
- ``moe_ragged_forward``: the sort-based dropless FFN. Top-k by a stable
  descending sort (``jax.lax.top_k``'s order), gates normalised with a
  floor of 1e-9, the token-major ``[T*k]`` expert ids sorted stably, the
  tokens gathered, the grouped products over each expert's contiguous
  rows, and a weighted ``index_add`` back to the token rows (JAX's
  ``.at[].add``), cast to x's dtype.
- Experts are ``act(x @ w1) @ w2`` (not gated); ``jax.nn.gelu`` is the
  tanh form, so the default activation here is
  ``F.gelu(approximate=True)``.

The grouped product (``_grouped_mm``) is ``torch._grouped_mm`` with the
int32 end offsets of the groups, on every device and dtype: on the card
bfloat16 takes its grouped kernel, with no host sync (the counts and
one-hots here are scatters: ``bincount`` and ``F.one_hot`` read a CUDA
tensor on the host), and float32 PyTorch's own per-group route. It needs
rows whose byte strides are multiples of 16 (D and H multiples of 8 in
bfloat16, of 4 in float32); a refusal raises.
On the card ``index_add`` accumulates with atomics, in no fixed order;
at top-2 each row adds two terms to a zero, which rounds alike in any
order.
"""
from __future__ import annotations

import torch

from ..nn import functional as F

__all__ = ["topk_gating", "moe_dispatch_combine", "moe_mlp_forward",
           "moe_ragged_forward", "gelu_tanh"]


def gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate=True)


def _one_hot(idx, n, dtype):
    """[T] ids -> [T, n] one-hot in ``dtype``; a scatter, which (unlike
    ``F.one_hot`` and ``bincount``) never reads a CUDA tensor on the
    host."""
    out = torch.zeros((idx.shape[0], n), dtype=dtype, device=idx.device)
    return out.scatter_(1, idx[:, None], 1)


def _counts(idx, n):
    """bincount(idx, minlength=n) as int64, without a host sync."""
    out = torch.zeros(n, dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx))


def _gshard_slots(logits, top_k: int, capacity: int):
    """GShard routing of logits [T, E] as flat per-assignment arrays,
    round-major ([k * T], round r at rows r*T .. r*T + T - 1): token,
    expert, queue slot (clamped to capacity - 1), whether the slot is
    within capacity (float32, a constant) and the combine weight gate /
    denom (float32, with gradient); then aux_loss and stats as JAX's
    ``topk_gating`` returns them."""
    t, e = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    remaining = probs.detach()
    experts, gates = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        experts.append(idx)
        gates.append(probs.gather(1, idx[:, None])[:, 0])
        remaining = remaining.scatter(1, idx[:, None], 0.0)

    top1 = _one_hot(experts[0], e, torch.float32)
    aux_loss = (probs.mean(dim=0) * top1.mean(dim=0)).sum() * e

    denom = gates[0]
    for g in gates[1:]:
        denom = denom + g
    denom = torch.clamp(denom, min=1e-9)
    prior_fill = torch.zeros(e, dtype=torch.int64, device=dev)
    slots, keeps = [], []
    for idx in experts:
        mask = _one_hot(idx, e, torch.int64)                  # [T, E]
        # tokens before this one routed to its expert, in this round
        # (a scan along T of the [E, T] layout), plus the earlier rounds
        before = torch.cumsum(mask.t().contiguous(), dim=1).t() - mask
        pos = before.gather(1, idx[:, None])[:, 0] + prior_fill[idx]
        keeps.append((pos < capacity).float())
        slots.append(torch.clamp(pos, max=capacity - 1))
        prior_fill = prior_fill + mask.sum(dim=0)
    expert = torch.cat(experts)
    keep = torch.cat(keeps)
    weight = torch.cat([g / denom for g in gates])
    token = torch.arange(t, device=dev).repeat(top_k)
    assigned = _counts(expert, e).float()
    routed = torch.zeros(e, dtype=torch.float32, device=dev).index_add(
        0, expert, keep)
    dropped = 1.0 - routed.sum() / torch.clamp(assigned.sum(), min=1.0)
    stats = {"tokens_per_expert": routed,
             "assigned_per_expert": assigned,
             "dropped_fraction": dropped}
    return (token, expert, torch.cat(slots), keep, weight), aux_loss, stats


def _slot_tensors(slots, t, e, capacity, dtype):
    """Dispatch and combine [T, E, C] in ``dtype`` from the flat slots:
    one scatter each (accumulating, so a slot past capacity, clamped onto
    a real one with a 0, adds nothing)."""
    token, expert, slot, keep, weight = slots
    index = (token, expert, slot)
    zeros = torch.zeros((t, e, capacity), dtype=dtype, device=keep.device)
    dispatch = zeros.index_put(index, keep.to(dtype), accumulate=True)
    combine = zeros.index_put(index, (weight * keep).to(dtype),
                              accumulate=True)
    return dispatch, combine


def topk_gating(logits, top_k: int, capacity: int):
    """GShard top-k gating with capacity slots: logits [T, E] ->
    (dispatch [T, E, C] float32 0/1, combine [T, E, C] float32 weights,
    aux_loss scalar, stats: tokens_per_expert [E] (routed within
    capacity), assigned_per_expert [E] (before capacity),
    dropped_fraction scalar)."""
    t, e = logits.shape
    slots, aux_loss, stats = _gshard_slots(logits, top_k, capacity)
    dispatch, combine = _slot_tensors(slots, t, e, capacity, torch.float32)
    return dispatch, combine, aux_loss, stats


def moe_dispatch_combine(x, gate_w, w1, w2, top_k: int,
                         capacity_factor: float, activation=gelu_tanh):
    """The dense GShard MoE FFN: x [B, S, D] -> (out [B, S, D], aux_loss,
    stats). w1 [E, D, H], w2 [E, H, D]; capacity ``max(1, int(cf * k * T
    / E))`` rounded up to a multiple of 8. stats: ``topk_gating``'s and
    ``capacity`` (float32)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    e = w1.shape[0]
    t = tokens.shape[0]
    capacity = max(1, int(capacity_factor * top_k * t / e))
    capacity = -(-capacity // 8) * 8

    logits = tokens.float() @ gate_w.float()
    slots, aux, stats = _gshard_slots(logits, top_k, capacity)
    stats = dict(stats, capacity=torch.full((), float(capacity),
                                            dtype=torch.float32,
                                            device=x.device))
    dispatch, combine = _slot_tensors(slots, t, e, capacity, x.dtype)
    # einsum("tec,td->ecd"), einsum("ecd,edh->ech"), einsum("ech,ehd->ecd")
    expert_in = (dispatch.reshape(t, e * capacity).t() @ tokens).reshape(
        e, capacity, d)
    h = activation(torch.bmm(expert_in, w1.to(x.dtype)))
    expert_out = torch.bmm(h, w2.to(x.dtype))
    # einsum("tec,ecd->td")
    out = combine.reshape(t, e * capacity) @ expert_out.reshape(
        e * capacity, d)
    return out.reshape(b, s, d), aux, stats


def _grouped_mm(lhs, rhs, group_sizes):
    """Grouped product over contiguous per-expert row segments: lhs [R,
    K] x rhs [E, K, N] -> [R, N], the rows cut into E segments by
    group_sizes ([E] integer tensor)."""
    offs = torch.cumsum(group_sizes, dim=0, dtype=torch.int32)
    return torch._grouped_mm(lhs, rhs, offs=offs)


def moe_ragged_forward(x, gate_w, w1, w2, top_k: int,
                       activation=gelu_tanh, capacity_factor=None):
    """The sort-based dropless MoE FFN: x [B, S, D] -> (out [B, S, D],
    aux_loss, stats); no capacity, so dropped_fraction is 0 and
    tokens_per_expert equals assigned_per_expert. capacity_factor is
    accepted for signature parity and ignored, as in JAX."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    e = w1.shape[0]

    logits = tokens.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    # jax.lax.top_k: descending, the lower index first among equals
    top_i = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :top_k]
    top_p = probs.gather(1, top_i)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    ce = _one_hot(top_i[:, 0], e, torch.float32).mean(dim=0)
    aux_loss = (probs.mean(dim=0) * ce).sum() * e

    flat_expert = top_i.reshape(t * top_k)
    # token-major flat layout: slot i is token i // k, choice i % k
    order = torch.argsort(flat_expert, stable=True)
    sorted_tok = order // top_k
    xs = tokens[sorted_tok]                                     # [T*k, D]
    group_sizes = _counts(flat_expert, e)

    h = activation(_grouped_mm(xs, w1.to(xs.dtype), group_sizes))
    ys = _grouped_mm(h, w2.to(xs.dtype), group_sizes)
    wsorted = gates.reshape(t * top_k)[order].to(ys.dtype)
    out = torch.zeros((t, d), dtype=ys.dtype, device=x.device).index_add(
        0, sorted_tok, ys * wsorted[:, None])

    counts = group_sizes.float()
    stats = {"tokens_per_expert": counts,
             "assigned_per_expert": counts,
             "dropped_fraction": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}
    return out.reshape(b, s, d).to(x.dtype), aux_loss, stats


moe_mlp_forward = moe_dispatch_combine
