"""Ring attention: blockwise attention with the sequence split over the
ranks of a mesh axis, K/V chunks passed around the ring. Counterpart:
``paddle_tpu/distributed/ring_attention.py`` (the whole file).

The program is single-controller, as JAX's is: one process drives every
rank, and rank r's tensors live on the mesh's r-th device along the
axis. A ``ppermute`` hop is a copy to the next rank's device (a no-op
when both ranks name the same device, as ``["cuda:0"] * 4`` does on one
card: the kernels then see exactly the shard shapes of a 4-card ring).
``ring_attention_local`` is the single-controller view of JAX's
shard_map body: it takes one chunk per rank and returns one output per
rank.

Each ring step computes (out_blk, lse_blk) of the local queries against
the visiting K/V chunk and merges it into the rank's running result by
``_merge_pair`` (logaddexp of the lse, the finite -1e30 for "nothing
seen"), ranks merging in step order t = 0..n-1. The backward is a second
ring pass against the MERGED out and lse: dq accumulates in float32 on
its rank, and the dk/dv accumulators travel with the K/V chunks and are
home after n hops.

Blocks: a CUDA tensor goes to the ring blocks ``flash_attention_with_lse``
/ ``flash_attention_bwd_block`` (the CUDA flash kernels; head_dim 64, 128
or 256, another raises), a CPU tensor to their plain versions
``flash_attention_plain`` / ``flash_attention_bwd_plain``.
``use_pallas=False`` forces the plain blocks; ``True`` on a CPU tensor
raises. JAX's gate (``_pallas_ok``: ``min_seq`` and block divisibility
of the halves) is a TPU tiling limit and has no counterpart.

Zigzag placement (the default for causal attention when the sequence
divides into 2n blocks) gives rank r the block pair (r, 2n-1-r), so
every step computes only visible work: 3 blocks on the diagonal step
and 1 on each other step, n + 2 forward and n + 2 backward blocks per
rank. In the plain (contiguous) causal ring JAX computes the blocks of
later ranks and masks them to nothing; the port skips them, since the
merge of a fully masked block changes nothing: n(n+1)/2 blocks per
direction over all ranks.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import flash_attention as _fa

_NEG_INF = -1e30

__all__ = ["ring_attention_local", "ring_attention", "zigzag_indices",
           "inverse_zigzag_indices"]


def zigzag_indices(seq_len: int, n: int):
    """Global sequence order such that a contiguous n-way split of the
    reordered sequence gives rank r the zigzag pair (block r, 2n-1-r)."""
    if seq_len % (2 * n):
        raise ValueError(f"zigzag needs seq_len ({seq_len}) divisible "
                         f"by 2*n ({2 * n})")
    blk = seq_len // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * blk, (r + 1) * blk))
        order.extend(range((2 * n - 1 - r) * blk, (2 * n - r) * blk))
    return np.asarray(order, np.int32)


def inverse_zigzag_indices(seq_len: int, n: int):
    order = zigzag_indices(seq_len, n)
    inv = np.empty_like(order)
    inv[order] = np.arange(seq_len, dtype=np.int32)
    return inv


def _blocks(qs, use_pallas):
    """(forward block, backward block) for the ranks' chunks."""
    on_card = [q.is_cuda for q in qs]
    if use_pallas is False:
        return _fa.flash_attention_plain, _fa.flash_attention_bwd_plain
    if use_pallas and not all(on_card):
        raise ValueError("ring_attention: use_pallas=True needs every "
                         "rank's tensors on a CUDA device")
    if any(on_card):
        _fa._kernel_route(qs[0], "ring_attention")   # head_dim check
    return _fa.flash_attention_with_lse, _fa.flash_attention_bwd_block


def _merge_pair(o1, l1, o2, l2):
    """Online-softmax merge of two partial results (float32)."""
    lse = torch.logaddexp(l1, l2)
    c1 = torch.exp(l1 - lse).transpose(1, 2)[..., None]
    c2 = torch.exp(l2 - lse).transpose(1, 2)[..., None]
    return o1.float() * c1 + o2.float() * c2, lse


def _halves(x, dim=1):
    half = x.shape[dim] // 2
    return x.narrow(dim, 0, half), x.narrow(dim, half, half)


def _zz_step_fwd(blk_fwd, q, k_cur, v_cur, rel, scale):
    """One zigzag step forward -> (out float32 [b, s, h, d], lse
    [b, h, s]); rel = sign(src - my): -1 an earlier rank's kv, 0 the
    rank's own, +1 a later rank's. Invisible query rows carry out 0 and
    lse -1e30, which the merge passes over."""
    b, s, h, d = q.shape
    half = s // 2
    q_e, q_l = _halves(q)
    k_e, k_l = _halves(k_cur)
    v_e, v_l = _halves(v_cur)
    if rel < 0:
        # the full q attends the visiting EARLY kv half only
        o, lse = blk_fwd(q, k_e, v_e, False, scale)
        return o.float(), lse
    if rel > 0:
        # only the late q half attends (both kv halves, fully visible)
        o, lse = blk_fwd(q_l, k_cur, v_cur, False, scale)
        z_o = torch.zeros((b, half, h, d), dtype=torch.float32,
                          device=q.device)
        z_l = torch.full((b, h, half), _NEG_INF, dtype=torch.float32,
                         device=q.device)
        return (torch.cat([z_o, o.float()], dim=1),
                torch.cat([z_l, lse], dim=2))
    o_e, l_e = blk_fwd(q_e, k_e, v_e, True, scale)
    o_l1, l_l1 = blk_fwd(q_l, k_e, v_e, False, scale)
    o_l2, l_l2 = blk_fwd(q_l, k_l, v_l, True, scale)
    o_l, l_l = _merge_pair(o_l1, l_l1, o_l2, l_l2)
    return (torch.cat([o_e.float(), o_l], dim=1),
            torch.cat([l_e, l_l], dim=2))


def _zz_step_bwd(blk_bwd, q, k_cur, v_cur, out, lse, do, rel, scale):
    """One zigzag step backward -> (dq, dk, dv) float32 at full local
    shapes, against the MERGED out and lse (each half against its own
    half of them)."""
    b, s, h, d = q.shape
    half = s // 2
    kvh = k_cur.shape[2]
    q_e, q_l = _halves(q)
    k_e, k_l = _halves(k_cur)
    v_e, v_l = _halves(v_cur)
    o_e, o_l = _halves(out)
    do_e, do_l = _halves(do)
    lse_e, lse_l = _halves(lse, dim=2)
    zq = torch.zeros((b, half, h, d), dtype=torch.float32, device=q.device)
    zkv = torch.zeros((b, half, kvh, d), dtype=torch.float32,
                      device=q.device)
    if rel < 0:
        dq, dk_e, dv_e = blk_bwd(q, k_e, v_e, out, lse, do, False, scale)
        return (dq.float(), torch.cat([dk_e.float(), zkv], dim=1),
                torch.cat([dv_e.float(), zkv], dim=1))
    if rel > 0:
        dq_l, dk, dv = blk_bwd(q_l, k_cur, v_cur, o_l, lse_l, do_l, False,
                               scale)
        return torch.cat([zq, dq_l.float()], dim=1), dk.float(), dv.float()
    dq_e, dk1, dv1 = blk_bwd(q_e, k_e, v_e, o_e, lse_e, do_e, True, scale)
    dq_l1, dk2, dv2 = blk_bwd(q_l, k_e, v_e, o_l, lse_l, do_l, False, scale)
    dq_l2, dk3, dv3 = blk_bwd(q_l, k_l, v_l, o_l, lse_l, do_l, True, scale)
    dq = torch.cat([dq_e.float(), dq_l1.float() + dq_l2.float()], dim=1)
    dk = torch.cat([dk1.float() + dk2.float(), dk3.float()], dim=1)
    dv = torch.cat([dv1.float() + dv2.float(), dv3.float()], dim=1)
    return dq, dk, dv


def _hop(xs, devices):
    """ppermute r -> r + 1: rank r receives rank r - 1's tensor."""
    n = len(xs)
    return [xs[(r - 1) % n].to(devices[r]) for r in range(n)]


def _ring_fwd(qs, ks, vs, causal, scale, blk_fwd, zigzag):
    n = len(qs)
    devices = [q.device for q in qs]
    outs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qs]
    lses = [torch.full((q.shape[0], q.shape[2], q.shape[1]), _NEG_INF,
                       dtype=torch.float32, device=q.device) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n):
        for my in range(n):
            src = (my - t) % n          # the chunk rank `my` holds now
            if causal and zigzag:
                o_blk, l_blk = _zz_step_fwd(
                    blk_fwd, qs[my], k_cur[my], v_cur[my],
                    (src > my) - (src < my), scale)
            elif causal and src > my:
                continue                # fully masked: skipped
            else:
                o_blk, l_blk = blk_fwd(qs[my], k_cur[my], v_cur[my],
                                       causal and t == 0, scale)
            outs[my], lses[my] = _merge_pair(outs[my], lses[my], o_blk,
                                             l_blk)
        if t < n - 1:
            k_cur, v_cur = _hop(k_cur, devices), _hop(v_cur, devices)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_bwd(qs, ks, vs, outs, lses, dos, causal, scale, blk_bwd, zigzag):
    n = len(qs)
    devices = [q.device for q in qs]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dk_cur = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
    dv_cur = [torch.zeros_like(dk) for dk in dk_cur]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            if causal and zigzag:
                dq_b, dk_b, dv_b = _zz_step_bwd(
                    blk_bwd, qs[my], k_cur[my], v_cur[my], outs[my],
                    lses[my], dos[my], (src > my) - (src < my), scale)
            elif causal and src > my:
                continue
            else:
                dq_b, dk_b, dv_b = blk_bwd(
                    qs[my], k_cur[my], v_cur[my], outs[my], lses[my],
                    dos[my], causal and t == 0, scale)
            dqs[my] = dqs[my] + dq_b.float()
            dk_cur[my] = dk_cur[my] + dk_b.float()
            dv_cur[my] = dv_cur[my] + dv_b.float()
        if t < n - 1:
            k_cur, v_cur = _hop(k_cur, devices), _hop(v_cur, devices)
        # the accumulators travel with their chunk: home after n hops
        dk_cur, dv_cur = _hop(dk_cur, devices), _hop(dv_cur, devices)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for dk, k in zip(dk_cur, ks)],
            [dv.to(v.dtype) for dv, v in zip(dv_cur, vs)])


class _RingCore(torch.autograd.Function):
    """The ring as one differentiable op over every rank's chunks
    (``_ring_attention_core``'s custom VJP). Inputs are the n q chunks,
    then the n k and n v chunks; outputs the n out chunks. Forward saves
    JAX's residuals (q, k, v, out, lse) of every rank through
    ``save_for_backward``, so checkpointing and saved-tensor hooks see
    each of them."""

    @staticmethod
    def forward(ctx, n, causal, scale, blocks, zigzag, *chunks):
        qs, ks, vs = chunks[:n], chunks[n:2 * n], chunks[2 * n:]
        outs, lses = _ring_fwd(qs, ks, vs, causal, scale, blocks[0], zigzag)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.cfg = (n, causal, scale, blocks[1], zigzag)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n, causal, scale, blk_bwd, zigzag = ctx.cfg
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n]
                                  for i in range(5))
        dqs, dks, dvs = _ring_bwd(qs, ks, vs, outs, lses,
                                  [d.contiguous() for d in douts], causal,
                                  scale, blk_bwd, zigzag)
        return (None,) * 5 + tuple(dqs) + tuple(dks) + tuple(dvs)


def ring_attention_local(q: Sequence[torch.Tensor],
                         k: Sequence[torch.Tensor],
                         v: Sequence[torch.Tensor], causal: bool = True,
                         scale: Optional[float] = None,
                         use_pallas: Optional[bool] = None,
                         zigzag: bool = False) -> List[torch.Tensor]:
    """Ring attention over per-rank chunks: q[r], k[r], v[r]
    [b, s_local, h, d] on rank r's device (kv heads may be fewer: GQA).

    With zigzag=False the global sequence is the concatenation of the
    chunks in rank order; with zigzag=True (causal only) rank r holds
    the block pair (r, 2n-1-r) of the 2n-block split (see
    ``zigzag_indices``). Differentiable. Returns the n output chunks,
    each on its rank's device."""
    n = len(q)
    if not (len(k) == len(v) == n and n > 0):
        raise ValueError("ring_attention_local: one q, k and v chunk per "
                         "rank")
    if scale is None:
        scale = 1.0 / math.sqrt(q[0].shape[-1])
    if zigzag:
        if not causal:
            raise ValueError("zigzag placement only helps causal "
                             "attention; pass zigzag=False")
        if q[0].shape[1] % 2:
            raise ValueError("zigzag needs an even local sequence "
                             f"length, got {q[0].shape[1]}")
    blocks = _blocks(q, use_pallas)
    return list(_RingCore.apply(n, bool(causal), float(scale), blocks,
                                bool(zigzag), *q, *k, *v))


def ring_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                   scale: Optional[float] = None,
                   use_pallas: Optional[bool] = None,
                   zigzag: Optional[bool] = None):
    """Whole-tensor entry: q/k/v [b, S, h, d] -> out [b, S, h, d] on q's
    device. The sequence is split over the mesh's ``axis`` (each shard
    placed on its rank's device) and the output gathered back.

    zigzag (default: on for causal when S divides into 2n blocks)
    balances causal work by computing in the zigzag order; inputs and
    output keep the natural order (the permutation is applied and
    inverted here)."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    seq = q.shape[1]
    if zigzag is None:
        zigzag = bool(causal) and n > 1 and seq % (2 * n) == 0
    if seq % n:
        raise ValueError(f"ring_attention: sequence {seq} does not split "
                         f"over {n} ranks of {axis!r}")
    if zigzag:
        order = torch.as_tensor(zigzag_indices(seq, n), dtype=torch.long,
                                device=q.device)
        q, k, v = (x.index_select(1, order) for x in (q, k, v))
    sl = seq // n

    def shard(x):
        return [x[:, r * sl:(r + 1) * sl].to(devices[r]) for r in range(n)]

    outs = ring_attention_local(shard(q), shard(k), shard(v), causal,
                                scale, use_pallas, zigzag)
    out = torch.cat([o.to(q.device) for o in outs], dim=1)
    if zigzag:
        inv = torch.as_tensor(inverse_zigzag_indices(seq, n),
                              dtype=torch.long, device=q.device)
        out = out.index_select(1, inv)
    return out
