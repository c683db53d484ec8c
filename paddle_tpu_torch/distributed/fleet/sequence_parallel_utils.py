"""Megatron sequence parallelism over the fleet mesh's ``mp`` axis.
Counterpart: ``paddle_tpu/distributed/fleet/sequence_parallel_utils.py``
(``ScatterOp`` / ``GatherOp`` and their aliases, ``mark_as_sequence_
parallel_parameter`` :51-59, ``ColumnSequenceParallelLinear``,
``RowSequenceParallelLinear``).

JAX's ``ScatterOp`` / ``GatherOp`` are sharding constraints on the
sequence dim: the array they return holds the same values, laid out
otherwise. So do the port's: they take and return logical tensors (and
check that the sequence divides over mp). The physical cut is
``scatter_sequence`` (one chunk of the sequence a rank, on its device)
and ``gather_sequence``; the two linears' ``shard_forward`` work on those
lists: the column layer all-gathers the chunks on every rank before its
product, and the row layer sums its ranks' partial products chunk by
chunk in float32, so rank j holds chunk j of the sum (a reduce-scatter),
and adds its bias there. Their ``forward`` takes and returns logical
tensors, as JAX's does.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .mpu import ColumnParallelLinear, RowParallelLinear, _Cut, mp_devices

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter", "scatter_sequence",
           "gather_sequence"]


def _check_seq(x, seq_dim, n):
    if x.shape[seq_dim] % n:
        raise ValueError(f"sequence dim {seq_dim} of size "
                         f"{x.shape[seq_dim]} does not divide into {n} mp "
                         f"ranks")


def ScatterOp(x, seq_dim=1):
    """The sequence dim marked split over mp (values unchanged)."""
    devs = mp_devices()
    if devs is not None:
        _check_seq(x, seq_dim, len(devs))
    return x


def GatherOp(x, seq_dim=1):
    """The sequence dim marked whole again (values unchanged)."""
    return x


AllGatherOp = GatherOp
ReduceScatterOp = ScatterOp


def scatter_sequence(x, devices: Sequence[torch.device],
                     seq_dim=1) -> List[torch.Tensor]:
    """x cut on ``seq_dim`` into one contiguous chunk a rank, each on its
    rank's device."""
    _check_seq(x, seq_dim, len(devices))
    return [c.to(d) for c, d in zip(_Cut(seq_dim, len(devices)).split(x),
                                    devices)]


def gather_sequence(xs: Sequence[torch.Tensor], seq_dim=1, device=None):
    """The chunks joined on ``seq_dim`` (on ``device``, default the
    first chunk's)."""
    out = _Cut(seq_dim, len(xs)).join(xs)
    return out if device is None else out.to(device)


def mark_as_sequence_parallel_parameter(param):
    """Mark a parameter whose grad sums over the sequence ranks (a norm's
    gain). A plain tensor is refused, as JAX refuses it."""
    if not isinstance(param, nn.Parameter):
        raise TypeError(
            "mark_as_sequence_parallel_parameter expects a Parameter")
    param.sequence_parallel = True
    return param


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Input split on the sequence; all-gathered before the
    column-parallel product; the output feature-sharded."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, name=None,
                 generator=None, device=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, gather_output=gather_output,
                         generator=generator, device=device)

    def shard_forward(self, x) -> List[torch.Tensor]:
        """x: the logical input, or one sequence chunk a rank."""
        if isinstance(x, (list, tuple)):
            x = gather_sequence(x)
        return super().shard_forward(x)


class RowSequenceParallelLinear(RowParallelLinear):
    """Input feature-sharded; the ranks' partial products
    reduce-scattered onto the sequence dim, the bias added to each
    chunk."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, name=None,
                 generator=None, device=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias,
                         input_is_parallel=input_is_parallel,
                         generator=generator, device=device)

    def shard_forward(self, xs: Sequence[torch.Tensor], like=None,
                      seq_dim=1) -> List[torch.Tensor]:
        """xs: one feature-sharded input a rank -> one sequence chunk of
        the sum a rank, on its device."""
        ws = self.shards("weight")
        n = len(ws)
        parts = [torch.matmul(x.to(w.device), w.to(x.dtype))
                 for x, w in zip(xs, ws)]
        _check_seq(parts[0], seq_dim, n)
        cuts = [_Cut(seq_dim, n).split(p) for p in parts]
        out = []
        for j, w in enumerate(ws):
            acc = cuts[0][j].to(w.device, torch.float32)
            for r in range(1, n):
                acc = acc + cuts[r][j].to(w.device, torch.float32)
            acc = acc.to(parts[0].dtype)
            if self.bias is not None:
                acc = acc + self.bias.to(acc.device, acc.dtype)
            out.append(acc)
        return out

    def forward(self, x):
        if self.mp_degree == 1:
            return super().forward(x)
        chunks = self.shard_forward(_Cut(-1, self.mp_degree).split(x))
        return gather_sequence(chunks, device=x.device)
