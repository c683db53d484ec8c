"""``MoELayer`` and its gates. Counterpart: ``paddle_tpu/nn/layer/moe.py``
(``GShardGate`` / ``SwitchGate`` :22-32, ``MoELayer`` :35-163).

A token-routed expert FFN: ``gate_weight`` [D, E] routes each token,
the experts ``act(x @ w1[e]) @ w2[e]`` are stacked as ``w1`` [E, D, H]
and ``w2`` [E, H, D], all float32 and drawn XavierUniform with JAX's
fans (for [E, D, H]: fan_in D·H, fan_out E·H). ``dispatch_mode``
"dense" runs the GShard capacity-slotted FFN
(``ops.moe.moe_dispatch_combine``), "ragged" the sort-based dropless one
(``ops.moe.moe_ragged_forward``). ``gate`` is "gshard" (top_k as given),
"switch" (top-1) or a gate object (``SwitchGate``: top-1,
``GShardGate(top_k)``).

``aux_loss`` is the load-balancing loss of the last forward (a tensor
with gradient, for the train loss). ``routing_stats`` holds the last
forward's tokens_per_expert, assigned_per_expert, dropped_fraction and
capacity (0 for ragged), detached, after every forward: JAX gives None
inside a compiled program, and the port has none.

Expert parallelism is not ported: a fleet mesh whose ``ep`` (or
``mp``) axis is larger than 1 raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from ...ops import moe as moe_ops
from .. import initializer as I

__all__ = ["MoELayer", "SwitchGate", "GShardGate"]

_ACTIVATIONS = ("gelu", "relu", "silu")


class _GateBase:
    top_k = 2


class GShardGate(_GateBase):
    def __init__(self, top_k=2):
        self.top_k = top_k


class SwitchGate(_GateBase):
    top_k = 1


def _check_no_expert_mesh(ep_axis: str):
    """Raise when a fleet mesh would shard the experts (JAX's
    ``_annotate_ep``: the ep axis, else mp, when larger than 1)."""
    from ...distributed.fleet import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return
    mesh = hcg.mesh
    sharded = [a for a in (ep_axis, "mp") if a in mesh.dim_names
               and mesh.get_dim_size(a) > 1]
    if sharded:
        raise NotImplementedError(
            f"MoELayer under a fleet mesh with {sharded[0]!r} of size "
            f"{mesh.get_dim_size(sharded[0])}: expert parallelism (the "
            f"experts sharded over ep, or over mp without ep) is not "
            f"ported yet (ROADMAP queue 1, item 2)")


class MoELayer(nn.Module):
    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate="gshard", top_k: int = 2,
                 capacity_factor: float = 1.25, activation="gelu",
                 ep_axis: str = "ep", name=None,
                 dispatch_mode: str = "dense", generator=None, device=None):
        super().__init__()
        if dispatch_mode not in ("dense", "ragged"):
            raise ValueError(
                f"dispatch_mode must be 'dense' (GShard one-hot) or "
                f"'ragged' (sort-based dropless); got {dispatch_mode!r}")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{_ACTIVATIONS}; got {activation!r}")
        _check_no_expert_mesh(ep_axis)
        self.dispatch_mode = dispatch_mode
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        if isinstance(gate, SwitchGate) or gate == "switch":
            self.top_k = 1
        elif isinstance(gate, _GateBase):
            self.top_k = gate.top_k
        else:
            self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self._act_name = activation
        dev = resolve_device(device)

        def param(shape):
            return nn.Parameter(I.XavierUniform()(shape, torch.float32,
                                                  generator, dev))

        self.gate_weight = param((d_model, num_experts))
        self.w1 = param((num_experts, d_model, d_hidden))
        self.w2 = param((num_experts, d_hidden, d_model))
        self._aux_loss: Optional[torch.Tensor] = None
        self._last_stats: Optional[dict] = None

    def forward(self, x):
        act = {"gelu": moe_ops.gelu_tanh, "relu": torch.relu,
               "silu": torch.nn.functional.silu}[self._act_name]
        if self.dispatch_mode == "ragged":
            out, aux, stats = moe_ops.moe_ragged_forward(
                x, self.gate_weight, self.w1, self.w2, self.top_k, act)
            cap = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            out, aux, stats = moe_ops.moe_dispatch_combine(
                x, self.gate_weight, self.w1, self.w2, self.top_k,
                self.capacity_factor, act)
            cap = stats["capacity"]
        self._aux_loss = aux
        self._last_stats = {
            "tokens_per_expert": stats["tokens_per_expert"].detach(),
            "assigned_per_expert": stats["assigned_per_expert"].detach(),
            "dropped_fraction": stats["dropped_fraction"].detach(),
            "capacity": cap}
        return out

    @property
    def aux_loss(self) -> Optional[torch.Tensor]:
        """Load-balancing loss of the last forward (add to the train
        loss)."""
        return self._aux_loss

    @property
    def routing_stats(self) -> Optional[dict]:
        """tokens_per_expert, assigned_per_expert, dropped_fraction and
        capacity of the last forward (tensors); None before the first."""
        return self._last_stats

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}, "
                f"dispatch_mode={self.dispatch_mode!r}")
