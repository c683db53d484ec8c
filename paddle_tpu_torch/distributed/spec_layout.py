"""The canonical tensor-parallel placement of the serving weights and the
paged KV pool: ONE table that every placement reads.

Counterpart: ``paddle_tpu/distributed/spec_layout.py`` (the table
:73-120, ``SpecLayout`` :126, ``fleet_device_slices`` :239). JAX turns a
spec into a ``NamedSharding`` over a mesh and lets ``device_put`` cut
the shards; the port's tp program is single controller too, but holds
its shards itself: ``SpecLayout.shard_tree`` turns a full weight tree
into one tree per shard, each leaf cut along its spec's ``"tp"`` dim
and placed, contiguous, on the shard's device.

A spec is a tuple over the TRAILING dims of a parameter, ``"tp"`` on
the dim that splits and ``None`` elsewhere, as JAX's ``PartitionSpec``
literals read:
- column-parallel (out dim split): wq / wk / wv, wg / wu, head (and the
  GPT family's wi and its column biases);
- row-parallel (in dim split): wo, wd (GPT: wf); the block's one
  all-reduce follows them;
- replicated: embed, the norms, pos, the row-parallel output biases
  and the adapter plane ``lora_pool``;
- the pool planes cache_k / cache_v [num_blocks, kv_heads, block_size,
  head_dim] and the int8 pool's scales [num_blocks, kv_heads,
  block_size] split their kv-head dim, so a shard writes exactly the
  heads it computed.

A quantized weight (``QWeight``) cuts its packed values like the weight
and its per-output-channel scale with the out dim (split for a column
weight, whole for a row weight). An int4 shard is repacked as
``int4_halves`` over the shard's OWN in-dim (``shard_qweight``), from
the integer values and scales of the whole matrix (JAX's
``_quantize_w4``), so it dequantizes to exactly its rows and columns of
the whole weight and its products of few rows take the halves GEMV
kernel.

The data axis of the dp x tp fleet never appears in the table: replicas
hold whole copies. ``fleet_device_slices`` gives each replica its row of
the [dp, tp] device grid; a device may repeat (``["cuda:0"] * 4`` holds
two tp-2 replicas on one card), as in ``ProcessMesh``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.qweight import QWeight, int4_values, pack_int4_halves

__all__ = ["SpecLayout", "CANONICAL_SPECS", "default_devices", "cut",
           "shard_qweight"]

Spec = Tuple[Optional[str], ...]

# parameter name -> spec over the tp axis, the JAX table key for key
CANONICAL_SPECS: Dict[str, Spec] = {
    "wq": (None, "tp"),
    "wk": (None, "tp"),
    "wv": (None, "tp"),
    "wo": ("tp", None),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    "bo": (None,),
    "wg": (None, "tp"),
    "wu": (None, "tp"),
    "wd": ("tp", None),
    "wi": (None, "tp"),
    "bi": ("tp",),
    "wf": ("tp", None),
    "bf": (None,),
    "embed": (None, None),
    "pos": (None, None),
    "norm": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "ln1_w": (None,),
    "ln1_b": (None,),
    "ln2_w": (None,),
    "ln2_b": (None,),
    "lnf_w": (None,),
    "lnf_b": (None,),
    "head": (None, "tp"),
    "cache_k": (None, "tp", None, None),
    "cache_v": (None, "tp", None, None),
    "cache_k_scale": (None, "tp", None),
    "cache_v_scale": (None, "tp", None),
    "lora_pool": (None, None),
}


def default_devices() -> List[torch.device]:
    """The visible cards, in order; none raises."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "tensor-parallel serving places its shards on the visible "
            "CUDA devices and there are none; pass devices=[...] (a "
            "device may repeat, e.g. ['cpu'] * 2)")
    return [torch.device("cuda", i) for i in range(n)]


def cut(t: torch.Tensor, dim: int, shard: int, n: int,
        even: bool = False) -> torch.Tensor:
    """Shard ``shard`` of ``n`` equal pieces of t along ``dim`` (of an
    even size with ``even``: an int4 row shard's packed pairs)."""
    size = t.shape[dim]
    if size % n or (even and (size // n) % 2):
        raise ValueError(f"dim {dim} of size {size} does not divide into "
                         f"{n} shards{' of even size' if even else ''}")
    step = size // n
    return t.narrow(dim, shard * step, step)


def shard_qweight(w: QWeight, split, shard: int, n: int,
                  device) -> QWeight:
    """Shard ``shard`` of ``n`` of a quantized weight on ``device``:
    ``split`` "out" cuts columns and scales, "in" cuts in-rows (the scale
    stays whole), None keeps the whole weight. An int4 row shard is
    repacked as halves over its own in-dim; every tensor is
    contiguous."""
    w.check()
    q, scale, kind = w.q, w.scale, w.kind
    if split == "out":
        q, scale = cut(q, 1, shard, n), cut(scale, 0, shard, n)
    elif split == "in" and kind == "int8":
        q = cut(q, 0, shard, n)
    elif split == "in":
        q = pack_int4_halves(cut(int4_values(w), 0, shard, n,
                                 even=True).contiguous())
    elif split is not None:
        raise ValueError(f"split must be None, 'in' or 'out', got {split!r}")
    return QWeight(q.to(device).contiguous(), scale.to(device).contiguous(),
                   kind)


class SpecLayout:
    """Placement by the table (JAX's ``SpecLayout`` over its default axis
    names)."""

    def spec(self, name: str, strict: bool = False) -> Spec:
        base = CANONICAL_SPECS.get(name)
        if base is None:
            if strict:
                raise KeyError(
                    f"weight key {name!r} has no canonical spec in "
                    f"CANONICAL_SPECS (paddle_tpu_torch/distributed/"
                    f"spec_layout.py): a silently replicated unknown key "
                    f"is how spec drift starts; add it to the table")
            return ()
        return base

    def split_dim(self, name: str, ndim: int,
                  strict: bool = False) -> Optional[int]:
        """The dim of an ``ndim``-d leaf named ``name`` that splits over
        tp (the spec reads trailing dims), or None."""
        s = self.spec(name, strict=strict)
        for i, e in enumerate(s):
            if e == "tp":
                return ndim - len(s) + i
        return None

    def shard_leaf(self, name: str, leaf, shard: int, n: int, device,
                   strict: bool = False):
        """Shard ``shard`` of ``n`` of one leaf, contiguous on
        ``device``."""
        if isinstance(leaf, QWeight):
            self.spec(name, strict=strict)
            dim = self.split_dim(name, 2)
            return shard_qweight(leaf, {None: None, 0: "in", 1: "out"}[dim],
                                 shard, n, device)
        dim = self.split_dim(name, leaf.dim(), strict=strict)
        part = leaf if dim is None else cut(leaf, dim, shard, n)
        return part.to(device).contiguous()

    def shard_tree(self, weights: dict, devices: Sequence,
                   strict: bool = False) -> List[dict]:
        """One tree per device of ``devices``: every leaf of ``weights``
        (the per-projection serving tree; ``layers`` a list of per-layer
        dicts) cut by its name's spec and placed on the shard's device.
        With ``strict`` a key missing from the table raises."""
        n = len(devices)
        out = []
        for s, dev in enumerate(devices):
            dev = torch.device(dev)
            tree = {}
            for k, v in weights.items():
                if k == "layers":
                    tree[k] = [{kk: self.shard_leaf(kk, vv, s, n, dev,
                                                    strict)
                                for kk, vv in layer.items()} for layer in v]
                else:
                    tree[k] = self.shard_leaf(k, v, s, n, dev, strict)
            out.append(tree)
        return out

    # -- dp x tp fleet placement ------------------------------------------------
    def fleet_device_slices(self, dp: int, tp: int,
                            devices: Optional[Sequence] = None
                            ) -> List[list]:
        """Replica r's row of the [dp, tp] grid over the first dp * tp
        of ``devices`` (None: the visible cards): what the Router passes
        to each ``ServingEngine(devices=...)``."""
        dp, tp = int(dp), int(tp)
        if dp < 1 or tp < 1:
            raise ValueError(f"dp and tp must be >= 1, got dp={dp} "
                             f"tp={tp}")
        devs = ([torch.device(d) for d in devices] if devices is not None
                else default_devices())
        if len(devs) < dp * tp:
            raise ValueError(f"dp={dp} x tp={tp} needs {dp * tp} devices, "
                             f"found {len(devs)}")
        return [devs[r * tp:(r + 1) * tp] for r in range(dp)]
