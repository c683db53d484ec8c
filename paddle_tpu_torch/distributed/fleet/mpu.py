"""Tensor-parallel (Megatron) layers over the fleet mesh's ``mp`` axis.
Counterpart: ``paddle_tpu/distributed/fleet/mpu.py``
(``ColumnParallelLinear`` :76, ``RowParallelLinear`` :111,
``VocabParallelEmbedding`` :148, ``ParallelCrossEntropy`` :172).

JAX annotates each parameter with a ``NamedSharding`` over mp and lets
GSPMD insert the collectives. The port is single controller, as its
ring and serving's tp are: a layer holds one shard of each sharded
parameter per mp rank, on that rank's device, cut along JAX's spec dim
(a column layer's weight on dim 1 and bias on dim 0, a row layer's
weight on dim 0 with its bias replicated, the embedding on dim 0). The
full weight is drawn from the generator first and then cut, so one seed
gives the same logical weights at every mp degree; no full copy is
kept. A shard is registered as ``<name>_mp<rank>`` (``weight_mp0``,
``weight_mp1``, ...); with no mesh, or mp 1, the layer holds the plain
parameter under its own name.

Compute runs per rank and meets in ``collective.all_reduce`` (partials
summed in float32) or a concatenation; autograd runs through the
``.to(device)`` copies, sums and cats, so no custom backward is needed.
``forward`` takes and returns logical tensors, as JAX's does;
``shard_forward`` keeps the per-rank list between a column layer and
its row layer, so that the models run attention and the MLP's gate on
each rank's own heads and columns.

Logical parameters: ``LogicalParameters`` (a mixin of the layers and of
the models that hold them) makes ``named_parameters()`` and
``parameters()`` yield, for each sharded parameter, a fresh
``nn.Parameter`` holding the joined value under JAX's name and full
shape, its ``.grad`` the joined shard grads, and ``_mp_shards`` /
``_mp_cut`` naming the shards and the rule. The optimizer steps those
shards in place (``optimizer.expand_shards``), and ``state_dict`` /
``load_state_dict`` join and split at the same boundary (and so
``load_numpy_state``, which loads through ``load_state_dict``).

Such a view is a read-only copy: writing into it, or setting its
``requires_grad``, changes nothing the model holds. Code that walks
``parameters()`` to change the model in place (freezing, an init, a
``torch.optim`` optimizer) takes ``shard_parameters()``, the registered
tensors, instead; the module's own ``requires_grad_`` and ``zero_grad``
act on the shards.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ...device import resolve_device
from ...nn import functional as F
from ...nn import initializer as I
from ..collective import all_reduce

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "LogicalParameters", "mp_devices"]


def mp_devices() -> Optional[List[torch.device]]:
    """The fleet mesh's mp ranks' devices, or None without a fleet mesh
    or at mp 1 (JAX's ``_mp_active()`` false)."""
    from . import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() <= 1:
        return None
    return hcg.mesh.axis_devices("mp")


class _Cut:
    """How a logical parameter (or activation) is cut into n shards along
    ``dim``: the dim read as [groups, n, chunk], shard r taking
    [:, r, :]. ``groups`` 1 is the contiguous cut; GPT's fused q/k/v
    takes groups 3, so that rank r holds the q, k and v columns of its
    own heads."""

    def __init__(self, dim: int, n: int, groups: int = 1):
        self.dim, self.n, self.groups = dim, n, groups

    def check(self, size: int, what: str):
        if size % (self.n * self.groups):
            raise ValueError(
                f"{what}: dim {self.dim} of size {size} does not divide "
                f"into {self.n} mp shards"
                + (f" of {self.groups} groups" if self.groups > 1 else ""))

    def split(self, full: torch.Tensor) -> List[torch.Tensor]:
        d = self.dim % full.dim()
        v = full.unflatten(d, (self.groups, self.n, -1))
        return [v.select(d + 1, r).flatten(d, d + 1) for r in range(self.n)]

    def join(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        dev = shards[0].device
        parts = [s.to(dev) for s in shards]
        d = self.dim % parts[0].dim()
        if self.groups == 1:
            return torch.cat(parts, d)
        parts = [p.unflatten(d, (self.groups, -1)) for p in parts]
        return torch.stack(parts, d + 1).flatten(d, d + 2)


class LogicalParameters:
    """Mixin for a module that holds mp layers: ``named_parameters``
    (and so ``parameters``) show JAX's logical parameters; the shards
    stay reachable through ``shard_parameters``."""

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        mods = self.named_modules(prefix=prefix,
                                  remove_duplicate=remove_duplicate) \
            if recurse else [(prefix, self)]
        seen = set()
        for mname, m in mods:
            items = m._logical_items() if isinstance(m, _MPLayer) \
                else m._parameters.items()
            for n, p in items:
                if p is None:
                    continue
                if not hasattr(p, "_mp_shards"):  # a view is always new
                    if remove_duplicate and id(p) in seen:
                        continue
                    seen.add(id(p))
                yield (f"{mname}.{n}" if mname else n), p

    def shard_parameters(self):
        """The registered tensors the optimizer steps: every parameter,
        each shard of a sharded one on its own."""
        return (p for _, p in nn.Module.named_parameters(self))

    def zero_grad(self, set_to_none: bool = True):
        for p in self.shard_parameters():
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def requires_grad_(self, requires_grad: bool = True):
        for p in self.shard_parameters():
            p.requires_grad_(requires_grad)
        return self


class _MPLayer(LogicalParameters, nn.Module):
    """Holds each sharded parameter as its shards; ``self.<name>`` reads
    the logical (joined) tensor, differentiable into the shards."""

    def __init__(self, device):
        super().__init__()
        self._home = resolve_device(device)
        self._devices = mp_devices()
        self._cuts = {}         # logical name -> _Cut, sharded ones only
        self._order: List[str] = []

    @property
    def mp_degree(self) -> int:
        return 1 if self._devices is None else len(self._devices)

    def _add(self, name: str, full: Optional[torch.Tensor],
             cut_dim: Optional[int] = None, groups: int = 1):
        """Register ``full`` as ``name``: cut over the mp ranks along
        ``cut_dim`` (None: replicated, kept on the layer's device)."""
        self._order.append(name)
        if full is None or cut_dim is None or self._devices is None:
            self.register_parameter(
                name, None if full is None else nn.Parameter(full))
            return
        cut = _Cut(cut_dim, self.mp_degree, groups)
        cut.check(full.shape[cut_dim], f"{type(self).__name__}.{name}")
        self._cuts[name] = cut
        for r, (piece, dev) in enumerate(zip(cut.split(full),
                                             self._devices)):
            self.register_parameter(
                f"{name}_mp{r}",
                nn.Parameter(piece.to(dev, copy=True).contiguous()))

    def shards(self, name: str) -> List[nn.Parameter]:
        """The parameter's per-rank tensors ([the parameter] when it is
        not sharded)."""
        if name not in self._cuts:
            return [self._parameters[name]]
        return [self._parameters[f"{name}_mp{r}"]
                for r in range(self.mp_degree)]

    def _has(self, name: str) -> bool:
        return name in self._cuts or self._parameters.get(name) is not None

    def __getattr__(self, name):
        cuts = self.__dict__.get("_cuts")
        if cuts is not None and name in cuts:
            return cuts[name].join(self.shards(name))
        return super().__getattr__(name)

    def _logical_items(self):
        for name in self._order:
            if name not in self._cuts:
                yield name, self._parameters[name]
                continue
            shards, cut = self.shards(name), self._cuts[name]
            with torch.no_grad():
                view = nn.Parameter(cut.join([s.detach() for s in shards]),
                                    requires_grad=shards[0].requires_grad)
                grads = [s.grad for s in shards]
                if all(g is not None for g in grads):
                    view.grad = cut.join(grads)
            view._mp_shards, view._mp_cut = shards, cut
            yield name, view

    # state_dict / load_state_dict at the logical boundary
    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, p in self._logical_items():
            if p is not None:
                destination[prefix + name] = p if keep_vars else p.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        for name in self._order:
            key = prefix + name
            if self._parameters.get(name, 0) is None:
                continue
            if key not in state_dict:
                missing_keys.append(key)
                continue
            full = state_dict[key]
            size = tuple(self._logical_shape(name))
            if tuple(full.shape) != size:
                error_msgs.append(f"size mismatch for {key}: "
                                  f"{tuple(full.shape)} vs {size}")
                continue
            with torch.no_grad():
                pieces = self._cuts[name].split(full) \
                    if name in self._cuts else [full]
                for s, piece in zip(self.shards(name), pieces):
                    s.copy_(piece)
        if strict:
            known = {prefix + n for n in self._order}
            unexpected_keys.extend(
                k for k in state_dict if k.startswith(prefix)
                and "." not in k[len(prefix):] and k not in known)

    def _logical_shape(self, name):
        shards = self.shards(name)
        if name not in self._cuts:
            return shards[0].shape
        shape = list(shards[0].shape)
        shape[self._cuts[name].dim] *= len(shards)
        return shape

    def _bias_or_none(self, has_bias, bias_attr, size, generator):
        """nn.Linear's convention: ``bias_attr=False`` (or ``has_bias``
        False) makes no bias; the bias is Constant 0."""
        if bias_attr not in (None, False):
            raise NotImplementedError(
                "mp layers: only bias_attr=None or False is ported")
        if not has_bias or bias_attr is False:
            return None
        return I.Constant(0.0)((size,), torch.float32, generator,
                               self._home)


def _init(weight_attr, default):
    """``weight_attr``: None (JAX's default initializer) or one of the
    port's ``nn.initializer`` objects."""
    if weight_attr is None:
        return default
    if isinstance(weight_attr, I.Initializer):
        return weight_attr
    raise NotImplementedError(
        "mp layers: weight_attr takes an nn.initializer object (ParamAttr "
        "is not ported)")


class ColumnParallelLinear(_MPLayer):
    """Y = X @ W with W's columns (and the bias) cut over mp. ``forward``
    returns the logical output whatever ``gather_output`` says (JAX's is
    one array whatever its sharding); ``shard_forward`` gives one output
    per rank. ``qkv_groups`` 3 cuts a fused [q | k | v] projection so
    that each rank holds its own heads' columns of all three."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, bias_attr=None, generator=None,
                 device=None, qkv_groups: int = 1):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self._add("weight", _init(weight_attr, I.XavierUniform())(
            (in_features, out_features), torch.float32, generator,
            self._home), 1, qkv_groups)
        self._add("bias", self._bias_or_none(has_bias, bias_attr,
                                             out_features, generator),
                  0, qkv_groups)

    def shard_forward(self, x) -> List[torch.Tensor]:
        """x (logical, replicated) -> [x @ W_r + b_r for each rank r],
        each on its rank's device."""
        ws = self.shards("weight")
        bs = self.shards("bias") if self._has("bias") else [None] * len(ws)
        return [F.linear(x.to(w.device), w, b) for w, b in zip(ws, bs)]

    def forward(self, x):
        outs = self.shard_forward(x)
        if len(outs) == 1:
            return outs[0]
        cut = self._cuts["weight"]
        return _Cut(-1, cut.n, cut.groups).join(outs).to(x.device)


class RowParallelLinear(_MPLayer):
    """Y = X @ W with W's rows cut over mp: each rank's partial product,
    summed by ``collective.all_reduce`` in float32, then the replicated
    bias added once. ``forward`` takes the logical input (cut on its
    last dim, as GSPMD slices it, whether or not ``input_is_parallel``);
    ``shard_forward`` takes the ranks' inputs."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 bias_attr=None, generator=None, device=None):
        super().__init__(device)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self._add("weight", _init(weight_attr, I.XavierUniform())(
            (in_features, out_features), torch.float32, generator,
            self._home), 0)
        self._add("bias", self._bias_or_none(has_bias, bias_attr,
                                             out_features, generator))

    def shard_forward(self, xs: Sequence[torch.Tensor], like=None):
        """xs: one input a rank -> the summed output on ``like``'s device
        (default: rank 0's)."""
        parts = [F.linear(x.to(w.device), w)
                 for x, w in zip(xs, self.shards("weight"))]
        out = all_reduce(parts)[0]
        if like is not None:
            out = out.to(like.device)
        if self.bias is not None:
            out = out + self.bias.to(out.device, out.dtype)
        return out

    def forward(self, x):
        if self.mp_degree == 1:
            return F.linear(x, self.weight, self.bias)
        return self.shard_forward(_Cut(-1, self.mp_degree).split(x),
                                  like=x)


class VocabParallelEmbedding(_MPLayer):
    """The [vocab, dim] table cut over mp on dim 0: each rank looks up
    the ids in its range (others read 0) and the ranks' rows are summed.
    The default initializer is JAX's Normal(0, 0.02); a model passes its
    plain embedding's so that its weights do not depend on mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, generator=None, device=None):
        super().__init__(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._add("weight", _init(weight_attr, I.Normal(0.0, 0.02))(
            (num_embeddings, embedding_dim), torch.float32, generator,
            self._home), 0)

    def shard_forward(self, ids) -> List[torch.Tensor]:
        """Each rank's rows for ``ids``, zero where an id is another
        rank's."""
        outs = []
        for w in self.shards("weight"):
            rows = w.shape[0]
            lo = len(outs) * rows
            local = ids.to(w.device) - lo
            hit = (local >= 0) & (local < rows)
            emb = F.embedding(local.clamp(0, rows - 1), w)
            outs.append(torch.where(hit[..., None], emb,
                                    torch.zeros((), dtype=emb.dtype,
                                                device=emb.device)))
        return outs

    def forward(self, ids):
        outs = self.shard_forward(ids)
        if len(outs) == 1:
            return outs[0]
        return all_reduce(outs)[0].to(ids.device)

    def head(self, h) -> torch.Tensor:
        """A tied head, ``h @ W.T`` in the promoted dtype, as the ranks'
        vocab columns joined (JAX's matmul over the logical table)."""
        outs = []
        for w in self.shards("weight"):
            dt = torch.promote_types(h.dtype, w.dtype)
            outs.append(torch.matmul(h.to(w.device, dt), w.t().to(dt)))
        return outs[0] if len(outs) == 1 else \
            _Cut(-1, len(outs)).join(outs).to(h.device)


class ParallelCrossEntropy(nn.Module):
    """JAX's: the plain cross entropy over the logical logits,
    ``reduction="none"``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)
