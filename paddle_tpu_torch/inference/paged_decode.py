"""Paged-KV decoder for Llama-family models: the ragged serving step and
the dense per-phase programs.

Counterpart: ``paddle_tpu/inference/paged_decode.py``. The decoder holds
a dict of tensors with the same shape as the JAX ``weights`` tree —
``embed``, ``layers`` (each with ``ln1``, ``ln2``, fused ``wqkv``,
``wo``, fused ``wgu``, ``wd``), ``norm`` and ``head`` — so weights carry
across one-to-one. Matmul weights are [in, out]; a quantized one is a
``QWeight`` whose ``kind`` names its layout. Tensor parallelism (JAX's
``_TPDecoderMixin``) holds one such tree per shard: see
``PagedLlamaDecoder``.

``_ragged_logits`` is one ministep of the ragged serving engine: every
row's K/V is written to the pool (in place) before attention, so the
per-row visible length ``row_ctx`` is the whole causal mask. With a
``lora`` context (``lora_context``) each row adds its adapter's delta
at the seven target modules; ``_spec_accept`` is the speculative verify
step's acceptance and the zeroing of rejected drafts' K/V. Neither is a
kernel in the JAX package (both are jnp there), so both are PyTorch ops
here.

The dense per-phase programs serve ``ServingEngine(ragged=False)`` and
``generate()``: ``_prefill_impl`` (a bucketed, right-padded prompt
through causal flash attention), ``_prefill_prefix_impl`` (a prompt
chunk at an offset, attending the pages already written as its prefix;
with ``logits=False`` it is JAX's no-sample ``_prefill_chunk_impl``)
and ``_decode_logits`` (one token per sequence through
``paged_attention_decode``). JAX compiles each as
one program; here each is a Python function that launches its kernels
in order, and JAX's ``lax.scan`` over decode steps is a Python loop
whose sampled token stays on the device from step to step.
"""
from __future__ import annotations

import math
import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.collective import (all_gather_logits, all_reduce,
                                      int8_all_reduce)
from ..distributed.mesh import ProcessMesh
from ..distributed.spec_layout import SpecLayout, cut
from ..models.llama import LlamaConfig
from ..ops.cuda.decode_matmul import (_MAX_ROWS, decode_matmul,
                                      unpack_int4_halves)
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (PagedKVCache, _dequantize_gather,
                                   _plane_values, paged_attention_decode,
                                   pool_index,
                                   ragged_paged_attention,
                                   reshape_and_cache)
from ..ops.qweight import QWeight
from ..ops.rms_norm import rms_norm
from ..ops.rope import build_rope_cache, rotate_half

__all__ = ["PagedLlamaDecoder"]

_WEIGHT_DTYPES = (None, "int8", "int4")


def _quantize_w(w) -> QWeight:
    """Per-output-channel symmetric absmax int8 over the in dim. Bit-
    identical to the JAX ``_quantize_w``: the same float32 divisions, and
    ``torch.round`` rounds half to even as ``jnp.round`` does. The result
    is row-major whatever w's strides (a tied head is a transposed
    view)."""
    w = w.to(torch.float32).contiguous()
    scale = w.abs().amax(dim=0) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    wi = torch.clamp(torch.round(w / scale[None, :]), -127, 127) \
        .to(torch.int8)
    return QWeight(wi, scale, "int8")


def _quantize_w4_halves(w) -> QWeight:
    """int4 with HALVES packing: packed row r holds in-row r (low nibble)
    and in-row r + K/2 (high nibble). Bit-identical to the JAX
    ``_quantize_w4_halves`` (round half to even in both); row-major
    whatever w's strides."""
    w = w.to(torch.float32).contiguous()
    if w.shape[0] % 2:
        raise ValueError(f"int4 packing needs even in_features, "
                         f"got {w.shape[0]}")
    scale = w.abs().amax(dim=0) / 7.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    wi = torch.clamp(torch.round(w / scale[None, :]), -8, 7) \
        .to(torch.int8).view(torch.uint8)
    half = w.shape[0] // 2
    packed = (wi[:half] & 0x0F) | ((wi[half:] & 0x0F) << 4)
    return QWeight(packed.view(torch.int8), scale, "int4_halves")


_QUANTIZERS = {None: lambda w: w, "int8": _quantize_w,
               "int4": _quantize_w4_halves}


def _mm(x, w):
    """x @ w for a dense [in, out] weight or a QWeight. int4 calls with at
    most 32 activation rows go to the weight-streaming kernel (its plain
    version on the CPU), which raises on a CUDA operand it does not
    take; larger int4 calls split the contraction into the two nibble
    halves and leave both products to ``torch.matmul``, as the JAX
    package leaves them to XLA. int8 and dense weights are plain
    products, as in the JAX ``_mm``."""
    if isinstance(w, QWeight):
        w.check()
        if w.in_features != x.shape[-1]:
            raise ValueError(f"_mm: x in-dim {x.shape[-1]} does not match "
                             f"{w.kind} weight in-dim {w.in_features}")
        if w.kind == "int4_halves":
            lead = x.shape[:-1]
            rows = x.numel() // x.shape[-1]
            if 1 <= rows <= _MAX_ROWS:
                return decode_matmul(x.reshape(rows, x.shape[-1]),
                                     w).reshape(*lead, -1)
            lo, hi = unpack_int4_halves(w.q, x.dtype)
            half = x.shape[-1] // 2
            y = x[..., :half] @ lo + x[..., half:] @ hi
            return y * w.scale.to(x.dtype)
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


def _prefix_suffix_attention(q, k_suf, v_suf, k_pre, v_pre, n_cached,
                             scale: Optional[float] = None):
    """Causal attention of a SUFFIX prefill over a cached prefix, in
    float32 (the JAX function of the same name is einsums too, so no
    kernel belongs to it).

    The suffix's queries sit at positions ``n_cached + i``; their keys
    are the prefix K/V (gathered pool pages, flattened) then the
    suffix's own. Every prefix key at a position < n_cached is visible
    to every suffix query, and suffix against suffix is causal, which
    also hides right-padded rows from real queries.
    q / k_suf / v_suf [b, s, (kv)h, d]; k_pre / v_pre [b, kvh, P, d];
    n_cached [b] int32. Returns [b, s, nh, d] in q's dtype."""
    b, s, nh, d = q.shape
    kvh = k_suf.shape[2]
    group = nh // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    p = k_pre.shape[2]
    dev = q.device
    qg = q.reshape(b, s, kvh, group, d).to(torch.float32)
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    sp = torch.einsum("bskgd,bkpd->bskgp", qg,
                      k_pre.to(torch.float32)) * scale
    pvalid = torch.arange(p, device=dev)[None] < n_cached.long()[:, None]
    sp = torch.where(pvalid[:, None, None, None, :], sp, neg)
    ss = torch.einsum("bskgd,btkd->bskgt", qg,
                      k_suf.to(torch.float32)) * scale
    causal = torch.arange(s, device=dev)[:, None] \
        >= torch.arange(s, device=dev)[None, :]
    ss = torch.where(causal[None, :, None, None, :], ss, neg)
    probs = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
    out = torch.einsum("bskgp,bkpd->bskgd", probs[..., :p],
                       v_pre.to(torch.float32)) \
        + torch.einsum("bskgt,btkd->bskgd", probs[..., p:],
                       v_suf.to(torch.float32))
    return out.reshape(b, s, nh, d).to(q.dtype)


def _gather_prefix_pages(pool, prefix_tables):
    """A pool plane [num_blocks, kvh, bs, d] (or an int8 tuple, which
    dequantizes at the gather) and page ids [b, P] -> the rows' prefix
    K/V as one contiguous [b, kvh, P * bs, d]."""
    g = _dequantize_gather(pool, prefix_tables)    # [b, P, kvh, bs, d]
    b, p, kvh, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, kvh, p * bs, d)


def _fuse_out(ws):
    """Concatenate weights along the OUT dim (dense, or QWeights of one
    kind with matching in-dims)."""
    if isinstance(ws[0], QWeight):
        kinds = {w.kind for w in ws}
        if len(kinds) != 1:
            raise ValueError(f"cannot fuse QWeights of kinds {kinds}")
        return QWeight(torch.cat([w.q for w in ws], dim=1),
                       torch.cat([w.scale for w in ws], dim=0),
                       ws[0].kind)
    return torch.cat(ws, dim=1)


def _weight_specs(cfg):
    """(name, shape, quantized?) for every serving weight, in load
    order; [in, out] layout, head [hidden, vocab]."""
    hd = cfg.hidden_size // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    h, it = cfg.hidden_size, cfg.intermediate_size
    specs = [("embed", (cfg.vocab_size, h), False)]
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."
        specs += [(p + "ln1", (h,), False), (p + "ln2", (h,), False),
                  (p + "wq", (h, h), True), (p + "wk", (h, kv), True),
                  (p + "wv", (h, kv), True), (p + "wo", (h, h), True),
                  (p + "wg", (h, it), True), (p + "wu", (h, it), True),
                  (p + "wd", (it, h), True)]
    specs += [("norm", (h,), False), ("head", (h, cfg.vocab_size), True)]
    return specs


def _mesh_devices(mesh, mp_axis: str):
    """The devices of a ``ProcessMesh``'s tp axis, one per shard."""
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"mesh must be a paddle_tpu_torch ProcessMesh, got "
                        f"{type(mesh).__name__}")
    return [resolve_device(d) for d in mesh.axis_devices(mp_axis)]


def _load_device(device, mesh, mp_axis: str):
    """Where a decoder's whole weights are made: ``device``, or the first
    shard's device of a mesh."""
    if mesh is None:
        return resolve_device(device)
    return _mesh_devices(mesh, mp_axis)[0]


def _check_tp_flags(mesh, tp_shard_map: bool, tp_comm: str):
    """JAX's refusals of a tensor-parallel request it would drop."""
    if tp_comm not in ("fp32", "int8"):
        raise ValueError(f"tp_comm must be 'fp32' or 'int8', got "
                         f"{tp_comm!r}")
    if tp_shard_map and mesh is None:
        raise ValueError("tp_shard_map=True needs a mesh (the tp request "
                         "would otherwise be silently dropped)")
    if tp_comm != "fp32" and not tp_shard_map:
        raise ValueError("tp_comm='int8' requires the manual shard_map "
                         "path (mesh + tp_shard_map=True); on any other "
                         "path the compressed collective would be "
                         "silently dropped")


def _fuse_layers(weights):
    """The tree with q/k/v and gate/up fused along the out dim. The given
    tree is left as it was and an already-fused one passes through, so
    several decoders (the replicas of a fleet) can be built over one set
    of weights, each with a pool of its own."""
    layers = []
    for lw in weights["layers"]:
        lw = dict(lw)
        if "wq" in lw:
            lw["wqkv"] = _fuse_out([lw.pop("wq"), lw.pop("wk"),
                                    lw.pop("wv")])
            lw["wgu"] = _fuse_out([lw.pop("wg"), lw.pop("wu")])
        layers.append(lw)
    return {**weights, "layers": layers}


class _PagedDecoder:
    """What the paged decoders share: JAX's ``_TPDecoderMixin``,
    ``_SpecDecodeMixin`` and ``_LoRAMixin`` (``paddle_tpu/inference/
    paged_decode.py:269-530``) and the construction around them. The
    base places the weights (one tree per shard, cut by the canonical
    table; ``_fuse`` turns each into the tree the programs read) and
    builds the pool, and holds the tensor-parallel helpers, the adapter
    deltas, speculative acceptance, the dense decode loop and
    ``generate``. A decoder defines its programs (``_ragged_logits``,
    ``_prefill_impl``, ``_prefill_prefix_impl``, ``_decode_logits``,
    ``_head_logits``), ``lora_target_modules``, ``from_model`` and the
    weight names ``_weight_specs`` that ``from_weight_loader`` and
    ``from_config`` load (``_is_gain``: a 1-d weight that starts at
    ones)."""

    _fuse = staticmethod(lambda tree: tree)
    # the constructor's default tensor-parallel axis name
    _MP_AXIS = "mp"

    @staticmethod
    def _is_gain(name: str) -> bool:
        return True

    def __init__(self, cfg, weights: dict, num_blocks: int = 512,
                 block_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 weight_dtype: Optional[str] = None,
                 kv_quant: Optional[str] = None, device=None, mesh=None,
                 mp_axis: str = "mp", tp_shard_map: bool = False,
                 tp_comm: str = "fp32"):
        if weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be None, 'int8' or "
                             f"'int4', got {weight_dtype!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        _check_tp_flags(mesh, tp_shard_map, tp_comm)
        self.cfg = cfg
        self.mesh = mesh
        self.mp_axis = mp_axis
        self.tp_comm = tp_comm
        self._tp_manual = bool(tp_shard_map)
        if mesh is None:
            self.devices = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("pass either device= or a mesh, not both: "
                                 "the mesh places every shard")
            self.devices = _mesh_devices(mesh, mp_axis)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        # JAX's _tp: the manual path's degree, 1 on the GSPMD path
        self._tp = self.n_shards if self._tp_manual else 1
        self.block_size = block_size
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_pages = max_pages_per_seq or \
            -(-cfg.max_position_embeddings // block_size)
        self.weight_dtype = weight_dtype
        self.kv_quant = kv_quant
        if self.n_shards > 1:
            self._check_tp_divisibility(self.n_shards)
            trees = SpecLayout().shard_tree(weights, self.devices,
                                            strict=True)
        else:
            trees = [weights]
        self.weights = [self._fuse(t) for t in trees]
        dtype = self.weights[0]["embed"].dtype
        self.cache = PagedKVCache(
            num_layers=cfg.num_hidden_layers, num_blocks=num_blocks,
            block_size=block_size, kv_heads=cfg.num_key_value_heads,
            head_dim=self.head_dim, dtype=dtype, kv_quant=kv_quant,
            devices=self.devices)

    def _check_tp_divisibility(self, mp: int):
        """JAX's rule: heads, kv heads, intermediate and vocab divide by
        the degree; under int4 so do hidden/2 and intermediate/2 (a row
        shard's packed in-dim)."""
        cfg = self.cfg
        kvh = cfg.num_key_value_heads
        if (cfg.num_attention_heads % mp or kvh % mp
                or cfg.intermediate_size % mp):
            raise ValueError(
                f"TP serving needs heads ({cfg.num_attention_heads}/{kvh}) "
                f"and intermediate size ({cfg.intermediate_size}) "
                f"divisible by the '{self.mp_axis}' degree {mp}")
        if cfg.vocab_size % mp:
            raise ValueError(
                f"TP serving needs vocab ({cfg.vocab_size}) divisible by "
                f"the '{self.mp_axis}' degree {mp} (the logits gather "
                f"concatenates equal per-shard slices)")
        if self.weight_dtype == "int4" and (
                (cfg.hidden_size // 2) % mp
                or (cfg.intermediate_size // 2) % mp):
            raise ValueError(
                f"int4 TP serving needs hidden_size/2 "
                f"({cfg.hidden_size // 2}) and intermediate_size/2 "
                f"({cfg.intermediate_size // 2}) divisible by the "
                f"'{self.mp_axis}' degree {mp} (nibble-packed in-dim)")

    # -- construction --------------------------------------------------------
    @classmethod
    def from_weight_loader(cls, cfg, load, weight_dtype: Optional[str] = None,
                           device=None, mesh=None, **kw):
        """Build from ``load(name, shape)``, which returns one raw [in, out]
        tensor per weight (names as in the class's ``_weight_specs``).
        Each matmul weight is quantized on the device as it arrives and
        the full-precision original dropped, so the peak is about the quantized
        total plus one layer in full precision. With a ``mesh`` the
        weights load on its first device and are then cut into shards
        (the scales are those of the whole matrix, as in JAX)."""
        if weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be None, 'int8' or "
                             f"'int4', got {weight_dtype!r}")
        dev = _load_device(device, mesh, kw.get("mp_axis", cls._MP_AXIS))
        qf = _QUANTIZERS[weight_dtype]
        layers = [dict() for _ in range(cfg.num_hidden_layers)]
        flat = {}
        for name, shape, is_mat in cls._weight_specs(cfg):
            arr = load(name, shape).to(dev)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"loader returned {tuple(arr.shape)} for "
                                 f"{name}; expected {shape}")
            val = qf(arr) if is_mat else arr
            if name.startswith("layers."):
                _, li, key = name.split(".")
                layers[int(li)][key] = val
            else:
                flat[name] = val
            del arr
        weights = {**flat, "layers": layers}
        if mesh is not None:
            return cls(cfg, weights, weight_dtype=weight_dtype, mesh=mesh,
                       **kw)
        return cls(cfg, weights, weight_dtype=weight_dtype, device=dev,
                   **kw)

    @classmethod
    def from_config(cls, cfg, seed: int = 0, init_scale: float = 0.02,
                    device=None, mesh=None, **kw):
        """Randomly initialized decoder from a config: norm gains
        (``_is_gain``) are ones, every other weight N(0, init_scale) in
        the config's dtype, drawn per weight from a ``torch.Generator``
        on the device seeded by (seed, crc32(name)). Not the JAX
        package's threefry bits. With a ``mesh`` the draws are made on
        its first device, so a tp decoder holds the same weights as a
        one-device decoder there."""
        dev = _load_device(device, mesh, kw.get("mp_axis", cls._MP_AXIS))
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        gen = torch.Generator(device=dev)

        def load(name, shape):
            if len(shape) == 1 and cls._is_gain(name):
                return torch.ones(shape, dtype=dtype, device=dev)
            gen.manual_seed((seed * 1000003
                             + (zlib.crc32(name.encode()) & 0x7FFFFFFF))
                            & 0x7FFFFFFFFFFFFFFF)
            return (torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=dev) * init_scale).to(dtype)

        if mesh is not None:
            return cls.from_weight_loader(cfg, load, mesh=mesh, **kw)
        return cls.from_weight_loader(cfg, load, device=dev, **kw)

    @classmethod
    def from_numpy_weights(cls, cfg, tree, weight_dtype: Optional[str] = None,
                           device=None, int4_layout: str = "halves", **kw):
        """Build from the JAX decoder's ``weights`` tree turned into numpy
        (see ``inference.weights.weights_from_numpy``; a JAX tp decoder's
        tree is per-projection with ``int4_layout="interleaved"``). With
        a ``mesh`` in ``kw`` the tree is cut into the port's shards."""
        from .weights import weights_from_numpy
        mesh = kw.get("mesh")
        dev = _load_device(device, mesh, kw.get("mp_axis", cls._MP_AXIS))
        weights = weights_from_numpy(tree, weight_dtype=weight_dtype,
                                     device=dev, int4_layout=int4_layout)
        if mesh is None:
            kw["device"] = dev
        return cls(cfg, weights, weight_dtype=weight_dtype, **kw)

    # -- tensor parallelism ------------------------------------------------------
    def _on_shards(self, *ts):
        """[shard][i]: each of ts on each shard's device (the same tensor
        where it already is; None stays None)."""
        return [[None if t is None else t.to(d, non_blocking=True)
                 for t in ts] for d in self.devices]

    def _block_reduce(self, parts):
        """The one collective of an attention or MLP block: the shards'
        partial row-parallel products summed, fp32 or int8 per
        ``tp_comm`` (JAX ``_block_reduce``). One shard passes through."""
        if self.tp_comm == "int8":
            return int8_all_reduce(parts)
        return all_reduce(parts)

    def lora_context(self, layout, lora_pool, lora_tables):
        """A dispatch's adapter factors: each table row's pages gathered
        out of the pool plane once (``lora_tables`` [S, n_pages]; a row
        of scratch blocks reads the all-zero null adapter), as the JAX
        engine's ``_lora_ctx`` gathers [S, n_pages * page_elems], then
        laid out per module by ``lora_factors``. The plane is one, on
        shard 0's device; shards slice the factors."""
        s = lora_tables.shape[0]
        flat = lora_pool.index_select(0, lora_tables.reshape(-1).long())
        return self.lora_factors(layout, flat.reshape(s, -1))

    @staticmethod
    def lora_factors(layout, flat):
        """(layout, {(layer, module): (A_cat [din, S * r], B_cat [S * r,
        dout])}, S) from flat [S, capacity] float32: slot s's A in
        columns s * r .. s * r + r - 1 of A_cat, its B in the same rows
        of B_cat. Made once a dispatch, so a ministep's deltas are two
        plain products a module."""
        s, r = flat.shape[0], layout.rank
        factors = {}
        for (li, name), (off_a, off_b) in layout.offsets.items():
            _, _, din, dout, _ = layout.entry(li, name)
            a = flat[:, off_a:off_a + din * r].reshape(s, din, r)
            factors[(li, name)] = (
                a.permute(1, 0, 2).reshape(din, s * r),
                flat[:, off_b:off_b + r * dout].reshape(s * r, dout))
        return layout, factors, s

    def _lora_delta(self, lora, row_seq, x, li: int, name: str,
                    shard: int = 0):
        """Each row's adapter delta of module (li, name), [rows, dout] in
        x's dtype; x [rows, din], row_seq [rows] picks the row's factors.
        JAX gathers a [rows, din, r] copy of A per row; here every row
        meets every slot's A in one product ([rows, S * r]), a one-hot of
        row_seq keeps its own slot's r columns, and one product with the
        slots' B stacked sums them, so the other slots add exact zeros.
        float32 throughout. Under tp shard ``shard`` takes its slice, as
        JAX's: a column module B's out columns, a row module A's in rows
        (its delta is a partial sum, reduced with the base product)."""
        layout, factors, s = lora
        a_cat, b_cat = factors[(li, name)]
        n = self.n_shards
        if n > 1:
            if layout.entry(li, name)[4] == "col":
                b_cat = cut(b_cat, 1, shard, n)
            else:
                a_cat = cut(a_cat, 0, shard, n)
            a_cat = a_cat.to(x.device, non_blocking=True)
            b_cat = b_cat.to(x.device, non_blocking=True)
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        cols = torch.arange(s * layout.rank, device=x.device) // layout.rank
        keep = row_seq.long()[:, None] == cols[None, :]     # [rows, S * r]
        xa = (x2 @ a_cat) * keep.to(torch.float32)
        return (xa @ b_cat).to(x.dtype)

    # -- speculative decoding ---------------------------------------------------
    def _spec_accept(self, k_pool, v_pool, toks, draft_ids, slots,
                     seg_start, is_draft, scratch_slot: int):
        """The verify ministep's acceptance, after its forward. toks [W]:
        each row's sampled token (a draft row's is the model's token
        for the position after it); draft_ids [W]: each draft row's
        proposal; slots [W]; seg_start [W]: the row index of the row's
        column base (a column's rows are contiguous); is_draft [W].
        Draft row r is accepted when every draft of its column up to r
        equals the token sampled at the row before it: a cumulative sum
        of mismatches. Rejected draft rows wrote their K/V into their
        own slots during the forward (later drafts attend them); one
        zero write per layer clears them, every other row aiming at the
        scratch slot; under tp each shard clears its own heads. Returns
        (accepted [W] bool, k_pool, v_pool)."""
        is_draft = is_draft != 0
        ok = is_draft & (torch.roll(toks, 1) == draft_ids)
        cb = torch.cumsum((is_draft & ~ok).to(torch.int32), 0)
        accepted = is_draft & (cb - cb[seg_start.long()] == 0)
        tgt = slots.masked_fill(~(is_draft & ~accepted), scratch_slot)
        for kp, vp in zip(k_pool, v_pool):
            plane = _plane_values(kp[0])
            _, kvh, bs, hd = plane.shape
            tgt_s = tgt.to(plane.device, non_blocking=True)
            dtype = torch.float32 if isinstance(kp[0], tuple) \
                else plane.dtype
            zeros = torch.zeros((toks.shape[0], kvh, hd), dtype=dtype,
                                device=plane.device)
            index = pool_index(tgt_s, bs, kvh)
            for li in range(len(kp)):
                reshape_and_cache(zeros, zeros, kp[li], vp[li], tgt_s,
                                  index=index)
        return accepted, k_pool, v_pool

    def _final_logits(self, ws, h, last_idx):
        """Float32 logits of h [b, s, hidden] (per shard) at each row's
        last_idx (None: the last position)."""
        hl = []
        for hs in h:
            if last_idx is None:
                hl.append(hs[:, -1])
            else:
                b = hs.shape[0]
                hl.append(hs[torch.arange(b, device=hs.device),
                             last_idx.to(hs.device).long()])
        return self._head_logits(ws, hl)

    def _decode_scan_impl(self, weights, k_pool, v_pool, first_ids,
                          tables_all, ctx_all, slots_all, sample=None):
        """T decode steps from a host-precomputed schedule (tables_all
        [T, b, max_pages], ctx_all / slots_all [T, b]); each step's token
        feeds the next on the device, with no host sync. ``sample`` maps
        a step's float32 logits [b, vocab] to its int32 tokens (None:
        greedy argmax). Returns (tokens [b, T] int32, k_pool, v_pool)."""
        cur = first_ids
        out = []
        for t in range(tables_all.shape[0]):
            logits, k_pool, v_pool = self._decode_logits(
                weights, k_pool, v_pool, cur, tables_all[t], ctx_all[t],
                slots_all[t])
            cur = (logits.argmax(dim=-1).to(torch.int32) if sample is None
                   else sample(logits))
            out.append(cur)
        if not out:
            return (torch.zeros((first_ids.shape[0], 0), dtype=torch.int32,
                                device=first_ids.device), k_pool, v_pool)
        return torch.stack(out, dim=1), k_pool, v_pool

    # -- public API ------------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 32,
                 timings: Optional[dict] = None) -> np.ndarray:
        """Greedy batched generation. input_ids [b, prompt_len]
        (numpy, list or tensor) of EQUAL-length prompts (mixed lengths
        are the ServingEngine's job); returns numpy int32 [b, prompt_len
        + max_new_tokens]. A ``timings`` dict receives prefill_s and
        decode_s wall times (taken after a device synchronize)."""
        with torch.inference_mode():
            return _paged_generate(self, input_ids, max_new_tokens, timings)


class PagedLlamaDecoder(_PagedDecoder):
    """Paged-KV Llama decoder on one device (``device=None``: cuda), or
    tensor-parallel over the ``mp_axis`` of a ``ProcessMesh``.

    Tensor parallelism (JAX ``_TPDecoderMixin``, ``paged_decode.py:269-
    420``): ``mesh=`` with ``tp_shard_map=True`` is JAX's fully-manual
    decoder. The per-projection weight tree is cut by the canonical
    table (``distributed/spec_layout.py``) into one tree per shard, on
    the shard's device, and each shard's q/k/v and gate/up are fused as
    on one device. The pool splits its kv heads over the shards. Every
    program runs each layer shard by shard on the shard's heads and
    intermediate slice, with exactly one ``_block_reduce`` after wo and
    one after wd (fp32 sum, or the int8 collective under
    ``tp_comm="int8"``) and the logits' gather before sampling, which
    leaves the whole logits on shard 0's device. ``mesh=`` without
    ``tp_shard_map`` is JAX's GSPMD decoder: it computes the same
    function, and the port runs it on the same sharded execution with
    the fp32 sum (its ``_tp`` stays 1, as in JAX). Shards may share a
    device (``devices=["cuda:0"] * 2``). ``weights`` is the list of shard trees
    and ``cache.k`` / ``cache.v`` the lists of the shards' planes (one
    shard on one device), the operands every program takes."""

    def __init__(self, cfg: LlamaConfig, weights: dict,
                 num_blocks: int = 512, block_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 weight_dtype: Optional[str] = None,
                 kv_quant: Optional[str] = None, device=None, mesh=None,
                 mp_axis: str = "mp", tp_shard_map: bool = False,
                 tp_comm: str = "fp32"):
        super().__init__(cfg, weights, num_blocks=num_blocks,
                         block_size=block_size,
                         max_pages_per_seq=max_pages_per_seq,
                         weight_dtype=weight_dtype, kv_quant=kv_quant,
                         device=device, mesh=mesh, mp_axis=mp_axis,
                         tp_shard_map=tp_shard_map, tp_comm=tp_comm)
        cos, sin = build_rope_cache(cfg.max_position_embeddings,
                                    self.head_dim, cfg.rope_theta,
                                    torch.float32, device=self.device)
        self._cos = cos[0, :, 0, :]   # [max_len, head_dim]
        self._sin = sin[0, :, 0, :]
        # the tables on each shard's device (the same tensors on one)
        self._rope_of = {}
        for dev in self.devices:
            key = (self._cos.new_empty(0, device=dev).device)
            self._rope_of[key] = (self._cos.to(dev), self._sin.to(dev))

    # -- construction --------------------------------------------------------
    _fuse = staticmethod(_fuse_layers)
    _weight_specs = staticmethod(_weight_specs)

    @classmethod
    def from_model(cls, model, num_blocks: int = 512, block_size: int = 16,
                   max_pages_per_seq: Optional[int] = None,
                   weight_dtype: Optional[str] = None,
                   kv_quant: Optional[str] = None, device=None, **tp_kw):
        """Serve a ``LlamaForCausalLM`` (JAX: ``PagedLlamaDecoder(model)``
        through ``_extract_weights``, ``paged_decode.py:216-247``) by way
        of ``from_weight_loader``: the model's Linear weights are already
        [in, out]; with ``weight_dtype`` they are quantized per channel,
        the norms and the embedding stay as they are. A tied model's head
        is the embedding transposed. Dtypes follow JAX: the pool takes
        the embedding's dtype, float32 even under ``dtype="bfloat16"``,
        so such a model serves in float32. ``tp_kw`` are the tensor-
        parallel arguments (``mesh``, ``mp_axis``, ``tp_shard_map``,
        ``tp_comm``).

        On ``device`` (``None``: cuda) the decoder shares the model's
        tensors wherever it keeps a weight as it is: the embedding, the
        norms, wo, wd and the head (all of them but the fused q/k/v and
        gate/up products when ``weight_dtype`` is None). A model trained
        after this call changes those shared weights only, so build the
        decoder once training is done. Shards are copies."""
        m = model.model
        embed = m.embed_tokens.weight
        params = {"embed": embed, "norm": m.norm.weight,
                  "head": embed.t() if model.lm_head is None
                  else model.lm_head.weight}
        for li, lyr in enumerate(m.layers):
            a, mlp = lyr.self_attn, lyr.mlp
            for key, mod in (("ln1", lyr.input_layernorm),
                             ("ln2", lyr.post_attention_layernorm),
                             ("wq", a.q_proj), ("wk", a.k_proj),
                             ("wv", a.v_proj), ("wo", a.o_proj),
                             ("wg", mlp.gate_proj), ("wu", mlp.up_proj),
                             ("wd", mlp.down_proj)):
                params[f"layers.{li}.{key}"] = mod.weight
        return cls.from_weight_loader(
            model.cfg, lambda name, shape: params[name].detach(),
            weight_dtype=weight_dtype, device=device, num_blocks=num_blocks,
            block_size=block_size, max_pages_per_seq=max_pages_per_seq,
            kv_quant=kv_quant, **tp_kw)

    # -- building blocks ------------------------------------------------------
    def _proj_qkv(self, w, hn):
        cfg = self.cfg
        n = self.n_shards
        nh, kvh, hd = (cfg.num_attention_heads // n,
                       cfg.num_key_value_heads // n, self.head_dim)
        qkv = _mm(hn, w["wqkv"])
        q, k, v = torch.split(qkv, [nh * hd, kvh * hd, kvh * hd], dim=-1)
        lead = hn.shape[:-1]
        return (q.reshape(*lead, nh, hd), k.reshape(*lead, kvh, hd),
                v.reshape(*lead, kvh, hd))

    def _mlp(self, w, hn):
        gu = _mm(hn, w["wgu"])
        it = self.cfg.intermediate_size // self.n_shards
        g_, u_ = torch.split(gu, [it, gu.shape[-1] - it], dim=-1)
        return _mm(F.silu(g_) * u_, w["wd"])

    def _layers(self, ws, h, attn, lora=None, row_seq=None):
        """The layer stack over the shards. h: the hidden state on each
        shard's device; ``attn(s, li, w, hn)`` runs shard s's attention
        of layer li (writing its K/V) and returns its [..., heads * hd]
        output. Each block's shard products meet in one
        ``_block_reduce``. ``lora``/``row_seq``: the adapters' deltas on
        wo and the MLP. Returns the final h per shard."""
        eps = self.cfg.rms_norm_eps
        for li in range(self.cfg.num_hidden_layers):
            parts = []
            for s, w in enumerate(ws):
                lw = w["layers"][li]
                af = attn(s, li, lw, rms_norm(h[s], lw["ln1"], eps))
                o = _mm(af, lw["wo"])
                if lora is not None:
                    o = o + self._lora_delta(lora, row_seq[s], af, li, "wo",
                                             shard=s)
                parts.append(o)
            h = [a + b for a, b in zip(h, self._block_reduce(parts))]
            parts = []
            for s, w in enumerate(ws):
                lw = w["layers"][li]
                hn = rms_norm(h[s], lw["ln2"], eps)
                parts.append(self._mlp(lw, hn) if lora is None else
                             self._lora_mlp(lw, hn, lora, row_seq[s], li,
                                            shard=s))
            h = [a + b for a, b in zip(h, self._block_reduce(parts))]
        return h

    def _head_logits(self, ws, h):
        """Float32 logits of the final hidden rows h (per shard): the
        norm, each shard's vocab slice, the gather on shard 0's device."""
        eps = self.cfg.rms_norm_eps
        return all_gather_logits(
            [_mm(rms_norm(hs, w["norm"], eps), w["head"]).to(torch.float32)
             for w, hs in zip(ws, h)])

    # -- many-LoRA serving (inference/lora.py) -----------------------------------
    def lora_target_modules(self):
        """(name, din, dout, kind) of the modules an adapter may change,
        in the JAX decoder's order, over the whole (unsharded) dims; kind
        is the base weight's tensor-parallel placement."""
        cfg = self.cfg
        h = cfg.hidden_size
        ad = cfg.num_attention_heads * self.head_dim
        kvd = cfg.num_key_value_heads * self.head_dim
        it = cfg.intermediate_size
        return (("wq", h, ad, "col"), ("wk", h, kvd, "col"),
                ("wv", h, kvd, "col"), ("wo", ad, h, "row"),
                ("wg", h, it, "col"), ("wu", h, it, "col"),
                ("wd", it, h, "row"))

    def _lora_mlp(self, w, hn, lora, row_seq, li, shard: int = 0):
        """``_mlp`` with the adapters' deltas: wg and wu deltas added to
        the gate and up products before SiLU, the wd delta to the down
        product."""
        gu = _mm(hn, w["wgu"])
        it = self.cfg.intermediate_size // self.n_shards
        g_, u_ = torch.split(gu, [it, gu.shape[-1] - it], dim=-1)
        g_ = g_ + self._lora_delta(lora, row_seq, hn, li, "wg", shard)
        u_ = u_ + self._lora_delta(lora, row_seq, hn, li, "wu", shard)
        mid = F.silu(g_) * u_
        return _mm(mid, w["wd"]) + self._lora_delta(lora, row_seq, mid, li,
                                                     "wd", shard)

    def _rope_tables(self, positions, dtype):
        """(cos, sin) [*positions.shape, 1, head_dim] at positions, in
        dtype, from the tables on positions' device."""
        cos, sin = self._rope_of[positions.device]
        return (cos[positions][..., None, :].to(dtype),
                sin[positions][..., None, :].to(dtype))

    def _rope(self, x, positions, tables=None):
        """x [..., heads, head_dim] at positions broadcasting over its
        leading dims ([rows] for [rows, heads, head_dim], [s] or [b, s]
        for [b, s, heads, head_dim]); ``tables`` are the
        ``_rope_tables`` of those positions when already gathered."""
        cos, sin = tables or self._rope_tables(positions, x.dtype)
        return x * cos + rotate_half(x) * sin

    def _ragged_logits(self, weights, k_pool, v_pool, ids, positions, slots,
                       row_seq, row_ctx, tables, lora=None):
        """One ragged ministep up to the logits. ids / positions / slots /
        row_seq / row_ctx [rows] int32 on the decoder's device; tables
        [num_seqs, max_pages] int32. The pools are updated in place and
        returned for symmetry with the JAX signature. ``lora``: a
        ``lora_context``; each row adds its table row's adapter delta to
        q / k / v (before RoPE), to the wo product, to gate and up
        (before SiLU) and to the wd product, as in JAX. Without it the
        ministep runs exactly the base operations.
        Returns (logits [rows, vocab] float32, k_pool, v_pool)."""
        cfg = self.cfg
        r = ids.shape[0]
        nh = cfg.num_attention_heads // self.n_shards
        pos = positions.long().clamp(max=cfg.max_position_embeddings - 1)
        ops = self._on_shards(ids, pos, slots, row_seq, row_ctx, tables)
        # per-ministep constants shared by every layer: the RoPE rows of
        # these positions and the pool index of these slots
        rope = [self._rope_tables(o[1], weights[s]["embed"].dtype)
                for s, o in enumerate(ops)]
        index = [pool_index(o[2], self.block_size,
                            cfg.num_key_value_heads // self.n_shards)
                 for o in ops]

        def attn(s, li, w, hn):
            _, p, sl, rs, rc, tb = ops[s]
            q, k, v = self._proj_qkv(w, hn)
            if lora is not None:
                q = q + self._lora_delta(lora, rs, hn, li, "wq",
                                         s).reshape(q.shape)
                k = k + self._lora_delta(lora, rs, hn, li, "wk",
                                         s).reshape(k.shape)
                v = v + self._lora_delta(lora, rs, hn, li, "wv",
                                         s).reshape(v.shape)
            # one rotation for q and k together
            qk = self._rope(torch.cat([q, k], dim=1), p, rope[s])
            q, k = qk[:, :nh].contiguous(), qk[:, nh:]
            reshape_and_cache(k, v, k_pool[s][li], v_pool[s][li], sl,
                              index=index[s])
            return ragged_paged_attention(q, k_pool[s][li], v_pool[s][li],
                                          tb, rs, rc).reshape(r, -1)

        h = [w["embed"][o[0].long()] for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn, lora, [o[3] for o in ops])
        return self._head_logits(weights, h), k_pool, v_pool

    # -- dense per-phase programs ----------------------------------------------
    def _prefill_impl(self, weights, k_pool, v_pool, ids, slots,
                      last_idx=None, *, logits: bool = True):
        """A bucketed prefill from position 0. ids [b, s]; slots [b, s]
        flat pool slots (right-padding rows aim at the scratch page);
        last_idx [b] each row's final REAL token (None: s - 1). Causal
        attention over the chunk itself through ``flash_attention`` (the
        flash forward kernel on the card). The pools are written in
        place. Returns (logits [b, vocab] float32, or None when
        ``logits`` is False, k_pool, v_pool)."""
        cfg = self.cfg
        b, s = ids.shape
        kvh = cfg.num_key_value_heads // self.n_shards
        hd = self.head_dim
        # clamped like the offset programs: a bucket's padding rows may
        # sit past max_position_embeddings (JAX's gather clamps them)
        pos = torch.arange(s, device=ids.device).clamp(
            max=cfg.max_position_embeddings - 1)
        ops = self._on_shards(ids, pos, slots.reshape(-1))
        rope = [self._rope_tables(o[1], weights[i]["embed"].dtype)
                for i, o in enumerate(ops)]
        index = [pool_index(o[2], self.block_size, kvh) for o in ops]

        def attn(i, li, w, hn):
            q, k, v = self._proj_qkv(w, hn)
            q = self._rope(q, ops[i][1], rope[i])
            k = self._rope(k, ops[i][1], rope[i])
            v = v.contiguous()
            out = flash_attention(q, k, v, causal=True)
            reshape_and_cache(k.reshape(b * s, kvh, hd),
                              v.reshape(b * s, kvh, hd), k_pool[i][li],
                              v_pool[i][li], None, index=index[i])
            return out.reshape(b, s, -1)

        h = [w["embed"][o[0].long()] for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _prefill_prefix_impl(self, weights, k_pool, v_pool, ids, slots,
                             last_idx, n_cached, prefix_tables, *,
                             logits: bool = True):
        """A prefill at an offset: row i's ids [s] sit at positions
        ``n_cached[i] + j`` and attend the prefix already in the pool
        (``prefix_tables`` [b, P], scratch-padded past the prefix) plus
        themselves, causally. Rows with n_cached 0 are an ordinary
        bucketed prefill. Returns (logits at last_idx [b, vocab] float32,
        or None, k_pool, v_pool)."""
        cfg = self.cfg
        b, s = ids.shape
        kvh = cfg.num_key_value_heads // self.n_shards
        hd = self.head_dim
        pos = (torch.arange(s, device=ids.device)[None]
               + n_cached.long()[:, None]).clamp(
                   max=cfg.max_position_embeddings - 1)     # [b, s]
        ops = self._on_shards(ids, pos, slots.reshape(-1), n_cached,
                              prefix_tables)
        rope = [self._rope_tables(o[1], weights[i]["embed"].dtype)
                for i, o in enumerate(ops)]
        index = [pool_index(o[2], self.block_size, kvh) for o in ops]

        def attn(i, li, w, hn):
            _, p, _, ncv, ptab = ops[i]
            q, k, v = self._proj_qkv(w, hn)
            q = self._rope(q, p, rope[i])
            k = self._rope(k, p, rope[i])
            k_pre = _gather_prefix_pages(k_pool[i][li], ptab)
            v_pre = _gather_prefix_pages(v_pool[i][li], ptab)
            out = _prefix_suffix_attention(q, k, v, k_pre, v_pre, ncv)
            reshape_and_cache(k.reshape(b * s, kvh, hd),
                              v.reshape(b * s, kvh, hd), k_pool[i][li],
                              v_pool[i][li], None, index=index[i])
            return out.reshape(b, s, -1)

        h = [w["embed"][o[0].long()] for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        out = self._final_logits(weights, h, last_idx) if logits else None
        return out, k_pool, v_pool

    def _decode_logits(self, weights, k_pool, v_pool, last_ids, tables,
                       ctx_lens, slots):
        """One decode token per sequence, up to the logits. last_ids /
        ctx_lens / slots [b] int32 (ctx_lens counts the tokens already
        cached, EXCLUDING this one, so RoPE runs at position ctx and
        attention sees ctx + 1 positions); tables [b, max_pages] int32.
        This token's K/V is written to the pool before attention.
        Returns (logits [b, vocab] float32, k_pool, v_pool)."""
        cfg = self.cfg
        b = last_ids.shape[0]
        nh = cfg.num_attention_heads // self.n_shards
        pos = ctx_lens.long().clamp(max=cfg.max_position_embeddings - 1)
        ops = self._on_shards(last_ids, pos, slots, tables, ctx_lens + 1)
        rope = [self._rope_tables(o[1], weights[i]["embed"].dtype)
                for i, o in enumerate(ops)]
        index = [pool_index(o[2], self.block_size,
                            cfg.num_key_value_heads // self.n_shards)
                 for o in ops]

        def attn(i, li, w, hn):
            _, p, sl, tb, visible = ops[i]
            q, k, v = self._proj_qkv(w, hn)
            qk = self._rope(torch.cat([q, k], dim=1), p, rope[i])
            q, k = qk[:, :nh].contiguous(), qk[:, nh:]
            reshape_and_cache(k, v, k_pool[i][li], v_pool[i][li], sl,
                              index=index[i])
            return paged_attention_decode(q, k_pool[i][li], v_pool[i][li], tb,
                                          visible).reshape(b, -1)

        h = [w["embed"][o[0].long()] for w, o in zip(weights, ops)]
        h = self._layers(weights, h, attn)
        return self._head_logits(weights, h), k_pool, v_pool


def _paged_generate(dec, input_ids, max_new_tokens, timings=None):
    """Page allocation (sequence ids 0..b-1), one prefill, a host-
    precomputed decode schedule, one decode loop, page free."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    ids = np.asarray(input_ids).astype(np.int32)
    if ids.ndim != 2 or ids.shape[1] == 0:
        raise ValueError(f"generate needs input_ids [batch, prompt_len], "
                         f"got shape {ids.shape}")
    b, s = ids.shape
    dev = dec.device
    cache = dec.cache

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seqs = list(range(b))
    slot_rows = []
    for i in seqs:
        cache.allocate(i, s + max(0, max_new_tokens))
        slot_rows.append([cache.extend(i) for _ in range(s)])
    try:
        t0 = time.perf_counter()
        logits, _, _ = dec._prefill_impl(
            dec.weights, cache.k, cache.v,
            torch.from_numpy(ids).to(dev),
            torch.as_tensor(slot_rows, dtype=torch.int32, device=dev))
        next_ids = logits.argmax(dim=-1).to(torch.int32)
        if timings is not None:
            sync()
            timings["prefill_s"] = time.perf_counter() - t0
        if max_new_tokens <= 0:
            return ids
        T = max_new_tokens - 1
        ctx_all = np.zeros((T, b), np.int32)
        slots_all = np.zeros((T, b), np.int32)
        tables_all = np.zeros((T, b, dec.max_pages), np.int32)
        for t in range(T):
            ctx_all[t] = [cache.context_len(i) for i in seqs]
            slots_all[t] = [cache.extend(i) for i in seqs]
            tables_all[t] = np.stack(
                [cache.block_table(i, dec.max_pages) for i in seqs])
        t1 = time.perf_counter()
        toks, _, _ = dec._decode_scan_impl(
            dec.weights, cache.k, cache.v, next_ids,
            torch.from_numpy(tables_all).to(dev),
            torch.from_numpy(ctx_all).to(dev),
            torch.from_numpy(slots_all).to(dev))
        toks = toks.cpu().numpy()
        if timings is not None:
            timings["decode_s"] = time.perf_counter() - t1
        return np.concatenate(
            [ids, next_ids.cpu().numpy()[:, None], toks], axis=1)
    finally:
        for i in seqs:
            cache.free(i)
