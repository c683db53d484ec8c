"""Many-LoRA serving, the host half: the packing layout and the adapter
registry.

Counterpart: ``paddle_tpu/inference/lora.py``.

Adapters are paged through the KV pool's own allocator
(``PagedKVCache``): an adapter's flattened (A, B) factors fill
``n_pages`` pages of the cache's ``lora_pool`` plane ([num_blocks,
page_elems] float32), at the block ids the allocator hands a
pseudo-sequence of the adapter. An adapter in use is ref-counted like
any sequence; an unused one parks in the allocator's cached-block LRU
under synthetic page hashes, where any allocation may evict it, and
acquiring it again revives the pages or uploads them anew. The device
half is the decoders' ``lora_context`` / ``_lora_delta``
(``paged_decode._PagedDecoder``) at each decoder's
``lora_target_modules`` (Llama's seven, GPT's six: ``wq wk wv wo wi
wf``, whose q / k / v deltas add to the pieces of the fused projection)
and the engine's lora program families.

Tensor parallelism, as in JAX: the plane replicates (one plane, on the
first shard's device; shards read their factors from it), and each
shard slices the whole factors to its own part of the base weight: a
COLUMN module (wq / wk / wv / wg / wu, GPT's wi) applies A whole and
takes its out columns of B, a ROW module (wo / wd, GPT's wf) takes its
in rows of A, and its partial delta is added before the block's one
all-reduce, which reduces base and delta together. The collectives stay
the base program's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LoRALayout", "AdapterRegistry"]


class LoRALayout:
    """The flat packing of one registry's adapters: rank ``rank`` (a
    smaller adapter zero-pads), one (A [din, r], B [r, dout]) pair per
    target module per layer, layer-major, module-minor, A before B.
    ``modules``: ((name, din, dout, kind)); kind "col" or "row" names
    the base weight's tensor-parallel placement."""

    def __init__(self, modules: Sequence[Tuple[str, int, int, str]],
                 num_layers: int, rank: int, page_elems: int):
        self.modules = tuple((str(n), int(di), int(do), str(k))
                             for n, di, do, k in modules)
        if not self.modules:
            raise ValueError("LoRA layout needs at least one target "
                             "module")
        for n, di, do, k in self.modules:
            if k not in ("col", "row"):
                raise ValueError(f"module {n}: kind must be 'col' or "
                                 f"'row', got {k!r}")
        self.num_layers = int(num_layers)
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        self.page_elems = int(page_elems)
        if self.page_elems < 1:
            raise ValueError("page_elems must be >= 1")
        # offsets[(li, name)] = (offA, offB)
        self.offsets: Dict[Tuple[int, str], Tuple[int, int]] = {}
        off = 0
        for li in range(self.num_layers):
            for name, din, dout, _ in self.modules:
                off_a = off
                off += din * self.rank
                self.offsets[(li, name)] = (off_a, off)
                off += self.rank * dout
        self.total = off
        self.n_pages = -(-self.total // self.page_elems)
        self.capacity = self.n_pages * self.page_elems
        self._dims = {n: (di, do, k) for n, di, do, k in self.modules}

    def entry(self, li: int, name: str):
        """(offA, offB, din, dout, kind) of one module of one layer."""
        off_a, off_b = self.offsets[(li, name)]
        din, dout, kind = self._dims[name]
        return off_a, off_b, din, dout, kind

    def check_tp(self, tp: int):
        """Each module's sharded dim (a column module's out dim, a row
        module's in dim) divides by the tp degree."""
        for n, di, do, k in self.modules:
            dim = do if k == "col" else di
            if dim % tp:
                raise ValueError(
                    f"LoRA module {n}: {'out' if k == 'col' else 'in'} dim "
                    f"{dim} not divisible by tp={tp}")

    def module_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _, _, _ in self.modules)


class AdapterRegistry:
    """Host store of adapters and their paging through the KV pool.

    Usage::

        reg = AdapterRegistry(rank=8)
        reg.register("alice", {"wq": (A, B), ...})   # every layer
        reg.register_random("bob", seed=1)
        eng = ServingEngine(dec, ragged=True, lora=reg)
        eng.add_request(ids, SamplingParams(adapter_id="alice"))

    ``acquire`` (at admission): an adapter in use gains a user (a hit);
    a parked one whose pages all survive is revived from the LRU (a
    hit); anything else is uploaded into freshly allocated pages (a
    miss; also an eviction when it was resident before). ``release``:
    at zero users its pages park. ``acquire`` raises
    ``KVCacheExhausted`` when the pool cannot hold the pages, which the
    engine treats as admission pressure."""

    _OWNER_BASE = -1000   # pseudo-sequence ids -1000, -1001, ...

    def __init__(self, rank: int, alpha: Optional[float] = None,
                 page_elems: Optional[int] = None):
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self._page_elems_arg = page_elems
        self.layout: Optional[LoRALayout] = None
        self._cache = None
        self._raw: Dict[object, Tuple[dict, float]] = {}
        self._random: Dict[object, Tuple[int, float, float]] = {}
        self._flat: Dict[object, np.ndarray] = {}     # padded to pages
        self._owner: Dict[object, int] = {}
        self._use: Dict[object, int] = {}
        self._hashes: Dict[object, List[object]] = {}
        self._was_resident: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # telemetry: the refault event on the owning engine's pid
        # (ServingEngine.set_telemetry attaches it; None: no-op)
        self.tracer = None
        self.trace_pid = 0

    # -- registration (host only) -------------------------------------------
    def _check_new(self, adapter_id):
        if adapter_id is None:
            raise ValueError("adapter_id None is the base model")
        if adapter_id in self:
            raise ValueError(f"adapter {adapter_id!r} already "
                             f"registered")

    def register(self, adapter_id, weights: Dict[str, tuple],
                 alpha: Optional[float] = None):
        """Register explicit factors: ``weights`` maps a module name
        ("wq", every layer) or a per-layer key ("layers.3.wq") to (A
        [din, ra], B [ra, dout]) with ra <= rank. A module left out
        adds a zero delta. alpha / rank folds into B."""
        self._check_new(adapter_id)
        self._raw[adapter_id] = (dict(weights),
                                 float(alpha) if alpha is not None
                                 else self.alpha)
        if self.layout is not None:
            self._flat[adapter_id] = self._flatten(adapter_id)

    def register_random(self, adapter_id, seed: int,
                        scale: float = 0.02,
                        alpha: Optional[float] = None):
        """Seeded N(0, scale) factors for every target module, drawn at
        bind time from ``np.random.RandomState(seed)`` in the JAX
        package's order, so the factors are the same bits."""
        self._check_new(adapter_id)
        self._random[adapter_id] = (
            int(seed), float(scale),
            float(alpha) if alpha is not None else self.alpha)

    def ids(self) -> List[object]:
        return list(self._raw) + list(self._random)

    def __contains__(self, adapter_id) -> bool:
        return adapter_id in self._raw or adapter_id in self._random

    def is_registered(self, adapter_id) -> bool:
        return adapter_id in self

    # -- binding -------------------------------------------------------------
    def bind(self, dec, sharding=None):
        """Attach to a decoder's cache: the layout from the decoder's
        target modules (``check_tp`` under tp), the cache's adapter
        plane, the owner ids. One registry binds one cache. The default
        page holds one KV block's element count (K and V, every layer,
        all heads). ``sharding``: the plane's spec (``SpecLayout().spec(
        "lora_pool")``), which must replicate."""
        if self._cache is not None:
            if self._cache is dec.cache:
                return
            raise ValueError("AdapterRegistry is already bound to a "
                             "different engine's cache")
        cache = dec.cache
        page_elems = self._page_elems_arg
        if page_elems is None:
            page_elems = (2 * cache.num_layers * cache.kv_heads
                          * cache.block_size * cache.head_dim)
        if sharding is not None and any(e is not None for e in sharding):
            raise ValueError(f"the adapter plane replicates over tp; got "
                             f"the spec {sharding!r}")
        layout = LoRALayout(dec.lora_target_modules(),
                            dec.cfg.num_hidden_layers, self.rank,
                            page_elems)
        if len(cache.devices) > 1:
            layout.check_tp(len(cache.devices))
        self.layout = layout
        cache.enable_lora_pool(self.layout.page_elems)
        self._cache = cache
        for i, aid in enumerate(self.ids()):
            self._owner[aid] = self._OWNER_BASE - i
            self._use.setdefault(aid, 0)
        self._next_owner = self._OWNER_BASE - len(self._owner)

    def _owner_of(self, adapter_id) -> int:
        o = self._owner.get(adapter_id)
        if o is None:
            o = self._next_owner
            self._next_owner -= 1
            self._owner[adapter_id] = o
            self._use.setdefault(adapter_id, 0)
        return o

    def _module_pair(self, weights, li, name, din, dout):
        pair = weights.get(f"layers.{li}.{name}", weights.get(name))
        if pair is None:
            return None
        a, b = pair
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        ra = a.shape[-1]
        if a.shape != (din, ra) or b.shape != (ra, dout) \
                or ra > self.rank:
            raise ValueError(
                f"adapter factors for {name} have shapes "
                f"{a.shape}/{b.shape}; expected ({din}, r)/(r, {dout})"
                f" with r <= {self.rank}")
        return a, b

    def _check_keys(self, adapter_id, weights):
        """Every key names a target module ("wq" or "layers.<i>.wq"): a
        dropped key would quietly serve the base model."""
        lay = self.layout
        valid = set(lay.module_names())
        for key in weights:
            name, li = key, None
            if key.startswith("layers."):
                try:
                    _, li_s, name = key.split(".")
                    li = int(li_s)
                except ValueError:
                    raise ValueError(
                        f"adapter {adapter_id!r}: malformed weight "
                        f"key {key!r} (expected 'layers.<i>.<module>'"
                        f" or a bare module name)") from None
            if name not in valid or (li is not None
                                     and not 0 <= li < lay.num_layers):
                raise ValueError(
                    f"adapter {adapter_id!r}: weight key {key!r} "
                    f"matches no target module; valid modules are "
                    f"{sorted(valid)} over {lay.num_layers} layers")

    def _flatten(self, adapter_id) -> np.ndarray:
        lay = self.layout
        flat = np.zeros(lay.capacity, np.float32)
        if adapter_id in self._random:
            seed, scale, alpha = self._random[adapter_id]
            rng = np.random.RandomState(seed)
            s = alpha / self.rank
            for li in range(lay.num_layers):
                for name, din, dout, _ in lay.modules:
                    off_a, off_b = lay.offsets[(li, name)]
                    a = rng.randn(din, self.rank) * scale
                    b = rng.randn(self.rank, dout) * scale * s
                    flat[off_a:off_a + din * self.rank] = \
                        a.astype(np.float32).ravel()
                    flat[off_b:off_b + self.rank * dout] = \
                        b.astype(np.float32).ravel()
            return flat
        weights, alpha = self._raw[adapter_id]
        self._check_keys(adapter_id, weights)
        s = alpha / self.rank
        for li in range(lay.num_layers):
            for name, din, dout, _ in lay.modules:
                pair = self._module_pair(weights, li, name, din, dout)
                if pair is None:
                    continue
                a, b = pair
                ra = a.shape[-1]
                off_a, off_b = lay.offsets[(li, name)]
                ap = np.zeros((din, self.rank), np.float32)
                ap[:, :ra] = a
                bp = np.zeros((self.rank, dout), np.float32)
                bp[:ra] = b * s
                flat[off_a:off_a + din * self.rank] = ap.ravel()
                flat[off_b:off_b + self.rank * dout] = bp.ravel()
        return flat

    def _page_hashes(self, adapter_id) -> List[object]:
        """Synthetic page hashes, disjoint from prompt chain hashes and
        the same in every life of the adapter, so a revival finds its
        parked pages."""
        hs = self._hashes.get(adapter_id)
        if hs is None:
            hs = [hash(("__lora__", adapter_id, i))
                  for i in range(self.layout.n_pages)]
            self._hashes[adapter_id] = hs
        return hs

    # -- residency -----------------------------------------------------------
    def n_pages(self) -> int:
        if self.layout is None:
            raise RuntimeError("registry not bound")
        return self.layout.n_pages

    def in_use(self, adapter_id) -> int:
        return self._use.get(adapter_id, 0)

    def active_count(self) -> int:
        return sum(1 for v in self._use.values() if v > 0)

    def acquire(self, adapter_id):
        """Pin the adapter for one more user. ``KeyError`` for an
        unregistered id, ``KVCacheExhausted`` when its pages do not
        fit."""
        if adapter_id not in self:
            raise KeyError(f"unknown adapter {adapter_id!r}")
        if self._cache is None:
            raise RuntimeError("registry not bound to an engine")
        cache = self._cache
        owner = self._owner_of(adapter_id)
        if self._use.get(adapter_id, 0) > 0:
            self._use[adapter_id] += 1
            self.hits += 1
            return
        hashes = self._page_hashes(adapter_id)
        parked = [cache.lookup_hash(h) for h in hashes]
        if all(b is not None for b in parked):
            cache.adopt_cached_blocks(owner, parked)
            self._use[adapter_id] = 1
            self.hits += 1
            return
        # a partial survivor is useless without the rest: drop it and
        # upload the whole adapter again
        survivors = [b for b in parked if b is not None]
        if survivors:
            cache.unregister_block_hashes(survivors)
        was_evicted = adapter_id in self._was_resident
        flat = self._flat.get(adapter_id)
        if flat is None:
            flat = self._flatten(adapter_id)
            self._flat[adapter_id] = flat
        lay = self.layout
        # may raise KVCacheExhausted: the counters move only once the
        # upload lands (a waiting request retries every step)
        blocks = cache.allocate(owner, lay.n_pages * cache.block_size)
        cache.write_lora_pages(
            list(blocks), flat.reshape(lay.n_pages, lay.page_elems))
        cache.register_page_hashes(list(blocks), hashes)
        self._use[adapter_id] = 1
        self.misses += 1
        if was_evicted:
            self.evictions += 1
        if self.tracer is not None:
            self.tracer.event(
                "adapter_refault", pid=self.trace_pid,
                adapter=str(adapter_id), pages=lay.n_pages,
                evicted=bool(was_evicted))
        self._was_resident.add(adapter_id)

    def release(self, adapter_id):
        """One user done; at zero users the pages park in the LRU."""
        n = self._use.get(adapter_id, 0)
        if n <= 0:
            raise ValueError(f"adapter {adapter_id!r} released more "
                             f"times than acquired")
        self._use[adapter_id] = n - 1
        if n == 1:
            self._cache.free(self._owner[adapter_id])

    def resident_blocks(self, adapter_id) -> List[int]:
        """The page table of an adapter in use."""
        return self._cache.seq_blocks(self._owner[adapter_id])

    def reset_stats(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def stats(self) -> dict:
        return {"active_adapters": self.active_count(),
                "adapter_cache_hits": self.hits,
                "adapter_cache_misses": self.misses,
                "adapter_cache_evictions": self.evictions}

    def debug_check(self, expected_use: Optional[Dict[object, int]]
                    = None):
        """Every adapter in use owns ``n_pages`` referenced blocks, each
        under its page hash; no unused adapter holds an allocation; with
        ``expected_use`` (the engine's per-slot count) the use counts
        match it. Raises AssertionError."""
        cache = self._cache
        assert cache is not None, "registry not bound"
        for aid, n in self._use.items():
            owner = self._owner[aid]
            if n > 0:
                blocks = cache._tables.get(owner)
                assert blocks is not None and \
                    len(blocks) == self.layout.n_pages, \
                    f"adapter {aid!r}: in use but not fully resident"
                for b, h in zip(blocks, self._page_hashes(aid)):
                    assert cache._ref.get(b, 0) >= 1, \
                        f"adapter {aid!r}: page {b} unreferenced"
                    assert cache._hash_of.get(b) == h, \
                        f"adapter {aid!r}: page {b} lost its hash"
            else:
                assert owner not in cache._tables, \
                    f"adapter {aid!r}: zero users but still allocated"
        if expected_use is not None:
            actual = {a: n for a, n in self._use.items() if n > 0}
            assert actual == {a: n for a, n in expected_use.items()
                              if n > 0}, (
                f"adapter use counts {actual} != engine-derived "
                f"{expected_use}")
