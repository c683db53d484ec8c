"""Many-LoRA serving (``ServingEngine(lora=AdapterRegistry(...))``) in the
port against the JAX package.

The workloads of tests/test_lora_serving.py, but the GPT twin: ``LoRALayout`` offsets equal JAX's; flattened factors
(``register_random``'s seeded draws and explicit factors of a smaller
rank) bit-equal; the same acquire / release / pool-pressure sequence
through both registries leaves equal hit, miss and eviction counters
and equal pools after every operation; ``_lora_delta`` and one
``_ragged_logits(lora=...)`` ministep within 2e-5 of JAX's (float32;
the port sums the slots' products in another order); base traffic
bit-identical with a registry bound; mixed-tenant streams, greedy and sampled,
equal to JAX's engine; cross-tenant prefix isolation (the salted chain hashes
equal JAX's in one process); preemption and resume with adapters;
serving through (A, B) equals serving merged weights; ``check_tp`` and
``bind(sharding=)`` against JAX's, and mixed tenants at tp 2 (each shard
slicing its factors) equal to JAX's tp-2 engine and the port's tp 1.
``llama_tiny``
float32 on one torch thread, the JAX decoder's seeded weights carried
over; the port's ragged engine is held against JAX's with
``overlap=False``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference import AdapterRegistry as JaxRegistry  # noqa: E402
from paddle_tpu.inference import LoRALayout as JaxLayout  # noqa: E402
from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.ops.paged_attention import \
    PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.inference.lora import (AdapterRegistry,  # noqa: E402
                                             LoRALayout)
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import (KVCacheExhausted,  # noqa: E402
                                                  PagedKVCache)
from _torch_serving_cases import tp_pair  # noqa: E402

POOL = dict(num_blocks=64, block_size=8)
VOCAB = 512
# tests/test_lora_serving.py _engine
ENGINE = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              prefill_chunk=8)
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, **POOL)
    tree = jax.tree.map(np.asarray, jdec.weights)
    return jdec, tree


def _tdec(tree, **pool):
    return PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, device="cpu", **dict(POOL, **pool))


def _registry(cls, n=2, rank=2, scale=0.2):
    reg = cls(rank=rank)
    for i in range(n):
        reg.register_random(f"a{i}", seed=100 + i, scale=scale)
    return reg


def _prompts(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, ln).astype(np.int32)
            for ln in (12, 9, 17, 21, 7, 14)[:n]]


def _engine(dec, lora=None, **kw):
    return ServingEngine(dec, ragged=True, lora=lora, **dict(ENGINE, **kw))


def _serve(eng, prompts, aids=None, new=8, temps=None):
    params = JaxParams if isinstance(eng, JaxEngine) else SamplingParams
    aids = aids or [None] * len(prompts)
    temps = temps or [0.0] * len(prompts)
    rids = [eng.add_request(p, params(max_new_tokens=new, adapter_id=a,
                                      temperature=t))
            for p, a, t in zip(prompts, aids, temps)]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _layout_of(tdec, rank=2, page_elems=None):
    cache = tdec.cache
    _, kvh, bs, hd = cache.k[0][0].shape
    return LoRALayout(tdec.lora_target_modules(),
                      tdec.cfg.num_hidden_layers, rank,
                      page_elems or 2 * len(cache.k[0]) * kvh * bs * hd)


# -- layout and registry ---------------------------------------------------------

@pytest.mark.parametrize("rank,page", [(1, 16), (2, 32), (8, 1000)])
def test_layout_offsets_equal_jax(rank, page):
    mods = (("wq", 8, 8, "col"), ("wk", 8, 4, "col"), ("wo", 8, 8, "row"),
            ("wd", 12, 8, "row"))
    lay, jlay = LoRALayout(mods, 3, rank, page), JaxLayout(mods, 3, rank,
                                                           page)
    assert lay.offsets == jlay.offsets
    assert (lay.total, lay.n_pages, lay.capacity) == \
        (jlay.total, jlay.n_pages, jlay.capacity)
    for li in range(3):
        for name, *_ in mods:
            assert lay.entry(li, name) == jlay.entry(li, name)
    with pytest.raises(ValueError, match="kind"):
        LoRALayout((("wq", 8, 8, "diag"),), 1, 1, 8)


def _fake_dec(cache, modules=(("wq", 6, 6, "col"), ("wd", 10, 6, "row"))):
    """A decoder stand-in: a cache, two layers, target modules."""
    return SimpleNamespace(cache=cache, cfg=SimpleNamespace(
        num_hidden_layers=2), lora_target_modules=lambda: modules)


def _pools(num_blocks=24):
    kw = dict(num_layers=2, num_blocks=num_blocks, block_size=4,
              kv_heads=1, head_dim=2)
    return JaxCache(**kw), PagedKVCache(device="cpu", **kw)


def test_flattened_factors_bit_equal():
    """register_random's seeded factors and explicit factors of rank 1
    under rank 3 with alpha 6, flattened by both registries."""
    rng = np.random.RandomState(3)
    explicit = {"wq": (rng.randn(6, 1), rng.randn(1, 6)),
                "layers.1.wd": (rng.randn(10, 1), rng.randn(1, 6))}
    regs = []
    for cls, cache in zip((JaxRegistry, AdapterRegistry), _pools()):
        reg = cls(rank=3, alpha=6)
        reg.register_random("r", seed=7, scale=0.3)
        reg.register("e", explicit)
        reg.bind(_fake_dec(cache))
        regs.append(reg)
    for aid in ("r", "e"):
        np.testing.assert_array_equal(regs[1]._flatten(aid),
                                      regs[0]._flatten(aid))
    for reg in regs:
        with pytest.raises(ValueError, match="matches no target"):
            reg.register("bad", {"w_q": explicit["wq"]})
        with pytest.raises(ValueError, match="already registered"):
            reg.register_random("r", seed=1)
        with pytest.raises(ValueError, match="base model"):
            reg.register(None, {})


def _cache_state(c):
    return (dict(c._tables), dict(c._lens), list(c._free), list(c._lru),
            dict(c._ref), dict(c._hash_of), dict(c._block_of),
            c.prefix_evictions)


def test_paging_counters_equal_jax_op_by_op():
    """Fault-in, ref bump, park, revive, eviction under pressure and
    refault, exhaustion: after every operation both registries hold the
    same counters and uses, both pools the same state, the same plane
    rows."""
    caches = _pools()
    regs = [_registry(cls, n=3) for cls in (JaxRegistry, AdapterRegistry)]
    for reg, cache in zip(regs, caches):
        reg.bind(_fake_dec(cache))
    n_pages = regs[1].n_pages()
    assert n_pages == regs[0].n_pages() > 1

    def both(op, *args):
        outs = []
        for reg, cache in zip(regs, caches):
            try:
                if op in ("acquire", "release"):
                    getattr(reg, op)(*args)
                elif op == "pressure":   # claim everything, then free it
                    cache.allocate(999, cache.available_blocks
                                   * cache.block_size)
                    cache.free(999)
                else:
                    getattr(cache, op)(*args)
                outs.append("ok")
            except (RuntimeError, ValueError, KeyError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (op, args, outs)
        for attr in ("hits", "misses", "evictions"):
            assert getattr(regs[0], attr) == getattr(regs[1], attr), attr
        assert regs[0].stats() == regs[1].stats()
        assert _cache_state(caches[0]) == _cache_state(caches[1]), op
        rows = list(caches[1]._ref)
        if rows:
            np.testing.assert_array_equal(
                caches[1].lora_pool[rows].numpy(),
                np.asarray(caches[0].lora_pool)[rows])
        for reg, cache in zip(regs, caches):
            reg.debug_check()
            cache.debug_check()
        return outs[1]

    for op in [("acquire", "a0"), ("acquire", "a0"), ("release", "a0"),
               ("release", "a0"), ("acquire", "a0"), ("acquire", "a1"),
               ("release", "a0"), ("pressure",), ("acquire", "a0"),
               ("acquire", "a2"), ("release", "a1"), ("release", "a2"),
               ("release", "a0"), ("release", "a0"), ("allocate", 7, 60),
               ("acquire", "a1"), ("acquire", "nope")]:
        both(*op)
    assert regs[1].evictions >= 1 and regs[1].misses >= 4


# -- the device half -------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_lora_delta_equals_jax(pair, seed):
    """Every module of both layers: random flat factors for 4 slots (the
    last all zeros, the null adapter), rows on random slots."""
    jdec, tree = pair
    tdec = _tdec(tree, num_blocks=4)
    lay = _layout_of(tdec, rank=3)
    rng = np.random.RandomState(seed)
    flat = (rng.randn(4, lay.capacity) * 0.1).astype(np.float32)
    flat[3] = 0.0
    row_seq = rng.randint(0, 4, 7).astype(np.int32)
    jl = (lay, jnp.asarray(flat), 0)
    tl = tdec.lora_factors(lay, torch.from_numpy(flat))
    for li in range(2):
        for name, din, dout, _ in lay.modules:
            x = rng.randn(7, din).astype(np.float32)
            want = np.asarray(jdec._lora_delta(jl, jnp.asarray(row_seq),
                                               jnp.asarray(x), li, name))
            got = tdec._lora_delta(tl, torch.from_numpy(row_seq),
                                   torch.from_numpy(x), li, name).numpy()
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
            assert np.all(got[row_seq == 3] == 0.0)


def test_ragged_logits_with_lora_equals_jax(pair):
    """One ragged ministep of a fresh 10-row prefill over two sequences
    (one on an adapter, one on the null row), from zeroed pools."""
    jdec, tree = pair
    tdec = _tdec(tree, num_blocks=8)
    jfresh = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=8,
                                    block_size=8)
    lay = _layout_of(tdec)
    rng = np.random.RandomState(5)
    flat = np.zeros((3, lay.capacity), np.float32)
    flat[0] = rng.randn(lay.capacity) * 0.2
    ids = rng.randint(0, VOCAB, 10).astype(np.int32)
    pos = np.r_[np.arange(6), np.arange(4)].astype(np.int32)
    rseq = np.r_[np.zeros(6), np.ones(4)].astype(np.int32)
    slots = np.r_[np.arange(6), 8 + np.arange(4)].astype(np.int32)
    tables = np.array([[0, 2], [1, 2], [2, 2]], np.int32)
    args = (ids, pos, slots, rseq, pos + 1, tables)
    want, _, _ = jfresh._ragged_logits(
        jfresh.weights, jfresh.cache.k, jfresh.cache.v,
        *map(jnp.asarray, args), lora=(lay, jnp.asarray(flat), 0))
    got, _, _ = tdec._ragged_logits(
        tdec.weights, tdec.cache.k, tdec.cache.v,
        *map(torch.from_numpy, args),
        lora=tdec.lora_factors(lay, torch.from_numpy(flat)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    base, _, _ = tdec._ragged_logits(
        tdec.weights, tdec.cache.k, tdec.cache.v,
        *map(torch.from_numpy, args))
    # the null row's logits are the base model's; the adapter's are not
    np.testing.assert_allclose(got[6:].numpy(), base[6:].numpy(),
                               atol=1e-5)
    assert float((got[:6] - base[:6]).abs().max()) > 1e-3


# -- the engine ------------------------------------------------------------------

def test_base_traffic_bit_identical_with_registry(pair):
    _, tree = pair
    prompts = _prompts(3)
    base = _serve(_engine(_tdec(tree)), prompts, temps=[0.0, 1.0, 0.0])
    eng = _engine(_tdec(tree), lora=_registry(AdapterRegistry))
    assert _serve(eng, prompts, temps=[0.0, 1.0, 0.0]) == base
    assert eng.stats()["adapter_cache_misses"] == 0
    assert not any(f.startswith("ragged_lora")
                   for f, _ in eng.programs.dispatches)


def test_mixed_tenant_streams_equal_jax(pair):
    """Two adapters and a base row in one batch: JAX's streams and
    registry counters; the base row keeps the base model's stream, the
    tenants leave it."""
    jdec, tree = pair
    prompts = _prompts(3)
    aids = ["a0", None, "a1"]
    jdec.cache.clear_prefix_cache()
    jeng = JaxEngine(jdec, ragged=True, overlap=False,
                     lora=_registry(JaxRegistry), **ENGINE)
    want = _serve(jeng, prompts, aids, new=10)
    eng = _engine(_tdec(tree), lora=_registry(AdapterRegistry))
    got = _serve(eng, prompts, aids, new=10)
    assert got == want
    st, jst = eng.stats(), jeng.stats()
    for key in ("adapter_cache_hits", "adapter_cache_misses",
                "adapter_cache_evictions", "lora_rows_per_dispatch",
                "active_adapters"):
        assert st[key] == jst[key], key
    base = _serve(_engine(_tdec(tree)), prompts, new=10)
    assert got[1] == base[1] and got[0] != base[0] and got[2] != base[2]
    same = _serve(eng, [prompts[0]] * 2, ["a0", "a0"], new=10)
    assert same[0] == same[1] == got[0]


def test_sampled_tenant_rows_equal_jax(pair):
    """Temperature-1.0 rows on two adapters beside a greedy tenant row
    and a sampled base row: JAX's streams and registry counters token
    for token (the engines consume one key stream)."""
    jdec, tree = pair
    prompts = _prompts(4, seed=2)
    aids = ["a0", "a1", None, "a0"]
    temps = [1.0, 1.0, 1.0, 0.0]
    jdec.cache.clear_prefix_cache()
    jeng = JaxEngine(jdec, ragged=True, overlap=False,
                     lora=_registry(JaxRegistry), **ENGINE)
    want = _serve(jeng, prompts, aids, new=10, temps=temps)
    eng = _engine(_tdec(tree), lora=_registry(AdapterRegistry))
    got = _serve(eng, prompts, aids, new=10, temps=temps)
    assert got == want
    st, jst = eng.stats(), jeng.stats()
    for key in ("adapter_cache_hits", "adapter_cache_misses",
                "lora_rows_per_dispatch"):
        assert st[key] == jst[key], key
    greedy = _serve(_engine(_tdec(tree), lora=_registry(AdapterRegistry)),
                    prompts, aids, new=10)
    assert got[0] != greedy[0] and got[1] != greedy[1]
    assert got[3] == greedy[3]


def test_cross_tenant_prefix_isolation(pair):
    """The same prompt under another adapter, or the base model, splices
    nothing; the same tenant splices. The salted chain hashes equal
    JAX's (one process)."""
    _, tree = pair
    long_p = np.tile(_prompts(1)[0], 3)[:24]      # 3 blocks of 8
    jc, tc = _pools()
    for salt in (None, "a0", 3):
        assert tc._chain_hashes(long_p, salt) == \
            jc._chain_hashes(long_p, salt)
    assert tc._chain_hashes(long_p, "a0") != tc._chain_hashes(long_p, "a1")
    eng = _engine(_tdec(tree), lora=_registry(AdapterRegistry))
    cache = eng.dec.cache
    _serve(eng, [long_p], ["a0"])
    hit0 = cache.prefix_hit_tokens
    _serve(eng, [long_p], ["a1"])
    _serve(eng, [long_p], [None])
    assert cache.prefix_hit_tokens == hit0
    _serve(eng, [long_p], ["a0"])
    assert cache.prefix_hit_tokens > hit0


def test_preemption_resume_with_adapters(pair):
    """Optimistic admission on a tight pool preempts adapter requests;
    they refault on readmission and resume token-identically."""
    _, tree = pair
    prompts = _prompts(3, seed=3)
    aids = ["a0", "a1", "a0"]
    loose = _serve(_engine(_tdec(tree), lora=_registry(AdapterRegistry)),
                   prompts, aids, new=12)
    tdec = _tdec(tree, num_blocks=16)
    eng = _engine(tdec, lora=_registry(AdapterRegistry),
                  admission="optimistic")
    rids = [eng.add_request(p, SamplingParams(max_new_tokens=12,
                                              adapter_id=a))
            for p, a in zip(prompts, aids)]
    while eng.step():
        tdec.cache.debug_check()
        eng._debug_lora_check()
    assert [eng.result(r).tolist() for r in rids] == loose
    assert eng.stats()["preemptions"] >= 1


def test_merged_weights_equivalence(pair):
    """Serving through (A, B) equals serving W + A @ B (alpha = rank, so
    the scale is 1): packing order, offsets and orientation end to
    end."""
    _, tree = pair
    cfg = llama_tiny()
    h, it = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    rng = np.random.RandomState(7)
    ab = {name: (rng.randn(din, 2).astype(np.float32) * 0.1,
                 rng.randn(2, dout).astype(np.float32) * 0.1)
          for name, din, dout in (("wq", h, h), ("wk", h, kvd),
                                  ("wv", h, kvd), ("wo", h, h),
                                  ("wg", h, it), ("wu", h, it),
                                  ("wd", it, h))}
    reg = AdapterRegistry(rank=2, alpha=2)
    reg.register("t", ab)
    p = _prompts(1, seed=7)[0]
    out_lora = _serve(_engine(_tdec(tree), lora=reg), [p], ["t"], new=10)
    merged = jax.tree.map(np.array, tree)
    delta = {k: a @ b for k, (a, b) in ab.items()}
    for lw in merged["layers"]:
        lw["wqkv"] = lw["wqkv"] + np.concatenate(
            [delta["wq"], delta["wk"], delta["wv"]], axis=1)
        lw["wgu"] = lw["wgu"] + np.concatenate([delta["wg"], delta["wu"]],
                                               axis=1)
        lw["wo"] = lw["wo"] + delta["wo"]
        lw["wd"] = lw["wd"] + delta["wd"]
    out_merged = _serve(_engine(_tdec(merged)), [p], new=10)
    assert out_lora == out_merged


def test_validation_exhaustion_and_stats_reset(pair):
    _, tree = pair
    with pytest.raises(ValueError, match="no AdapterRegistry"):
        _engine(_tdec(tree)).add_request(
            _prompts(1)[0], SamplingParams(adapter_id="a0"))
    with pytest.raises(TypeError, match="AdapterRegistry"):
        _engine(_tdec(tree), lora=object())
    small = _tdec(tree, num_blocks=12)
    eng = _engine(small, lora=_registry(AdapterRegistry, n=1))
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.add_request(_prompts(1)[0], SamplingParams(adapter_id="x"))
    with pytest.raises(ValueError, match="adapter pages"):
        eng.add_request(np.arange(30) % VOCAB,
                        SamplingParams(max_new_tokens=30, adapter_id="a0"))
    cache = small.cache
    cache.allocate(999, cache.available_blocks * cache.block_size)
    with pytest.raises(KVCacheExhausted):
        eng.lora.acquire("a0")
    cache.free(999)
    _serve(eng, _prompts(2), ["a0", None])
    st = eng.stats()
    assert st["adapter_cache_misses"] == 1 and st["active_adapters"] == 0
    assert st["lora_rows_per_dispatch"] > 0
    eng.clear_finished()
    st = eng.stats()
    for key in ("adapter_cache_hits", "adapter_cache_misses",
                "adapter_cache_evictions", "lora_rows_per_dispatch"):
        assert st[key] == 0


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_check_tp_equals_jax(tp):
    """A column module's out dim and a row module's in dim must divide by
    the degree, in both packages."""
    modules = (("wq", 6, 8, "col"), ("wd", 12, 6, "row"))
    jl, tl = (cls(modules, 2, 2, 64) for cls in (JaxLayout, LoRALayout))
    try:
        jl.check_tp(tp)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            tl.check_tp(tp)
    else:
        tl.check_tp(tp)


def test_tp2_identity(pair):
    """tests/test_lora_serving.py:339: two adapters and a base row at tp
    2 (the plane replicated, each shard slicing its factors, a row
    module's delta reduced with its base product) give JAX's tp-2
    streams and the port's tp 1 streams."""
    jdec1, tree = pair
    jdec, tdec = tp_pair(2, jax_tiny(), llama_tiny(), **POOL)
    prompts = _prompts(3, seed=2)
    aids = ["a0", None, "a1"]
    jdec.cache.clear_prefix_cache()
    want = _serve(JaxEngine(jdec, ragged=True, overlap=False, tp=2,
                            lora=_registry(JaxRegistry), **ENGINE),
                  prompts, aids)
    reg = _registry(AdapterRegistry)
    got = _serve(_engine(tdec, lora=reg, tp=2), prompts, aids)
    assert got == want
    assert got == _serve(_engine(_tdec(tree), lora=_registry(
        AdapterRegistry)), prompts, aids)
    assert reg.layout.modules == tuple(tdec.lora_target_modules())
    bad = _registry(AdapterRegistry)
    with pytest.raises(ValueError, match="replicates"):
        bad.bind(tdec, sharding=(None, "tp"))
