"""Prefix caching in the port against the JAX package.

Pool level, no model: the same operation sequences (allocate with a
prefix splice, match, extend, free, eviction under pressure,
``clear_prefix_cache``, ``rollback``, ``unregister_block_hashes``, a
random admit/retire schedule) go through JAX's ``PagedKVCache`` and the
port's, and after every step the two hold equal tables, lengths, free
lists, LRU order, ref counts, hash index and hit / query / eviction
counters, and both pass ``debug_check``. The chain hashes are equal.

Engine level: ``llama_tiny`` float32, the JAX decoder's weights carried
into the port by ``weights_from_numpy``, both schedulers, the workloads
of tests/test_prefix_cache.py (the mixed shared-prefix batch, the
same-wave burst, eviction under pressure, the capacity credit). The
port with caching on is token-identical to JAX's ``prefix_caching=True``
engine and to itself with caching off, with equal hit tokens,
evictions, free blocks and cached blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.ops.paged_attention import \
    PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import (KVCacheExhausted,
                                                  PagedKVCache)  # noqa: E402
from _torch_serving_cases import assert_identical  # noqa: E402

VOCAB = 512


# -- pool level --------------------------------------------------------------

def _pools(num_blocks=16, block_size=4):
    kw = dict(num_layers=1, num_blocks=num_blocks, block_size=block_size,
              kv_heads=1, head_dim=4)
    return JaxCache(**kw), PagedKVCache(device="cpu", **kw)


def _state(c):
    return (dict(c._tables), dict(c._lens), list(c._free), list(c._lru),
            dict(c._ref), dict(c._hash_of), dict(c._block_of),
            c.prefix_hit_tokens, c.prefix_query_tokens, c.prefix_evictions,
            c.free_blocks, c.cached_blocks, c.available_blocks)


def _both(pair, op, *args):
    """Apply one operation to both pools: equal results (or the same
    exception type), then equal state and both invariants."""
    outs = []
    for c in pair:
        try:
            outs.append(("ok", getattr(c, op)(*args)))
        except (RuntimeError, ValueError, KeyError) as e:
            outs.append(("raise", type(e).__name__))
    assert outs[0] == outs[1], (op, args, outs)
    assert _state(pair[0]) == _state(pair[1]), (op, args)
    for c in pair:
        c.debug_check()
    return outs[1][1]


def _toks(*parts):
    return np.concatenate([np.asarray(p, np.int32) for p in parts])


@pytest.mark.parametrize("n", [0, 3, 4, 7, 8, 13, 40])
def test_chain_hashes_equal_jax(n):
    jc, tc = _pools()
    toks = np.random.RandomState(n).randint(0, VOCAB, n).astype(np.int32)
    assert tc._chain_hashes(toks) == jc._chain_hashes(toks)
    assert len(tc._chain_hashes(toks)) == n // 4


def test_match_splice_evict_clear_sequence():
    """tests/test_prefix_cache.py TestPoolPrefixCache, op by op on both
    pools: the match cap, the splice and its LRU revive, shared blocks,
    leaf-first eviction, clear_prefix_cache, double and unknown frees."""
    pair = _pools(num_blocks=8, block_size=4)
    a = np.arange(12, dtype=np.int32)                   # 3 full blocks
    assert _both(pair, "allocate_with_prefix", 0, a, 12) == ([], 0)
    for _ in range(12):
        _both(pair, "extend", 0)
    _both(pair, "free", 0)                              # park 3 blocks
    assert pair[1].cached_blocks == 3
    assert len(_both(pair, "match_prefix", a)) == 2     # capped
    assert len(_both(pair, "match_prefix", _toks(a, [99]))) == 3
    fork = a.copy()
    fork[5] = 77
    assert len(_both(pair, "match_prefix", fork)) == 1
    longer = _toks(a[:8], [5, 6, 7])
    reused, n = _both(pair, "allocate_with_prefix", 1, longer, 11)
    assert n == 8 and len(reused) == 2
    assert _both(pair, "allocate_with_prefix", 2, longer, 11)[0] == reused
    _both(pair, "free", 1)
    _both(pair, "free", 2)
    _both(pair, "free", 2)                              # double free
    _both(pair, "free", 12345)                          # never allocated
    assert _both(pair, "can_allocate_with_prefix", np.arange(50, 80), 30)
    assert not _both(pair, "can_allocate_with_prefix", np.arange(50, 90),
                     40)
    _both(pair, "allocate_with_prefix", 3, np.arange(50, 90), 40)  # raises
    _both(pair, "allocate", 3, 6 * 4)                   # free list dry
    assert pair[1].prefix_evictions > 0
    _both(pair, "allocate", 3, 4)                       # already allocated
    _both(pair, "free", 3)
    _both(pair, "clear_prefix_cache")
    assert pair[1].cached_blocks == 0 and pair[1].free_blocks == 8
    assert _both(pair, "match_prefix", a) == []
    _both(pair, "reset_prefix_stats")


def test_eviction_eats_chains_leaf_first():
    pair = _pools(num_blocks=4, block_size=4)
    toks = np.arange(13, dtype=np.int32)                # 3 full blocks + 1
    _both(pair, "allocate_with_prefix", 0, toks, 16)
    _both(pair, "free", 0)
    _both(pair, "allocate", 1, 8)                       # evicts one
    assert pair[1].prefix_evictions == 1
    assert len(_both(pair, "match_prefix", toks)) == 2  # head survives


def test_rollback_and_unregister_sequence():
    pair = _pools(num_blocks=12, block_size=4)
    p = np.arange(10, dtype=np.int32)                   # 2 full blocks
    _both(pair, "allocate_with_prefix", 0, p, 12)
    for _ in range(10):
        _both(pair, "extend", 0)
    for _ in range(9):                                  # into a 6th block
        _both(pair, "extend", 0)
    _both(pair, "rollback", 0, 13, 3)                   # floored at 3
    _both(pair, "rollback", 0, 30)                      # outside: raises
    _both(pair, "rollback", 0, 3)                       # into block 0
    _both(pair, "allocate_with_prefix", 1, _toks(p, [1, 2]), 12)
    _both(pair, "unregister_block_hashes", pair[1].seq_blocks(1))
    _both(pair, "free", 1)
    _both(pair, "free", 0)
    _both(pair, "allocate_with_prefix", 2, p, 10)
    _both(pair, "free", 2)
    _both(pair, "unregister_block_hashes", list(pair[1]._lru))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_admit_retire_schedule(seed):
    """tests/test_prefix_cache.py test_invariant_over_random_schedule,
    with rollbacks, run through both pools step for step."""
    rng = np.random.RandomState(seed)
    pair = _pools(num_blocks=24, block_size=4)
    prefixes = [rng.randint(0, VOCAB, (8,)).astype(np.int32)
                for _ in range(3)]
    live = {}
    for step in range(300):
        r = rng.rand()
        if live and (len(live) >= 4 or r < 0.35):
            sid = int(rng.choice(sorted(live)))
            _both(pair, "free", sid)
            del live[sid]
        elif live and r < 0.45:
            sid = int(rng.choice(sorted(live)))
            cur = pair[1].context_len(sid)
            _both(pair, "rollback", sid, int(rng.randint(0, cur + 1)),
                  live[sid])
        else:
            pre = prefixes[rng.randint(3)]
            tail = rng.randint(0, VOCAB, (rng.randint(1, 6),))
            toks = _toks(pre, tail)
            total = len(toks) + int(rng.randint(1, 8))
            if not _both(pair, "can_allocate_with_prefix", toks, total):
                continue
            _, n_cached = _both(pair, "allocate_with_prefix", step, toks,
                                total)
            live[step] = len(pair[1].seq_blocks(step))
            for _ in range(len(toks) - n_cached):
                _both(pair, "extend", step)
    for sid in list(live):
        _both(pair, "free", sid)
    assert pair[1].free_blocks + pair[1].cached_blocks == 24


def test_refusal_leaves_pool_untouched():
    pair = _pools(num_blocks=4, block_size=4)
    _both(pair, "allocate_with_prefix", 0, np.arange(8), 8)
    _both(pair, "free", 0)
    before = _state(pair[1])
    with pytest.raises(KVCacheExhausted):
        pair[1].allocate_with_prefix(1, np.arange(50, 70), 20)
    assert _state(pair[1]) == before


# -- engine level ------------------------------------------------------------

# tests/test_prefix_cache.py TestEnginePrefixCache._engine
ENGINE = dict(max_batch_size=2, prompt_buckets=(8, 16, 32), chunk_size=4)


def _decoders(num_blocks):
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=num_blocks,
                                  block_size=8)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, device="cpu", num_blocks=num_blocks,
        block_size=8)
    return jdec, tdec


def _shared_prefix_prompts(rng, shared_len=24, n_shared=4, n_disjoint=2,
                           tail=(3, 9)):
    """tests/test_prefix_cache.py _shared_prefix_prompts."""
    shared = rng.randint(0, VOCAB, (shared_len,)).astype(np.int32)
    ps = [np.concatenate([shared, rng.randint(
        0, VOCAB, (int(rng.randint(*tail)),)).astype(np.int32)])
        for _ in range(n_shared)]
    ps += [rng.randint(0, VOCAB, (shared_len - 3,)).astype(np.int32)
           for _ in range(n_disjoint)]
    return ps


STAT_KEYS = ("prefix_cache_hit_tokens", "prefix_cache_evictions",
             "free_blocks", "cached_blocks")


def _run_jax(jdec, prompts, news, ragged, **kw):
    eng = JaxEngine(jdec, ragged=ragged, prefix_caching=True,
                    **{**ENGINE, **kw})
    rids = [eng.add_request(p, JaxParams(max_new_tokens=n))
            for p, n in zip(prompts, news)]
    eng.run_to_completion()
    st = eng.stats()
    return [eng.result(r).tolist() for r in rids], \
        {k: st[k] for k in STAT_KEYS}


def _run_port(tdec, prompts, news, ragged, prefix_caching=True, **kw):
    eng = ServingEngine(tdec, ragged=ragged, prefix_caching=prefix_caching,
                        **{**ENGINE, **kw})
    rids = [eng.add_request(p, SamplingParams(max_new_tokens=n))
            for p, n in zip(prompts, news)]
    while eng.step():
        tdec.cache.debug_check()
    st = eng.stats()
    assert st["finished"] == len(prompts)
    assert st["free_blocks"] + st["cached_blocks"] \
        == tdec.cache.num_blocks - 1
    return [eng.result(r).tolist() for r in rids], \
        {k: st[k] for k in STAT_KEYS}


def _hold(prompts, news, ragged, num_blocks=64, **kw):
    """Port (caching on) == JAX (caching on) in tokens and cache stats,
    and == the port with caching off in tokens. Returns the stats."""
    jdec, tdec = _decoders(num_blocks)
    reqs = [(p, None) for p in prompts]
    port, st = _run_port(tdec, prompts, news, ragged, **kw)
    ref, jst = _run_jax(jdec, prompts, news, ragged, **kw)
    assert_identical(tdec, reqs, port, ref)
    assert st == jst
    off, _ = _run_port(tdec, prompts, news, ragged, prefix_caching=False,
                       **kw)
    assert_identical(tdec, reqs, port, off)
    return st


@pytest.mark.parametrize("ragged", [False, True])
def test_mixed_shared_prefix_batch(ragged):
    prompts = _shared_prefix_prompts(np.random.RandomState(11))
    st = _hold(prompts, [6, 4, 8, 5, 7, 3], ragged)
    assert st["prefix_cache_hit_tokens"] == 3 * 24


@pytest.mark.parametrize("ragged", [False, True])
def test_same_wave_burst(ragged):
    """Every shared-prefix request admitted in one wave: the readers
    splice blocks whose writer has not dispatched yet and wait for it."""
    prompts = _shared_prefix_prompts(np.random.RandomState(12),
                                     shared_len=16, n_shared=5,
                                     n_disjoint=1)
    st = _hold(prompts, [5] * 6, ragged, max_batch_size=6)
    assert st["prefix_cache_hit_tokens"] == 4 * 16


@pytest.mark.parametrize("ragged", [False, True])
def test_eviction_under_pressure(ragged):
    rng = np.random.RandomState(3)
    groups = [_shared_prefix_prompts(rng, shared_len=16, n_shared=2,
                                     n_disjoint=0) for _ in range(3)]
    prompts = [p for g in groups for p in g]
    prompts += [rng.randint(0, VOCAB, (17,)).astype(np.int32)
                for _ in range(2)]
    st = _hold(prompts, [5] * len(prompts), ragged, num_blocks=10)
    assert st["prefix_cache_evictions"] > 0


@pytest.mark.parametrize("ragged", [False, True])
def test_capacity_credit(ragged):
    """Two 29-token prompts sharing 24 tokens with 8 new tokens each do
    not fit 8 usable pages apart (5 each), but both run at once when
    the shared pages are counted once: B is admitted while A runs."""
    rng = np.random.RandomState(13)
    shared = rng.randint(0, VOCAB, (24,)).astype(np.int32)
    a, b = (np.concatenate([shared, rng.randint(0, VOCAB, (5,))])
            .astype(np.int32) for _ in range(2))
    jdec, tdec = _decoders(9)
    outs, running = [], []
    for eng, params in (
            (ServingEngine(tdec, ragged=ragged, **ENGINE), SamplingParams),
            (JaxEngine(jdec, ragged=ragged, prefix_caching=True, **ENGINE),
             JaxParams)):
        ra = eng.add_request(a, params(max_new_tokens=8))
        eng.step()
        rb = eng.add_request(b, params(max_new_tokens=8))
        eng.step()
        running.append(sum(r is not None for r in eng._slots))
        eng.run_to_completion()
        outs.append([eng.result(r).tolist() for r in (ra, rb)])
        eng.dec.cache.debug_check()
    assert running == [2, 2]
    assert_identical(tdec, [(a, None), (b, None)], outs[0], outs[1])


def test_clear_finished_resets_prefix_counters():
    _, tdec = _decoders(64)
    prompts = _shared_prefix_prompts(np.random.RandomState(11))
    eng = ServingEngine(tdec, **ENGINE)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=4))
    eng.run_to_completion()
    assert eng.stats()["prefix_cache_hit_tokens"] > 0
    eng.clear_finished()
    st = eng.stats()
    assert (st["prefix_cache_hit_tokens"], st["prefix_cache_hit_rate"],
            st["prefix_cache_evictions"], st["finished"]) == (0, 0.0, 0, 0)
    # a new engine on the same decoder starts from a clean index
    eng.close()
    assert tdec.cache.cached_blocks == 0
    eng2 = ServingEngine(tdec, **ENGINE)
    rid = eng2.add_request(prompts[0], SamplingParams(max_new_tokens=2))
    eng2.run_to_completion()
    assert eng2.stats()["prefix_cache_hit_tokens"] == 0
    assert len(eng2.result(rid)) == 2
