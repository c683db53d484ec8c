"""Speculative decoding (``ServingEngine(spec_decode=SpecConfig(...))``)
in the port against the JAX package.

The workloads of tests/test_spec_decode.py, but the GPT twin: ``NGramDrafter`` proposals equal JAX's on seeded
histories; ``_spec_accept``'s accepted mask and zeroed pools equal
JAX's on seeded verify windows (exactly); oracle, adversarial and
n-gram drafters give the streams of spec off and of JAX's spec engine,
with JAX's counters; chunked prefill mid-stream, a prefix splice, an
EOS inside a draft window and preemption mid-draft keep the spec-off
streams and give JAX's streams and counters; a rich request pauses
speculation; a stochastic column beside a drafted one gives JAX's
stream; tp 2 (an oracle drafter's spec-off streams, JAX's tp-2 spec
engine's streams and counters). ``llama_tiny`` float32 on one torch thread, the JAX decoder's
seeded weights carried over; the port's ragged engine is held against
JAX's with ``overlap=False``. Streams compare token for token.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference import Drafter as JaxDrafter  # noqa: E402
from paddle_tpu.inference import NGramDrafter as JaxNGram  # noqa: E402
from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference import SpecConfig as JaxSpec  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.ops.paged_attention import \
    PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.inference.spec_decode import (  # noqa: E402
    Drafter, NGramDrafter, SpecConfig)
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import PagedKVCache  # noqa: E402
from _torch_serving_cases import tp_pair  # noqa: E402

POOL = dict(num_blocks=96, block_size=8)
VOCAB = 512
# tests/test_spec_decode.py _engine
ENGINE = dict(max_batch_size=4, prompt_buckets=(16, 32, 64), chunk_size=4)


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
    tdec = PagedLlamaDecoder.from_numpy_weights(llama_tiny(), tree,
                                                device="cpu", **POOL)
    return jdec, tdec, tree


def _oracle(base, refs):
    """tests/test_spec_decode.py's OracleDrafter over either package's
    Drafter base: the true continuation of a reference run."""
    refs = [(np.asarray(p, np.int32), list(o)) for p, o in refs]

    class Oracle(base):
        def propose(self, history, k):
            h = np.asarray(history, np.int32)
            for p, out in refs:
                if h.size >= p.size and np.array_equal(h[:p.size], p):
                    done = h.size - p.size
                    return np.asarray(out[done:done + k], np.int32)
            return np.zeros(0, np.int32)
    return Oracle()


def _wrong(base, k=4):
    """The adversarial drafter: (last + 1) mod vocab, always rejected."""
    class Wrong(base):
        def propose(self, history, kk):
            last = int(np.asarray(history)[-1])
            return np.full(min(kk, k), (last + 1) % VOCAB, np.int32)
    return Wrong()


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, int(n)).astype(np.int32) for n in lens]


def _motifs(n=3, seed=0):
    """Prompts that repeat a motif: the traffic prompt lookup serves."""
    rng = np.random.RandomState(seed)
    return [np.tile(rng.randint(0, VOCAB, 5), 3).astype(np.int32)
            for _ in range(n)]


def _engine(dec, spec=None, **kw):
    return ServingEngine(dec, ragged=True, spec_decode=spec,
                         **dict(ENGINE, **kw))


def _run(eng, prompts, new=24, sampling=None):
    params = JaxParams if isinstance(eng, JaxEngine) else SamplingParams
    rids = [eng.add_request(p, params(**(sampling[i] if sampling
                                         else dict(max_new_tokens=new))))
            for i, p in enumerate(prompts)]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _jax_run(jdec, spec, prompts, **kw):
    jdec.cache.clear_prefix_cache()
    eng = JaxEngine(jdec, ragged=True, overlap=False, spec_decode=spec,
                    **ENGINE)
    return _run(eng, prompts, **kw), eng.stats()


SPEC_COUNTERS = ("drafted_tokens", "accepted_draft_tokens",
                 "draft_acceptance_rate", "spec_rollbacks",
                 "draft_acceptance_ema", "generated_tokens")


# -- the drafter -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ngram_proposals_equal_jax(seed):
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, 6, rng.randint(2, 7))
    hist = np.concatenate([np.tile(motif, rng.randint(1, 4)),
                           rng.randint(0, 6, rng.randint(0, 9))]) \
        .astype(np.int32)
    for max_n, min_n in ((4, 1), (3, 2), (1, 1)):
        for k in (0, 1, 3, 8):
            want = JaxNGram(max_n, min_n).propose(hist, k)
            got = NGramDrafter(max_n, min_n).propose(hist, k)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_config_validation():
    with pytest.raises(ValueError, match="draft_len"):
        SpecConfig(draft_len=0)
    with pytest.raises(ValueError, match="min_ngram"):
        NGramDrafter(max_ngram=2, min_ngram=3)
    assert isinstance(SpecConfig().make_drafter(), NGramDrafter)
    d = _wrong(Drafter)
    assert SpecConfig(drafter=d).make_drafter() is d


# -- the acceptance step ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_spec_accept_equals_jax(seed):
    """Seeded verify windows (a column base then up to 4 drafts, drafts
    matching the previous row's token at random, some rows non-draft)
    over random pools: the accepted mask and the pools after the zero
    writes equal JAX's exactly."""
    rng = np.random.RandomState(seed)
    kw = dict(num_layers=2, num_blocks=8, block_size=4, kv_heads=2,
              head_dim=4)
    jc, tc = JaxCache(**kw), PagedKVCache(device="cpu", **kw)
    w = 16
    toks = rng.randint(0, 6, w).astype(np.int32)
    draft = rng.randint(0, 6, w).astype(np.int32)
    is_draft = np.zeros(w, bool)
    seg = np.arange(w, dtype=np.int32)
    c = 0
    while c < w - 1:
        span = min(rng.randint(1, 6), w - c)
        for j in range(1, span):
            is_draft[c + j] = True
            seg[c + j] = c
            if rng.rand() < 0.7:
                draft[c + j] = toks[c + j - 1]
        c += span
    # one mismatch for certain: the first draft row proposes another token
    r0 = int(np.flatnonzero(is_draft)[0])
    draft[r0] = (toks[r0 - 1] + 1) % 6
    slots = rng.permutation(28)[:w].astype(np.int32) + 4
    pools = [rng.randn(8, 2, 4, 4).astype(np.float32) for _ in range(4)]
    jk = [jnp.asarray(pools[0]), jnp.asarray(pools[1])]
    jv = [jnp.asarray(pools[2]), jnp.asarray(pools[3])]
    tk = [torch.from_numpy(pools[0].copy()), torch.from_numpy(pools[1].copy())]
    tv = [torch.from_numpy(pools[2].copy()), torch.from_numpy(pools[3].copy())]
    acc_j, jk, jv = JaxDecoder._spec_accept(
        None, jk, jv, jnp.asarray(toks), jnp.asarray(draft),
        jnp.asarray(slots), jnp.asarray(seg), jnp.asarray(is_draft), 0)
    acc_t, (tk,), (tv,) = PagedLlamaDecoder._spec_accept(
        None, [tk], [tv], torch.from_numpy(toks), torch.from_numpy(draft),
        torch.from_numpy(slots), torch.from_numpy(seg),
        torch.from_numpy(is_draft.astype(np.int32)), 0)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(acc_t.sum()) < int(is_draft.sum())
    for a, b in zip(jk + jv, tk + tv):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    del jc, tc


# -- streams ---------------------------------------------------------------------

@pytest.mark.parametrize("drafter", ["oracle", "adversarial", "ngram"])
def test_streams_equal_spec_off_and_jax(pair, drafter):
    """Whatever the drafter proposes, spec on gives spec off's greedy
    streams, and the port gives JAX's streams and counters."""
    jdec, tdec, _ = pair
    prompts = _motifs(2) + _prompts((20,)) if drafter == "ngram" \
        else _prompts((12, 20, 30))
    off = _run(_engine(tdec), prompts)
    if drafter == "oracle":
        mk = lambda base: SpecConfig(  # noqa: E731
            draft_len=6, drafter=_oracle(base, zip(prompts, off)))
        jspec = JaxSpec(draft_len=6,
                        drafter=_oracle(JaxDrafter, zip(prompts, off)))
    elif drafter == "adversarial":
        mk = lambda base: SpecConfig(drafter=_wrong(base))  # noqa: E731
        jspec = JaxSpec(drafter=_wrong(JaxDrafter))
    else:
        mk = lambda base: SpecConfig(draft_len=8)  # noqa: E731
        jspec = JaxSpec(draft_len=8)
    eng = _engine(tdec, mk(Drafter))
    got = _run(eng, prompts)
    want, jst = _jax_run(jdec, jspec, prompts)
    assert got == off == want
    st = eng.stats()
    for key in SPEC_COUNTERS:
        assert st[key] == pytest.approx(jst[key], abs=1e-12), key
    assert st["drafted_tokens"] > 0
    if drafter == "oracle":
        assert st["accepted_draft_tokens"] == st["drafted_tokens"]
        assert st["spec_rollbacks"] == 0
    elif drafter == "adversarial":
        assert st["accepted_draft_tokens"] == 0 and st["spec_rollbacks"] > 0
    else:
        assert st["accepted_draft_tokens"] > 0
        assert st["device_dispatches"] < eng.stats()["generated_tokens"]
    tdec.cache.debug_check()


@pytest.mark.parametrize("case", ["chunked_prefill", "prefix_splice",
                                  "eos_in_window", "preemption"])
def test_spec_keeps_spec_off_streams(pair, case):
    """Each edge case gives spec off's streams, and JAX's spec engine's
    streams and counters on the same traffic."""
    jdec, tdec, tree = pair
    spec = 6
    decs = (jdec, tdec)
    if case == "chunked_prefill":
        # a long prompt arrives while verify windows run: prefill rows
        # and draft rows share the verify ministeps
        shorts, longp = _motifs(2), _prompts((60,), seed=7)[0]
        kw = dict(prefill_chunk=16)

        def drive(eng):
            params = JaxParams if isinstance(eng, JaxEngine) \
                else SamplingParams
            rids = [eng.add_request(p, params(max_new_tokens=32))
                    for p in shorts]
            while eng.generated_tokens < 8:
                eng.step()
            rids.append(eng.add_request(longp, params(max_new_tokens=16)))
            eng.run_to_completion()
            return [eng.result(r).tolist() for r in rids]
    elif case == "prefix_splice":
        shared = _prompts((16,), seed=3)[0]
        prompts = [np.concatenate([shared, t]) for t in _motifs(2, seed=4)]
        kw = {}

        def drive(eng):
            out = _run(eng, prompts)
            assert eng.stats()["prefix_cache_hit_tokens"] > 0
            return out
    elif case == "eos_in_window":
        prompts = _motifs(1)
        ref = _run(_engine(tdec), prompts)[0]
        # a token first emitted past the first window: the stream runs
        # verify windows before it, and it cuts one
        eos = next(t for i, t in enumerate(ref) if i >= 8
                   and t not in ref[:i])
        sp = [dict(max_new_tokens=24, eos_token_id=eos)]
        spec, kw = 8, {}

        def drive(eng):
            return _run(eng, prompts, sampling=sp)
    else:
        tight = dict(num_blocks=14, block_size=8)
        decs = (JaxDecoder(None, _cfg=jdec.cfg, _weights=jdec.weights,
                           **tight),
                PagedLlamaDecoder.from_numpy_weights(
                    llama_tiny(), tree, device="cpu", **tight))
        prompts = _motifs(3)
        spec = 8
        kw = dict(max_batch_size=3, prefill_chunk=8, admission="optimistic")

        def drive(eng):
            out = _run(eng, prompts, new=48)
            eng.dec.cache.debug_check()
            return out
    if case == "preemption":
        off = drive(_engine(tdec, max_batch_size=3, prefill_chunk=8))
    else:
        off = drive(_engine(tdec, **kw))
    decs[0].cache.clear_prefix_cache()
    decs[0].cache.reset_prefix_stats()
    jeng = JaxEngine(decs[0], ragged=True, overlap=False,
                     spec_decode=JaxSpec(draft_len=spec), **dict(ENGINE, **kw))
    want = drive(jeng)
    eng = _engine(decs[1], SpecConfig(draft_len=spec), **kw)
    on = drive(eng)
    assert on == off == want
    st, jst = eng.stats(), jeng.stats()
    for key in SPEC_COUNTERS + ("preemptions", "prefix_cache_hit_tokens"):
        assert st[key] == pytest.approx(jst[key], abs=1e-12), key
    assert st["drafted_tokens"] > 0
    if case == "eos_in_window":
        assert on[0][-1] == eos and len(on[0]) < 24
    if case == "preemption":
        assert st["preemptions"] > 0


def test_rich_request_pauses_spec(pair):
    """A rich request in the slots pauses drafting; the streams equal
    spec off's (top_k 1 keeps the rich row deterministic)."""
    _, tdec, _ = pair
    prompts = _motifs(2)
    sp = [dict(max_new_tokens=24),
          dict(max_new_tokens=24, temperature=1.0, top_k=1)]

    def run(s):
        eng = _engine(tdec, s)
        return _run(eng, prompts, sampling=sp), eng.stats()

    (off, _), (on, st) = run(None), run(SpecConfig(draft_len=6))
    assert on == off
    assert st["drafted_tokens"] == 0


def test_stochastic_column_keeps_sampling(pair):
    """A temperature-1.0 column beside a drafted greedy column rides the
    verify ministep as a one-row window and keeps sampling: both
    columns, and the counters, equal JAX's spec engine's; the greedy
    column keeps spec off's stream."""
    jdec, tdec, _ = pair
    prompts = _motifs(2)
    sp = [dict(max_new_tokens=32), dict(max_new_tokens=32, temperature=1.0)]
    off = _run(_engine(tdec), prompts, new=32)
    eng = _engine(tdec, SpecConfig(draft_len=6))
    out = _run(eng, prompts, sampling=sp)
    want, jst = _jax_run(jdec, JaxSpec(draft_len=6), prompts, sampling=sp)
    st = eng.stats()
    assert st["drafted_tokens"] > 0
    assert out == want
    for key in SPEC_COUNTERS:
        assert st[key] == pytest.approx(jst[key], abs=1e-12), key
    assert out[0] == off[0] and out[1] != off[1]


def test_sealed_grid_and_counter_reset(pair):
    """warmup_programs covers the verify widths: spec traffic after
    seal_programs compiles nothing; clear_finished zeroes the spec
    counters."""
    _, tdec, _ = pair
    eng = _engine(tdec, SpecConfig(draft_len=3), prefill_chunk=8,
                  ragged_idle_cap=8, max_batch_size=2)
    eng.warmup_programs()
    eng.seal_programs()
    assert eng.compile_watch.seen("spec", (16, False))
    _run(eng, _motifs(2), new=16)
    st = eng.stats()
    assert st["unexpected_recompiles"] == 0 and st["drafted_tokens"] > 0
    eng.clear_finished()
    st = eng.stats()
    for key in ("drafted_tokens", "accepted_draft_tokens", "spec_rollbacks",
                "draft_acceptance_ema"):
        assert st[key] == 0


def test_tp2_identity(pair):
    """tests/test_spec_decode.py:351: spec decode at tp 2 gives the
    spec-off streams of tp 1 and JAX's tp-2 spec engine's streams and
    counters, with drafts accepted."""
    _, tdec1, _ = pair
    jdec, tdec = tp_pair(2, jax_tiny(), llama_tiny(), **POOL)
    prompts = _prompts((12, 20))
    off = _run(_engine(tdec1), prompts)
    jdec.cache.clear_prefix_cache()
    jeng = JaxEngine(jdec, ragged=True, overlap=False, tp=2,
                     spec_decode=JaxSpec(draft_len=6, drafter=_oracle(
                         JaxDrafter, zip(prompts, off))), **ENGINE)
    want = _run(jeng, prompts)
    eng = _engine(tdec, SpecConfig(draft_len=6, drafter=_oracle(
        Drafter, zip(prompts, off))), tp=2)
    got = _run(eng, prompts)
    assert got == off == want
    st, jst = eng.stats(), jeng.stats()
    for key in SPEC_COUNTERS:
        assert st[key] == pytest.approx(jst[key], abs=1e-12), key
    assert st["accepted_draft_tokens"] > 0 and st["tp"] == 2
