"""Per-request sampling on JAX's key stream: the port's ``_sample`` and
``_sample_rich`` and both port engines against the JAX package.

The samplers get the same float32 logits, parameters and key as JAX's
``ServingEngine._sample`` / ``_sample_rich`` and must draw the same
tokens. The engines (llama_tiny, float32, the JAX decoder's seeded
weights carried over by ``weights_from_numpy``) run the workloads of
tests/test_serving.py ``TestPerRequestSampling``, the non-LoRA cases of
tests/test_lora_serving.py ``TestAllowedTokens``, tests/test_ragged_
batching.py ``test_rich_sampling_routes_and_is_deterministic`` and
tests/test_chunked_prefill.py ``test_solo_stochastic_identity``; every
stream, stochastic ones included, must be token-identical to the JAX
engine's for the same seed, on the dense scheduler and on the ragged
one, cold and after ``warmup()``. The port's ragged engine collects
every chunk within its step, so it is held against JAX's ragged engine
with ``overlap=False``. The JAX decoder's prefix index is cleared
before each JAX engine (the port's engine clears its own).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.utils import prng  # noqa: E402

POOL = dict(num_blocks=64, block_size=8)
VOCAB = 512
# tests/test_serving.py TestPerRequestSampling._engine
PER_REQUEST = dict(max_batch_size=2, prompt_buckets=(32,), chunk_size=4)
# tests/test_ragged_batching.py / test_chunked_prefill.py _engine
RAGGED = dict(max_batch_size=3, prompt_buckets=(8, 16, 32, 64),
              chunk_size=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models run as fast on one thread, and the suite's
    workers then do not oversubscribe the cores."""
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
    return jdec, tdec


def _run_both(pair, specs, ragged, warm=False, **kw):
    """Serve ``specs`` [(prompt, SamplingParams kwargs)] on JAX's engine
    and the port's with the same configuration; returns (jax streams,
    port streams, the port engine)."""
    jdec, tdec = pair
    kw = dict(kw, ragged=ragged)
    jdec.cache.clear_prefix_cache()
    overlap = kw.pop("overlap", True)
    # the port's ragged engine collects within the step: JAX's overlap=False
    jeng = JaxEngine(jdec, overlap=overlap and not ragged, **kw)
    teng = ServingEngine(tdec, overlap=overlap, **kw)
    outs = []
    for eng, params in ((jeng, JaxParams), (teng, SamplingParams)):
        if warm:
            eng.warmup()
        rids = [eng.add_request(p, params(**sp)) for p, sp in specs]
        eng.run_to_completion()
        outs.append([eng.result(r).tolist() for r in rids])
    jdec.cache.clear_prefix_cache()
    tdec.cache.debug_check()
    return outs[0], outs[1], teng


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)) \
        .astype(np.int32)


# -- the samplers ---------------------------------------------------------------
def _rich_case(rng, rows, vocab):
    return dict(
        logits=(rng.randn(rows, vocab) * 3).astype(np.float32),
        temp=rng.choice([0.0, 0.7, 1.0, 2.5], rows).astype(np.float32),
        top_ks=rng.choice([0, 1, 4, 50], rows).astype(np.int32),
        top_ps=rng.choice([1.0, 0.9, 0.5, 1e-9], rows).astype(np.float32),
        rep=rng.choice([1.0, 1.3, 2.0], rows).astype(np.float32),
        seen=rng.rand(rows, vocab) < 0.1,
        allowed=rng.rand(rows, vocab) < 0.8)


@pytest.mark.parametrize("seed", range(6))
def test_sample_rich_matches_jax(seed):
    c = _rich_case(np.random.RandomState(seed), 8, VOCAB)
    order = ("logits", "temp", None, "top_ks", "top_ps", "rep", "seen",
             "allowed")
    for s in range(4):
        jkey = jax.random.PRNGKey(100 * seed + s)
        want = JaxEngine._sample_rich(
            None, *[jkey if k is None else jnp.asarray(c[k]) for k in order])
        pkey = torch.from_numpy(prng.PRNGKey(100 * seed + s).view(np.int32))
        got = ServingEngine._sample_rich(
            None, *[pkey if k is None else torch.from_numpy(c[k])
                    for k in order], True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = ServingEngine._sample_rich(
            None, *[pkey if k is None else torch.from_numpy(c[k])
                    for k in order], False)
        np.testing.assert_array_equal(
            greedy.numpy()[c["temp"] <= 0], np.asarray(want)[c["temp"] <= 0])


@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_matches_jax(top_k):
    class Eng:
        pass
    eng = Eng()
    eng.top_k = top_k
    rng = np.random.RandomState(top_k)
    logits = (rng.randn(6, VOCAB) * 2).astype(np.float32)
    temp = np.array([0.0, 0.5, 1.0, 1.0, 3.0, 0.0], np.float32)
    for s in range(5):
        want = JaxEngine._sample(eng, jnp.asarray(logits),
                                 jnp.asarray(temp), jax.random.PRNGKey(s))
        got = ServingEngine._sample(
            eng, torch.from_numpy(logits), torch.from_numpy(temp),
            torch.from_numpy(prng.PRNGKey(s).view(np.int32)), True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the engines against JAX's (TestPerRequestSampling workloads) --------------
MIXED = [(_prompt(3, 5), dict(max_new_tokens=6)),
         (_prompt(4, 11), dict(max_new_tokens=6, temperature=1.0, top_k=4,
                               top_p=0.9, repetition_penalty=1.3)),
         (_prompt(5, 9), dict(max_new_tokens=8, temperature=0.8)),
         (_prompt(6, 7), dict(max_new_tokens=7, temperature=1.2,
                              top_p=0.8))]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_mixed_rich_and_plain_streams_equal_jax(pair, ragged, warm):
    want, got, eng = _run_both(pair, MIXED, ragged, warm=warm, seed=5,
                               **PER_REQUEST)
    assert got == want
    # the plain request is unaffected by the rich slot beside it
    alone, _, _ = _run_both(pair, MIXED[:1], ragged, **PER_REQUEST)
    assert got[0] == alone[0]
    assert eng.stats()["finished"] == len(MIXED)


@pytest.mark.parametrize("ragged", [False, True])
def test_topk1_and_tiny_topp_are_greedy(pair, ragged):
    p0, p1 = _prompt(0, 9), _prompt(1, 7)
    specs = [(p0, dict(max_new_tokens=8)),
             (p0, dict(max_new_tokens=8, temperature=5.0, top_k=1)),
             (p1, dict(max_new_tokens=6)),
             (p1, dict(max_new_tokens=6, temperature=3.0, top_p=1e-9))]
    want, got, _ = _run_both(pair, specs, ragged, **PER_REQUEST)
    assert got == want
    assert got[0] == got[1] and got[2] == got[3]


@pytest.mark.parametrize("ragged", [False, True])
def test_repetition_penalty_greedy_equals_jax(pair, ragged):
    specs = [(_prompt(2, 6), dict(max_new_tokens=10,
                                  repetition_penalty=1.7)),
             (_prompt(2, 6), dict(max_new_tokens=10))]
    want, got, _ = _run_both(pair, specs, ragged, **PER_REQUEST)
    assert got == want
    assert got[0] != got[1]      # the penalty moves the greedy stream


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_overlap_off_matches_on(pair, ragged, temperature):
    """Greedy streams do not depend on the pipeline; stochastic ones
    follow JAX's in either mode (the pipeline changes which chunk, and
    so which key, samples a token, in JAX as in the port)."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(0, VOCAB, (n,)).astype(np.int32),
              dict(max_new_tokens=m, temperature=temperature))
             for n, m in ((5, 9), (12, 4), (8, 7))]
    runs = [_run_both(pair, specs, ragged, overlap=ov, seed=2,
                      **PER_REQUEST) for ov in (True, False)]
    for want, got, _ in runs:
        assert got == want
    if temperature == 0.0:
        assert runs[0][1] == runs[1][1]


# -- allowed-token masks (TestAllowedTokens, non-LoRA) ---------------------------
@pytest.mark.parametrize("ragged", [True, False])
def test_all_ones_mask_changes_nothing(pair, ragged):
    prompts = [_prompt(10 + i, 6 + 3 * i) for i in range(2)]
    plain = [(p, dict(max_new_tokens=8, temperature=t))
             for p, t in zip(prompts, (0.0, 1.0))]
    masked = [(p, dict(sp, allowed_tokens=np.ones(VOCAB, bool)))
              for p, sp in plain]
    want, got, _ = _run_both(pair, masked, ragged, seed=1, **RAGGED)
    assert got == want
    _, base, eng = _run_both(pair, plain, ragged, seed=1, **RAGGED)
    assert got == base
    assert eng.stats()["masked_decode_columns"] == 0


@pytest.mark.parametrize("ragged", [True, False])
def test_constrained_streams_stay_inside_mask(pair, ragged):
    rng = np.random.RandomState(5)
    wide = rng.random_sample(VOCAB) < 0.25
    wide[7] = True
    narrow = np.zeros(VOCAB, bool)
    narrow[10:20] = True
    specs = [(_prompt(20, 9), dict(max_new_tokens=12, allowed_tokens=wide)),
             (_prompt(21, 5), dict(max_new_tokens=16, temperature=1.0,
                                   allowed_tokens=narrow)),
             (_prompt(22, 7), dict(max_new_tokens=8,
                                   allowed_tokens=np.arange(0, VOCAB, 2)))]
    want, got, eng = _run_both(pair, specs, ragged, seed=3, **RAGGED)
    assert got == want
    assert wide[got[0]].all() and narrow[got[1]].all()
    assert all(t % 2 == 0 for t in got[2])
    assert eng.stats()["masked_decode_columns"] >= 1
    with pytest.raises(ValueError, match="permits no token"):
        eng.add_request(_prompt(0, 4), SamplingParams(
            allowed_tokens=np.zeros(VOCAB, bool)))
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request(_prompt(0, 4), SamplingParams(
            allowed_tokens=[VOCAB + 5]))


# -- tests/test_ragged_batching.py:319 and test_chunked_prefill.py:94 ----------
@pytest.mark.parametrize("ragged", [True, False])
def test_rich_routes_and_seeded_stream(pair, ragged):
    p = _prompt(9, 9)
    specs = [(p, dict(max_new_tokens=8)),
             (p, dict(max_new_tokens=8, temperature=0.8, top_k=1)),
             (p, dict(max_new_tokens=8, temperature=0.9, top_k=4,
                      repetition_penalty=1.3))]
    want, got, _ = _run_both(pair, specs, ragged, seed=7, **RAGGED)
    assert got == want and got[0] == got[1]


@pytest.mark.parametrize("ragged", [True, False])
def test_solo_stochastic_chunked_equals_monolithic(pair, ragged):
    """A solo request draws no key for its mid chunks, so its stochastic
    stream is the same with chunked and monolithic prefill, and both
    are JAX's."""
    specs = [(_prompt(30, 50), dict(max_new_tokens=8, temperature=0.9,
                                    top_p=0.95))]
    outs = []
    for pc in (None, 8):
        kw = dict(RAGGED, max_batch_size=1, prefill_chunk=pc)
        want, got, _ = _run_both(pair, specs, ragged, **kw)
        assert got == want
        outs.append(got)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("ragged", [False, True])
def test_warmup_key_consumption(pair, ragged):
    """``warmup()`` draws from the engine key, one key per
    sampling-capable dispatch as JAX's does (the warm stream tests above
    hold the result token for token against JAX), and is not undone;
    ``warmup_programs()`` leaves the key alone."""
    _, tdec = pair
    eng = ServingEngine(tdec, ragged=ragged, **PER_REQUEST)
    eng.warmup_programs()
    np.testing.assert_array_equal(eng._key, prng.PRNGKey(0))
    eng.warmup()
    drawing = sum(n for (fam, _), n in eng.programs.dispatches.items()
                  if not fam.startswith("prefill_mid"))
    key = prng.PRNGKey(0)
    for _ in range(drawing):
        key = prng.split(key)[0]
    assert drawing > 0
    np.testing.assert_array_equal(eng._key, key)
    eng.close()
