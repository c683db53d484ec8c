"""The port's ragged ``ServingEngine`` against the JAX
``ServingEngine(ragged=True)`` on the same weights.

The JAX decoder is ``PagedLlamaDecoder.from_config(llama_tiny(), ...)``
(float32); its weights are carried into the port through
``weights_from_numpy``. Greedy outputs must be TOKEN-IDENTICAL on the
``TestRaggedEngine`` workloads of tests/test_ragged_batching.py (mixed
lengths, a chunked long prompt, EOS mid-chunk) and on the mixed-length
workload with int4 weights. Should a near-tie ever flip a token, the
failure message carries the port's logit gap between the two tokens at
the first divergence. Also: temperature <= 0 is greedy beside sampled
rows, one seed gives one stochastic stream, and the pool invariant holds
after every step. Both engines run with their default prefix caching
on.
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
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from _torch_serving_cases import assert_identical, prompts  # noqa: E402

ENGINE = dict(max_batch_size=3, chunk_size=4, prefill_chunk=8)
POOL = dict(num_blocks=96, block_size=8)


def _decoders(weight_dtype):
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0,
                                  weight_dtype=weight_dtype, **POOL)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, weight_dtype=weight_dtype, device="cpu", **POOL)
    return jdec, tdec


@pytest.fixture(scope="module")
def fp32_pair():
    return _decoders(None)


def _run_jax(jdec, reqs, **kw):
    eng = JaxEngine(jdec, prompt_buckets=(8, 16, 32, 64), ragged=True,
                    **{**ENGINE, **kw})
    rids = [eng.add_request(p, JaxParams(**sp)) for p, sp in reqs]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _run_port(tdec, reqs, **kw):
    eng = ServingEngine(tdec, ragged=True, **{**ENGINE, **kw})
    rids = [eng.add_request(p, SamplingParams(**sp)) for p, sp in reqs]
    while eng.step():
        tdec.cache.debug_check()
    tdec.cache.debug_check()
    st = eng.stats()
    assert st["finished"] == len(reqs)
    # everything but the scratch page is back in the pool: free, or
    # parked in the prefix cache (caching is on, as in the JAX engine)
    assert st["free_blocks"] + st["cached_blocks"] \
        == tdec.cache.num_blocks - 1
    return [eng.result(r).tolist() for r in rids], st


def _mixed(rng):
    lens = ((5, 10), (12, 8), (30, 12), (9, 6), (17, 10))
    return [(p, dict(max_new_tokens=m))
            for p, (_, m) in zip(prompts(rng, [n for n, _ in lens]), lens)]


def test_greedy_identity_mixed_lengths(fp32_pair):
    jdec, tdec = fp32_pair
    reqs = _mixed(np.random.RandomState(17))
    port, st = _run_port(tdec, reqs)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs))
    assert st["generated_tokens"] == sum(len(o) for o in port)
    assert st["tokens_per_dispatch"] > 1.0


def test_greedy_identity_chunked_long_prompt(fp32_pair):
    jdec, tdec = fp32_pair
    rng = np.random.RandomState(17)
    p1, p2 = prompts(rng, (60, 6))
    reqs = [(p1, dict(max_new_tokens=8)), (p2, dict(max_new_tokens=16))]
    port, _ = _run_port(tdec, reqs)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs))


def test_greedy_identity_eos_mid_chunk(fp32_pair):
    jdec, tdec = fp32_pair
    rng = np.random.RandomState(17)
    p, p2 = prompts(rng, (10, 7))
    stream = _run_jax(jdec, [(p, dict(max_new_tokens=12))])[0]
    eos = stream[len(stream) // 2]
    reqs = [(p, dict(max_new_tokens=12, eos_token_id=eos)),
            (p2, dict(max_new_tokens=12))]
    port, _ = _run_port(tdec, reqs)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs))
    assert port[0][-1] == eos and len(port[0]) < 12


def test_greedy_identity_chunk_schedule(fp32_pair):
    """Several ministep rungs: _pick_chunk chooses T per step as the JAX
    engine does, and the streams stay identical."""
    jdec, tdec = fp32_pair
    reqs = _mixed(np.random.RandomState(19))
    kw = dict(chunk_schedule=(1, 2, 4))
    port, _ = _run_port(tdec, reqs, **kw)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **kw))


def test_greedy_identity_int4_weights():
    jdec, tdec = _decoders("int4")
    reqs = _mixed(np.random.RandomState(23))
    port, _ = _run_port(tdec, reqs)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs))


def test_temperature_zero_is_greedy_beside_sampled_rows(fp32_pair):
    _, tdec = fp32_pair
    reqs = _mixed(np.random.RandomState(31))[:3]
    greedy, _ = _run_port(tdec, reqs)
    mixed = [(p, dict(sp, temperature=0.0)) for p, sp in reqs] \
        + [(reqs[0][0], dict(max_new_tokens=10, temperature=0.9))]
    out, _ = _run_port(tdec, mixed, max_batch_size=4)
    assert out[:3] == greedy


def test_top_k_one_samples_the_argmax(fp32_pair):
    _, tdec = fp32_pair
    reqs = _mixed(np.random.RandomState(41))[:3]
    greedy, _ = _run_port(tdec, reqs)
    hot = [(p, dict(sp, temperature=1.5)) for p, sp in reqs]
    out, _ = _run_port(tdec, hot, top_k=1, seed=3)
    assert out == greedy


def test_seeded_stochastic_stream(fp32_pair):
    _, tdec = fp32_pair
    reqs = [(p, dict(sp, temperature=0.8))
            for p, sp in _mixed(np.random.RandomState(37))[:3]]
    a, _ = _run_port(tdec, reqs, seed=7)
    b, _ = _run_port(tdec, reqs, seed=7)
    c, _ = _run_port(tdec, reqs, seed=8)
    assert a == b
    assert a != c
    assert all(0 <= t < 512 for o in a for t in o)


def test_engine_contract(fp32_pair):
    _, tdec = fp32_pair
    eng = ServingEngine(tdec, ragged=True, **ENGINE)
    with pytest.raises(ValueError):
        eng.add_request([])
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=10_000))
    rid = eng.add_request(np.arange(5), SamplingParams(max_new_tokens=3))
    out = eng.run_to_completion()
    assert list(out) == [rid] and len(out[rid]) == 3
    eng.close()
    eng.close()
    with pytest.raises(RuntimeError):
        eng.add_request([1, 2])
