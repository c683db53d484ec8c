"""The port's dense per-phase ``ServingEngine(ragged=False)`` against the
JAX ``ServingEngine(ragged=False, prefix_caching=False)`` on the same
weights.

The JAX decoder is ``PagedLlamaDecoder.from_config(llama_tiny(), ...)``
(float32) and its weights are carried into the port through
``weights_from_numpy``. Greedy outputs must be TOKEN-IDENTICAL on: the
mixed-length workload of tests/test_serving.py (TestServingEngine), the
long prompt admitted mid-stream of tests/test_chunked_prefill.py (mid
chunks, then a final at an offset), EOS mid-chunk, a chunk schedule,
overlap on and off (tests/test_serving.py), int4 weights, and an int8
KV pool (tests/test_kv_quant.py's dense identity workload). A failure
carries the port's logit gap between the two tokens at the first
divergence. Also: the constructor's default is the dense path, one seed
gives one stochastic stream, the pool invariant holds after every step,
and a prompt past the largest bucket or an unported sampling field is
refused on both paths.
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

# tests/test_serving.py TestServingEngine._engine
SERVING = dict(max_batch_size=2, prompt_buckets=(8, 16, 32))
# tests/test_chunked_prefill.py TestChunkedTokenIdentity._engine
CHUNKED = dict(max_batch_size=3, prompt_buckets=(8, 16, 32, 64),
               chunk_size=4, prefill_chunk=8)


def _decoders(weight_dtype=None, kv_quant=None, num_blocks=96):
    pool = dict(num_blocks=num_blocks, block_size=8, kv_quant=kv_quant)
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0,
                                  weight_dtype=weight_dtype, **pool)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, weight_dtype=weight_dtype, device="cpu", **pool)
    return jdec, tdec


@pytest.fixture(scope="module")
def fp32_pair():
    return _decoders()


def _drive(eng, reqs, params, late, check):
    rids = [eng.add_request(p, params(**sp)) for p, sp in reqs]
    if late:
        for _ in range(3):
            eng.step()
            check()
        rids += [eng.add_request(p, params(**sp)) for p, sp in late]
    while eng.step():
        check()
    check()
    return [eng.result(r).tolist() for r in rids]


def _run_jax(jdec, reqs, late=(), **kw):
    eng = JaxEngine(jdec, ragged=False, prefix_caching=False, **kw)
    return _drive(eng, reqs, JaxParams, late, lambda: None)


def _run_port(tdec, reqs, late=(), **kw):
    eng = ServingEngine(tdec, prefix_caching=False, **kw)
    assert eng.ragged is False
    out = _drive(eng, reqs, SamplingParams, late, tdec.cache.debug_check)
    st = eng.stats()
    assert st["finished"] == len(reqs) + len(late)
    # everything but the scratch page is back in the pool
    assert st["free_blocks"] == tdec.cache.num_blocks - 1
    assert st["generated_tokens"] == sum(len(o) for o in out)
    eng.close()
    return out, st


def _mixed(seed=42):
    """tests/test_serving.py TestServingEngine._prompts."""
    lens, news = [5, 12, 20, 9, 16], [6, 4, 8, 5, 3]
    return [(p, dict(max_new_tokens=m)) for p, m in
            zip(prompts(np.random.RandomState(seed), lens), news)]


def test_constructor_default_is_dense(fp32_pair):
    _, tdec = fp32_pair
    assert ServingEngine(tdec).ragged is False
    assert ServingEngine(tdec, ragged=True).ragged is True


def test_greedy_identity_mixed_lengths(fp32_pair):
    jdec, tdec = fp32_pair
    reqs = _mixed()
    port, st = _run_port(tdec, reqs, **SERVING)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **SERVING))
    assert [len(o) for o in port] == [6, 4, 8, 5, 3]
    assert st["decode_slot_steps"] >= st["decode_useful_tokens"] > 0
    assert 0 < st["decode_utilization"] <= 1
    assert st["device_dispatches"] > 0
    for k in ("time_prefill_s", "time_decode_stall_s", "time_host_s"):
        assert st[k] >= 0


def test_greedy_identity_long_prompt_mid_stream(fp32_pair):
    """tests/test_chunked_prefill.py: two short requests decode; a
    60-token prompt arrives after three steps and prefills through seven
    mid chunks and a final at an offset."""
    jdec, tdec = fp32_pair
    rng = np.random.RandomState(17)
    shorts = [(p, dict(max_new_tokens=24)) for p in prompts(rng, (6, 9))]
    late = [(prompts(rng, (60,))[0], dict(max_new_tokens=5))]
    calls = {"mid": 0, "offset_final": 0}
    impl_prefix = tdec._prefill_prefix_impl

    def count_prefix(*a, **k):
        calls["offset_final" if k.get("logits", True) else "mid"] += 1
        return impl_prefix(*a, **k)

    tdec._prefill_prefix_impl = count_prefix
    try:
        port, _ = _run_port(tdec, shorts, late, **CHUNKED)
    finally:
        del tdec._prefill_prefix_impl
    ref = _run_jax(jdec, shorts, late, **CHUNKED)
    assert_identical(tdec, shorts + late, port, ref)
    # the long prompt: mid chunk 0 runs _prefill_impl, mids 1..6 the
    # offset chunk program, its final is at offset 56; the 9-token short
    # prompt: one mid at offset 0, then a final at offset 8
    assert calls == {"mid": 6, "offset_final": 2}


def test_greedy_identity_eos_mid_chunk(fp32_pair):
    jdec, tdec = fp32_pair
    rng = np.random.RandomState(17)
    p, p2 = prompts(rng, (10, 7))
    kw = dict(max_batch_size=2, prompt_buckets=(8, 16), chunk_size=4)
    stream = _run_jax(jdec, [(p, dict(max_new_tokens=12))], **kw)[0]
    eos = stream[len(stream) // 2]
    reqs = [(p, dict(max_new_tokens=12, eos_token_id=eos)),
            (p2, dict(max_new_tokens=12))]
    port, _ = _run_port(tdec, reqs, **kw)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **kw))
    assert port[0][-1] == eos and len(port[0]) < 12


def test_greedy_identity_chunk_schedule(fp32_pair):
    jdec, tdec = fp32_pair
    reqs = _mixed(19)
    kw = dict(SERVING, chunk_schedule=(1, 2, 4))
    port, _ = _run_port(tdec, reqs, **kw)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **kw))


def test_greedy_identity_overlap_on_and_off(fp32_pair):
    """tests/test_serving.py test_overlap_off_matches_on, held against
    the JAX engine with overlap on."""
    jdec, tdec = fp32_pair
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 512, (n,)).astype(np.int32),
             dict(max_new_tokens=m)) for n, m in ((5, 9), (12, 4), (8, 7))]
    ref = _run_jax(jdec, reqs, **SERVING)
    for ov in (True, False):
        port, _ = _run_port(tdec, reqs, overlap=ov, **SERVING)
        assert_identical(tdec, reqs, port, ref)


def test_greedy_identity_int4_weights():
    jdec, tdec = _decoders("int4")
    reqs = _mixed(23)
    port, _ = _run_port(tdec, reqs, **SERVING)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **SERVING))


def test_greedy_identity_int8_kv_pool():
    """tests/test_kv_quant.py TestEngineAccuracy.test_dense_identity: the
    dense decode reads the int8 pool through the ragged oracle in both
    packages."""
    jdec, tdec = _decoders(kv_quant="int8", num_blocks=32)
    kw = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              prefill_chunk=8)
    reqs = [(p, dict(max_new_tokens=12))
            for p in prompts(np.random.RandomState(0), (9, 17, 30))]
    port, _ = _run_port(tdec, reqs, **kw)
    assert_identical(tdec, reqs, port, _run_jax(jdec, reqs, **kw))


def test_seeded_stochastic_stream(fp32_pair):
    _, tdec = fp32_pair
    reqs = [(p, dict(sp, temperature=0.8)) for p, sp in _mixed(37)[:3]]
    a, _ = _run_port(tdec, reqs, seed=7, **SERVING)
    b, _ = _run_port(tdec, reqs, seed=7, **SERVING)
    c, _ = _run_port(tdec, reqs, seed=8, **SERVING)
    assert a == b
    assert a != c
    assert all(0 <= t < 512 for o in a for t in o)
    # greedy rows beside sampled ones stay greedy
    greedy, _ = _run_port(tdec, _mixed(37)[:3], **SERVING)
    mixed = _mixed(37)[:3] + [(reqs[0][0], dict(max_new_tokens=6,
                                                temperature=0.9))]
    out, _ = _run_port(tdec, mixed, **dict(SERVING, max_batch_size=4))
    assert out[:3] == greedy


@pytest.mark.parametrize("ragged", [False, True])
def test_requests_refused_at_the_door(fp32_pair, ragged):
    _, tdec = fp32_pair
    eng = ServingEngine(tdec, ragged=ragged, **SERVING)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.add_request(np.arange(33) % 512)
    # an adapter needs the engine's AdapterRegistry, as in JAX; the
    # other per-request fields are served (and these requests cancelled)
    with pytest.raises(ValueError, match="no AdapterRegistry"):
        eng.add_request([1, 2, 3], SamplingParams(adapter_id="a"))
    for field, value in (("top_p", 0.9), ("repetition_penalty", 1.3),
                         ("deadline_s", 100.0), ("priority", 2),
                         ("top_k", 4), ("allowed_tokens", [3, 4])):
        assert eng.cancel(eng.add_request(
            [1, 2, 3], SamplingParams(**{field: value})))
    rid = eng.add_request(np.arange(32) % 512,
                          SamplingParams(max_new_tokens=3))
    out = eng.run_to_completion()
    assert len(out[rid]) == 3 and eng.request(rid).state == "done"
    assert eng.stats()["aborted"] == 6
    eng.close()
    with pytest.raises(RuntimeError):
        eng.add_request([1, 2])
