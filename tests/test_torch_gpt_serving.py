"""The port's ``ServingEngine`` over ``PagedGPTDecoder`` against the JAX
package's GPT engine, on the CPU.

Each case comes from a JAX GPT twin case and holds the port's greedy
streams to JAX's token for token (exact): the ragged and dense
schedulers (tests/test_ragged_batching.py), chunked prefill
(test_chunked_prefill.py), prefix caching on and off
(test_prefix_cache.py), preemption with recompute on a tight pool
(test_fault_tolerance.py), an int8 KV pool (test_kv_quant.py),
``multi_step`` windows (test_multi_step.py), speculative decoding
(test_spec_decode.py), a LoRA tenant beside a base row
(test_lora_serving.py), tp 2 and the GPT tensor-parallel vocabulary
(test_tp_serving.py) and a sealed engine (test_program_observatory.py).
``gpt_tiny`` float32 on one torch thread; JAX's seeded model is served
by its ``PagedGPTDecoder`` and the decoder's ``weights`` tree carried
into the port by ``from_numpy_weights``. The port's ragged engine
collects within its step, so it is held against JAX's ragged engine
with ``overlap=False``; JAX's decoders are shared across its engines,
so each JAX engine's prefix index is cleared first.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.inference import AdapterRegistry as JaxRegistry  # noqa: E402
from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.gpt_decode import \
    PagedGPTDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.inference.spec_decode import \
    SpecConfig as JaxSpec  # noqa: E402
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT  # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch.distributed import ProcessMesh  # noqa: E402
from paddle_tpu_torch.distributed.spec_layout import \
    CANONICAL_SPECS  # noqa: E402
from paddle_tpu_torch.inference import (AdapterRegistry,  # noqa: E402
                                        PagedGPTDecoder, SamplingParams,
                                        ServingEngine, SpecConfig)
from paddle_tpu_torch.inference.gpt_decode import _split_qkv  # noqa: E402
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny  # noqa: E402
from _torch_serving_cases import assert_identical  # noqa: E402

VOCAB = 512
ENGINE = dict(max_batch_size=3, prompt_buckets=(8, 16, 32), chunk_size=4,
              prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmodel():
    paddle.seed(0)
    m = JaxGPT(jax_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def pair(jmodel):
    """JAX's decoder (64 blocks of 8) and the port's twin over its
    tree."""
    jdec = JaxDecoder(jmodel, num_blocks=64, block_size=8)
    return jdec, _twin(jdec, num_blocks=64)


def _twin(jdec, weight_dtype=None, **pool):
    tree = jax.tree.map(np.asarray, jdec.weights)
    return PagedGPTDecoder.from_numpy_weights(
        gpt_tiny(), tree, weight_dtype=weight_dtype, device="cpu",
        block_size=8, **pool)


def _prompts(lens, seed=0, lo=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, VOCAB, n).astype(np.int32) for n in lens]


def _serve(eng, prompts, max_new, aids=None):
    params = JaxParams if isinstance(eng, JaxEngine) else SamplingParams
    aids = aids or [None] * len(prompts)
    rids = [eng.add_request(p, params(max_new_tokens=max_new, adapter_id=a))
            for p, a in zip(prompts, aids)]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _jax(jdec, **kw):
    jdec.cache.clear_prefix_cache()
    if kw.get("ragged") or kw.get("multi_step", 1) > 1 \
            or kw.get("spec_decode") or kw.get("lora"):
        kw["overlap"] = False
    return JaxEngine(jdec, **kw)


def _both(jdec, tdec, prompts, max_new, jkw=None, aids=None, **kw):
    """(port streams, JAX streams, port engine) of one workload; ``jkw``
    overrides JAX-only engine arguments."""
    want = _serve(_jax(jdec, **dict(kw, **(jkw or {}))), prompts, max_new,
                  aids)
    eng = ServingEngine(tdec, **kw)
    got = _serve(eng, prompts, max_new, aids)
    return got, want, eng


def _reqs(prompts, max_new):
    return [(p, max_new) for p in prompts]


# -- both schedulers ----------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_schedulers_equal_jax(pair, ragged):
    """test_ragged_batching.py::test_greedy_identity_gpt."""
    jdec, tdec = pair
    prompts = _prompts((5, 14, 28), seed=1)
    kw = dict(ENGINE, ragged=ragged)
    if not ragged:
        kw["prefix_caching"] = False
    got, want, eng = _both(jdec, tdec, prompts, 10, **kw)
    assert_identical(tdec, _reqs(prompts, 10), got, want)
    tdec.cache.debug_check()


@pytest.mark.parametrize("pc", [None, 8])
def test_chunked_prefill_equal_jax(pair, pc):
    """test_chunked_prefill.py::test_gpt_chunked_identity."""
    jdec, tdec = pair
    prompts = _prompts((42, 7, 23), seed=5)
    got, want, _ = _both(jdec, tdec, prompts, 5, max_batch_size=2,
                         prompt_buckets=(8, 16, 32, 64), chunk_size=4,
                         prefill_chunk=pc, prefix_caching=False)
    assert_identical(tdec, _reqs(prompts, 5), got, want)


@pytest.mark.parametrize("caching", [False, True])
def test_prefix_cache_equal_jax(pair, caching):
    """test_prefix_cache.py::test_gpt_on_off_identical (the suffix
    prefill over learned positions at an offset)."""
    jdec, tdec = pair
    rng = np.random.RandomState(2)
    shared = rng.randint(0, VOCAB, (16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, VOCAB, (int(rng.randint(3, 9)),)).astype(np.int32)])
        for _ in range(3)]
    prompts.append(rng.randint(0, VOCAB, (13,)).astype(np.int32))
    got, want, eng = _both(jdec, tdec, prompts, 5, max_batch_size=2,
                           prompt_buckets=(8, 16, 32), chunk_size=4,
                           prefix_caching=caching)
    assert_identical(tdec, _reqs(prompts, 5), got, want)
    assert (eng.stats()["prefix_cache_hit_tokens"] > 0) == caching
    tdec.cache.debug_check()


def test_preemption_recompute_equal_jax(jmodel):
    """test_fault_tolerance.py::test_gpt_preemption_recompute_token_
    identical: a pool of 8 blocks under optimistic admission preempts,
    and the recompute tail's padded positions are clamped."""
    prompts = _prompts((8, 8))
    kw = dict(max_batch_size=2, prompt_buckets=(8, 16, 32),
              admission="optimistic", retry_backoff_s=0.0)
    jdec = JaxDecoder(jmodel, num_blocks=8, block_size=8)
    tdec = _twin(jdec, num_blocks=8)
    got, want, eng = _both(jdec, tdec, prompts, 40, **kw)
    assert eng.stats()["preemptions"] >= 1
    assert_identical(tdec, _reqs(prompts, 40), got, want)


def test_int8_kv_equal_jax(jmodel):
    """test_kv_quant.py::test_gpt_twin: an int8 pool on the ragged
    engine."""
    jdec = JaxDecoder(jmodel, num_blocks=32, block_size=8, kv_quant="int8")
    tdec = _twin(jdec, num_blocks=32, kv_quant="int8")
    assert isinstance(tdec.cache.k[0][0], tuple)
    prompts = _prompts((9, 17))
    got, want, _ = _both(jdec, tdec, prompts, 12, ragged=True,
                         **dict(ENGINE, prompt_buckets=(16, 32)))
    assert_identical(tdec, _reqs(prompts, 12), got, want)


def test_multi_step_equal_jax(pair):
    """test_multi_step.py::test_gpt_twin: k = 4 windows against JAX's
    and the port's k = 1."""
    jdec, tdec = pair
    prompts = _prompts((12, 9, 17), lo=1)
    kw = dict(ENGINE, prompt_buckets=(16, 32), ragged=True)
    got, want, eng = _both(jdec, tdec, prompts, 10, multi_step=4, **kw)
    assert_identical(tdec, _reqs(prompts, 10), got, want)
    assert eng.stats()["multi_step_windows"] > 0
    assert _serve(ServingEngine(tdec, **kw), prompts, 10) == got


def test_spec_decode_equal_jax(pair):
    """test_spec_decode.py::test_gpt_twin: draft 6 against JAX's spec
    engine and spec off."""
    jdec, tdec = pair
    prompts = _prompts((12, 20))
    kw = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              ragged=True)
    want = _serve(_jax(jdec, spec_decode=JaxSpec(draft_len=6), **kw),
                  prompts, 32)
    eng = ServingEngine(tdec, spec_decode=SpecConfig(draft_len=6), **kw)
    got = _serve(eng, prompts, 32)
    assert_identical(tdec, _reqs(prompts, 32), got, want)
    assert got == _serve(ServingEngine(tdec, **kw), prompts, 32)
    assert eng.stats()["accepted_draft_tokens"] > 0


def test_lora_equal_jax(jmodel):
    """test_lora_serving.py::test_gpt_twin at gpt_tiny: an adapter row
    beside a base row, both against JAX's; the base row equals the
    registry-less engine's and the adapter row differs from it."""
    prompts = _prompts((9, 13), seed=1)
    aids = ["g0", None]
    kw = dict(max_batch_size=2, prompt_buckets=(16,), chunk_size=4,
              prefill_chunk=8, ragged=True)
    jreg = JaxRegistry(rank=2)
    jreg.register_random("g0", seed=9, scale=0.3)
    jdec = JaxDecoder(jmodel, num_blocks=48, block_size=8)
    want = _serve(_jax(jdec, lora=jreg, **kw), prompts, 8, aids)
    treg = AdapterRegistry(rank=2)
    treg.register_random("g0", seed=9, scale=0.3)
    tdec = _twin(jdec, num_blocks=48)
    got = _serve(ServingEngine(tdec, lora=treg, **kw), prompts, 8, aids)
    assert got == want
    assert treg.layout.module_names() == ("wq", "wk", "wv", "wo", "wi",
                                          "wf")
    base = _serve(ServingEngine(_twin(jdec, num_blocks=48), **kw), prompts,
                  8)
    assert got[1] == base[1] and got[0] != base[0]


# -- tensor parallelism -------------------------------------------------------

def test_tp_vocabulary_covered(jmodel):
    """test_tp_serving.py::test_gpt_tp_vocabulary_covered: every key of
    JAX's tp-split GPT tree and of the port's split tree has a canonical
    spec; the fused keys have none."""
    from paddle_tpu.inference.gpt_decode import _extract_gpt_weights
    keys = set()
    for lw in _extract_gpt_weights(jmodel, tp_split=True)["layers"]:
        keys |= set(lw)
    assert not keys - set(CANONICAL_SPECS)
    tdec = PagedGPTDecoder.from_config(gpt_tiny(), num_blocks=8,
                                       block_size=8, device="cpu")
    split = _split_qkv(tdec.weights[0])
    pkeys = set(split) - {"layers"}
    for lw in split["layers"]:
        pkeys |= set(lw)
    assert not pkeys - set(CANONICAL_SPECS)
    assert "wqkv" not in CANONICAL_SPECS and "bqkv" not in CANONICAL_SPECS
    assert CANONICAL_SPECS["bo"] == (None,) \
        and CANONICAL_SPECS["bf"] == (None,)


@pytest.mark.parametrize("wd", [None, "int4"])
def test_tp2_equal_jax(jmodel, wd):
    """test_tp_serving.py::test_gpt_twin_identity: JAX's tp-2 decoder on
    two virtual devices against the port's tp-2 decoder over its tree
    (int4 even/odd-interleaved, repacked at load), both against the
    port's tp 1."""
    from jax.sharding import Mesh
    jdec = JaxDecoder(jmodel, num_blocks=64, block_size=8,
                      mesh=Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                      tp_shard_map=True, weight_dtype=wd)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedGPTDecoder.from_numpy_weights(
        gpt_tiny(), tree, weight_dtype=wd, int4_layout="interleaved",
        mesh=ProcessMesh([0, 1], ["tp"], devices=["cpu"] * 2),
        tp_shard_map=True, num_blocks=64, block_size=8)
    assert len(tdec.weights) == 2 and len(tdec.cache.k) == 2
    assert tdec.weights[0]["layers"][0]["bqkv"].shape == (192,)
    prompts = _prompts((5, 14, 28), seed=1)
    kw = dict(ENGINE, ragged=True, tp=2)
    got, want, eng = _both(jdec, tdec, prompts, 10, **kw)
    assert eng.tp == 2
    assert_identical(tdec, _reqs(prompts, 10), got, want)
    one = PagedGPTDecoder.from_numpy_weights(
        gpt_tiny(), tree, weight_dtype=wd, int4_layout="interleaved",
        num_blocks=64, block_size=8, device="cpu")
    assert _serve(ServingEngine(one, **dict(ENGINE, ragged=True)), prompts,
                  10) == got


def test_lora_tp2_equal_jax(jmodel):
    """LoRA over GPT's six modules at tp 2 (``check_tp``, the replicated
    plane, each shard slicing its factors; the q / k / v deltas on the
    pieces of each shard's fused projection): an adapter row beside a
    base row, against JAX's tp-2 GPT decoder (its TP and LoRA mixins) on
    two virtual devices, with the same registry."""
    from jax.sharding import Mesh
    prompts = _prompts((9, 13), seed=1)
    aids = ["g0", None]
    kw = dict(max_batch_size=2, prompt_buckets=(16,), chunk_size=4,
              prefill_chunk=8, ragged=True, tp=2)
    jreg = JaxRegistry(rank=2)
    jreg.register_random("g0", seed=9, scale=0.3)
    jdec = JaxDecoder(jmodel, num_blocks=48, block_size=8,
                      mesh=Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                      tp_shard_map=True)
    want = _serve(_jax(jdec, lora=jreg, **kw), prompts, 8, aids)
    treg = AdapterRegistry(rank=2)
    treg.register_random("g0", seed=9, scale=0.3)
    tdec = PagedGPTDecoder.from_numpy_weights(
        gpt_tiny(), jax.tree.map(np.asarray, jdec.weights),
        mesh=ProcessMesh([0, 1], ["tp"], devices=["cpu"] * 2),
        tp_shard_map=True, num_blocks=48, block_size=8)
    assert len(tdec.weights) == 2
    got = _serve(ServingEngine(tdec, lora=treg, **kw), prompts, 8, aids)
    assert got == want
    base = _serve(_jax(jdec, **kw), prompts, 8)
    assert got[1] == base[1] and got[0] != base[0]


def test_prebuilt_decoder_checks(pair):
    """JAX's prebuilt-decoder refusals (serving.py:471-510), and a GPT
    model given directly is refused as in JAX, whose engine builds a
    Llama decoder from any model."""
    _, tdec = pair
    with pytest.raises(ValueError, match="tp degree"):
        ServingEngine(tdec, tp=2)
    with pytest.raises(ValueError, match="tp_comm"):
        ServingEngine(tdec, tp_comm="int8")
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(tdec, kv_quant="int8")
    with pytest.raises(ValueError, match="devices="):
        ServingEngine(tdec, devices=["cpu"])
    with pytest.raises(TypeError, match="PagedGPTDecoder"):
        ServingEngine(GPTForCausalLM(gpt_tiny(), device="cpu"),
                      device="cpu")
    with pytest.raises(ValueError, match="tp_shard_map"):
        PagedGPTDecoder.from_config(
            gpt_tiny(), mesh=ProcessMesh([0, 1], ["tp"],
                                         devices=["cpu"] * 2))


def test_engine_from_model_checks():
    """A GPT model reaches the engine through ``decoder_from_model``, the
    helper ``ServingEngine`` builds a Llama model's decoder with, so its
    tp / devices refusals hold for both families."""
    from paddle_tpu_torch.inference.serving import decoder_from_model
    from paddle_tpu_torch.inference.transport import engine_from_model
    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        engine_from_model(model, tp=2, devices=["cpu"])
    with pytest.raises(ValueError, match="requires tp > 1"):
        engine_from_model(model, devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        engine_from_model(model, tp=2, devices=["cpu"] * 2, device="cuda")
    with pytest.raises(TypeError, match="no paged decoder"):
        decoder_from_model(object())
    eng = engine_from_model(model, tp=2, devices=["cpu"] * 2, num_blocks=8,
                            block_size=8, **ENGINE)
    assert isinstance(eng.dec, PagedGPTDecoder) and eng.dec._tp == 2
    eng.close()


# -- sealed programs ----------------------------------------------------------

def test_sealed_engine(pair):
    """test_program_observatory.py::test_gpt_twin_seals: the whole grid
    captured then sealed, three requests, no unexpected recompile, the
    records name the GPT decoder; the streams equal JAX's unsealed
    engine's."""
    jdec, tdec = pair
    kw = dict(ENGINE, ragged=True, ragged_idle_cap=8)
    eng = ServingEngine(tdec, **kw)
    eng.warmup_programs()
    eng.seal_programs()
    prompts = [np.random.RandomState(s).randint(0, VOCAB, 12)
               .astype(np.int32) for s in range(3)]
    got = _serve(eng, prompts, 6)
    assert eng.stats()["unexpected_recompiles"] == 0
    assert eng.compile_watch.records[0]["decoder"] == "PagedGPTDecoder"
    want = _serve(_jax(jdec, **kw), prompts, 6)
    assert got == want
