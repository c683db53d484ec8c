"""Multi-step fused decode windows (``ServingEngine(multi_step=k)``) in
the port against the JAX package.

The workloads of tests/test_multi_step.py, but the GPT twin: the flag
checks; greedy streams under k in {2, 4} equal
JAX's ``multi_step`` engine and the port's k = 1, with a mid-stream
arrival, a prefix splice, adapter rows and preemption at a window's
boundary; EOS inside a window (the column frozen, the tail counted in
``ms_frozen_token_waste``) and on the boundary; cancel and deadline at
the boundary; a rich window, stochastic too, token-identical to JAX; a
sealed grid with no cold key; the counters; tp 2 (k = 4 against k = 1
at tp 2, JAX's tp-2 windows and the port's tp 1). ``llama_tiny`` float32 on
one torch thread, the JAX decoder's seeded weights carried over by
``weights_from_numpy``; the port's ragged engine collects within its
step, so it is held against JAX's with ``overlap=False``. Every
comparison of streams is exact (token for token).
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
from paddle_tpu_torch.inference.lora import AdapterRegistry  # noqa: E402
from paddle_tpu_torch.inference.spec_decode import SpecConfig  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from _torch_serving_cases import tp_pair  # noqa: E402

POOL = dict(num_blocks=64, block_size=8)
VOCAB = 512
# tests/test_multi_step.py _engine
ENGINE = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              prefill_chunk=8)


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


def _prompts(n=4, seed=0, lens=(12, 9, 17, 21, 7, 14)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, ln).astype(np.int32) for ln in lens[:n]]


def _engine(dec, k, **kw):
    return ServingEngine(dec, multi_step=k, ragged=True,
                         **dict(ENGINE, **kw))


def _serve(eng, specs, late=None, steps=3):
    """Serve specs [(prompt, SamplingParams kwargs)] on either package's
    engine; ``late`` arrives after ``steps`` steps. Returns the
    streams."""
    params = JaxParams if isinstance(eng, JaxEngine) else SamplingParams
    rids = [eng.add_request(p, params(**sp)) for p, sp in specs]
    if late is not None:
        for _ in range(steps):
            eng.step()
        rids.append(eng.add_request(late[0], params(**late[1])))
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _jax_engine(jdec, k, **kw):
    jdec.cache.clear_prefix_cache()
    return JaxEngine(jdec, multi_step=k, ragged=True, overlap=False,
                     **dict(ENGINE, **kw))


def _greedy(prompts, new=14, **kw):
    return [(p, dict(max_new_tokens=new, **kw)) for p in prompts]


# -- the flag --------------------------------------------------------------------

def test_flag_checks(pair):
    _, tdec, _ = pair
    with pytest.raises(ValueError, match="multi_step"):
        _engine(tdec, 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(tdec, 4, spec_decode=SpecConfig(draft_len=2))
    eng = ServingEngine(tdec, multi_step=4, ragged=False, **ENGINE)
    assert eng.ragged is True and eng.multi_step == 4
    fams = eng.compile_watch.families
    assert "ragged_ms" in fams
    assert "ragged_ms" not in _engine(tdec, 1).compile_watch.families


# -- streams against JAX and k = 1 -----------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_streams_equal_jax_and_k1(pair, k):
    """Mixed lengths, chunked prefill, one mid-stream arrival (which
    drops the engine back to single steps until its prefill drains)."""
    jdec, tdec, _ = pair
    specs = _greedy(_prompts(3), 12)
    late = (_prompts(4, seed=5)[3], dict(max_new_tokens=9))
    want = _serve(_jax_engine(jdec, k), specs, late)
    eng = _engine(tdec, k)
    got = _serve(eng, specs, late)
    one = _engine(tdec, 1)
    assert got == want == _serve(one, specs, late)
    st, s1 = eng.stats(), one.stats()
    assert st["multi_step_windows"] >= 1
    assert st["device_dispatches"] < s1["device_dispatches"]
    tdec.cache.debug_check()


@pytest.mark.parametrize("k", [2, 4])
def test_rich_window_stochastic_equals_jax(pair, k):
    """A window carrying a rich stochastic row (T 0.8, top_p 0.9), a
    repetition-penalty row and a plain sampled row: the same tokens as
    JAX's multi_step engine on the same seed (the window's keys are
    split(next_key, k * T))."""
    jdec, tdec, _ = pair
    ps = _prompts(3, seed=2)
    specs = [(ps[0], dict(max_new_tokens=12, temperature=0.8, top_p=0.9)),
             (ps[1], dict(max_new_tokens=12, repetition_penalty=1.3)),
             (ps[2], dict(max_new_tokens=12, temperature=1.0))]
    want = _serve(_jax_engine(jdec, k, seed=3), specs)
    eng = _engine(tdec, k, seed=3)
    assert _serve(eng, specs) == want
    assert eng.stats()["multi_step_windows"] >= 1


def test_eos_mid_window_equals_jax(pair):
    """An EOS id that fires in the middle of a stream: the port, JAX's
    k = 4 engine and the port's k = 1 agree, and the frozen tail is
    counted as JAX counts it."""
    jdec, tdec, _ = pair
    prompts = _prompts(3)
    probe = _serve(_engine(tdec, 1), _greedy(prompts, 16))
    eos = int(probe[0][8])
    specs = _greedy(prompts, 16, eos_token_id=eos)
    jeng = _jax_engine(jdec, 4)
    want = _serve(jeng, specs)
    eng = _engine(tdec, 4)
    got = _serve(eng, specs)
    one = _engine(tdec, 1)
    assert got == want == _serve(one, specs)
    assert any(o[-1] == eos and len(o) < 16 for o in got)
    st, jst = eng.stats(), jeng.stats()
    for key in ("ms_frozen_token_waste", "multi_step_windows",
                "generated_tokens", "decode_steps"):
        assert st[key] == jst[key], key
    assert 1 <= st["ms_frozen_token_waste"] <= st["padded_token_waste"]
    assert one.stats()["ms_frozen_token_waste"] == 0


def test_eos_on_window_boundary_no_waste(pair):
    """Budgets an exact multiple of the window and no EOS: every
    scheduled ministep delivers."""
    _, tdec, _ = pair
    eng = _engine(tdec, 4, chunk_size=2)
    _serve(eng, _greedy(_prompts(2, lens=(9, 11)), 16))
    st = eng.stats()
    assert st["multi_step_windows"] >= 1
    assert st["ms_frozen_token_waste"] == 0


@pytest.mark.parametrize("case", ["prefix", "lora", "preemption"])
def test_k4_equals_k1(pair, case):
    """A prefix-splice workload, adapter rows (the pages gathered once
    per window) and a pool tight enough to preempt at a window's
    boundary: k = 4 gives k = 1's streams."""
    _, tdec, tree = pair
    if case == "prefix":
        base = _prompts(1, seed=3, lens=(24,))[0]
        specs = _greedy([base, np.concatenate([base, [5, 7]]),
                         np.concatenate([base, [11]])], 10)

        def leg(k):
            eng = _engine(tdec, k, prompt_buckets=(16, 32, 64))
            return _serve(eng, specs), eng.stats()["prefix_cache_hit_tokens"]

        (t1, h1), (t4, h4) = leg(1), leg(4)
        assert t4 == t1 and h4 == h1 > 0
        return
    if case == "lora":
        specs = [(p, dict(max_new_tokens=14, adapter_id=a))
                 for p, a in zip(_prompts(3), ["t0", None, "t0"])]

        def leg(k):
            dec = PagedLlamaDecoder.from_numpy_weights(
                llama_tiny(), tree, device="cpu", **POOL)
            reg = AdapterRegistry(rank=2)
            reg.register_random("t0", seed=5, scale=0.2)
            eng = _engine(dec, k, lora=reg)
            return _serve(eng, specs), eng.stats()

        (t1, _), (t4, s4) = leg(1), leg(4)
        assert t4 == t1 and s4["multi_step_windows"] >= 1
        return
    tight = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, device="cpu", num_blocks=14, block_size=4)

    def leg(k):
        eng = _engine(tight, k, admission="optimistic")
        out = _serve(eng, _greedy(_prompts(3, lens=(9, 11, 8)), 16))
        tight.cache.debug_check()
        return out, eng.stats()["preemptions"]

    (t1, _), (t4, p4) = leg(1), leg(4)
    assert t4 == t1 and p4 >= 1


# -- the window's boundary -------------------------------------------------------

def test_cancel_takes_effect_at_the_boundary(pair):
    """A cancel between steps, after one 16-ministep window: the victim
    is aborted with its partial tokens, the survivors equal an
    undisturbed k = 1 run of their own."""
    _, tdec, _ = pair
    prompts = _prompts(3)
    eng = _engine(tdec, 4)
    rids = [eng.add_request(p, SamplingParams(max_new_tokens=40))
            for p in prompts]
    for _ in range(2):          # the prefill, then one window
        eng.step()
    assert len(eng._find_request(rids[1]).out_tokens) == 17
    assert eng.cancel(rids[1]) is True
    eng.run_to_completion()
    assert eng.request(rids[1]).state == "aborted"
    assert len(eng.result(rids[1])) < 40
    clean = _serve(_engine(tdec, 1), _greedy([prompts[0], prompts[2]], 40))
    assert [eng.result(rids[0]).tolist(),
            eng.result(rids[2]).tolist()] == clean
    assert eng.stats()["aborted"] == 1


def test_deadline_at_the_boundary(pair):
    _, tdec, _ = pair
    eng = _engine(tdec, 4)
    rid = eng.add_request(_prompts(1)[0], SamplingParams(
        max_new_tokens=30, deadline_s=1e-9))
    eng.run_to_completion()
    assert eng.stats()["deadline_misses"] == 1
    assert len(eng.result(rid)) < 30


# -- the sealed grid and the counters --------------------------------------------

def test_sealed_grid_has_no_cold_key(pair):
    """warmup_programs + seal_programs, then fused traffic with a
    mid-stream arrival, EOS cuts and a rich stochastic row: no program
    key is first seen after the seal."""
    _, tdec, _ = pair
    eng = _engine(tdec, 4, ragged_idle_cap=8)
    eng.warmup_programs()
    eng.seal_programs()
    assert eng.compile_watch.seen("ragged_ms", (16, 4, True, True))
    specs = _greedy(_prompts(3), 12, eos_token_id=3)
    specs[2] = (specs[2][0], dict(max_new_tokens=12, temperature=0.8,
                                  top_p=0.9))
    _serve(eng, specs, late=(_prompts(4, seed=9)[3],
                             dict(max_new_tokens=7)))
    st = eng.stats()
    assert st["programs_sealed"] is True
    assert st["unexpected_recompiles"] == 0
    assert st["multi_step_windows"] >= 1


def test_counters_and_reset(pair):
    _, tdec, _ = pair
    eng = _engine(tdec, 4, chunk_size=2)
    _serve(eng, _greedy(_prompts(2, lens=(9, 11)), 16))
    one = _engine(tdec, 1, chunk_size=2)
    _serve(one, _greedy(_prompts(2, lens=(9, 11)), 16))
    st, s1 = eng.stats(), one.stats()
    assert st["multi_step_k"] == 4.0 and s1["multi_step_k"] == 1.0
    assert st["generated_tokens"] == s1["generated_tokens"]
    assert st["tokens_per_dispatch"] > s1["tokens_per_dispatch"]
    assert st["decode_steps"] >= 16
    eng.clear_finished()
    st = eng.stats()
    assert st["multi_step_windows"] == 0
    assert st["ms_frozen_token_waste"] == 0
    assert st["multi_step_k"] == 4.0


def test_tp2(pair):
    """tests/test_multi_step.py:183: fused windows at tp 2 give the tp-2
    k = 1 engine's streams, JAX's tp-2 window engine's and the port's
    tp 1's."""
    _, tdec1, _ = pair
    jdec, tdec = tp_pair(2, jax_tiny(), llama_tiny(), **POOL)
    specs = _greedy(_prompts(3), 10)
    want = _serve(_jax_engine(jdec, 4, tp=2), specs)
    got = _serve(_engine(tdec, 4, tp=2), specs)
    assert got == want
    assert got == _serve(_engine(tdec, 1, tp=2), specs) \
        == _serve(_engine(tdec1, 1), specs)
