"""Fault-tolerant serving in the port, on both schedulers, against
tests/test_fault_tolerance.py (and the ragged cases of
tests/test_ragged_batching.py): deadlines, cancel, preemption with
recompute, bounded retry, overload shedding and the seeded chaos
monkey.

The property throughout: a fault touches only the faulted request.
Every other request finishes token-identical to a fault-free run of the
port, whose clean outputs equal the JAX engine's (llama_tiny, float32,
the JAX decoder's seeded weights carried over by ``weights_from_numpy``),
and the pool invariant holds after every step (``PADDLE_TPU_POOL_DEBUG=1``
makes the engine check it itself). The tight-pool int8 preemption case
is held against JAX's engine on the same int8 pools: the JAX test of
that case (tests/test_kv_quant.py, int8 against a float32 pool) is red
in the reference. The GPT twin's preemption case is
``tests/test_torch_gpt_serving.py::test_preemption_recompute_equal_jax``.
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
from paddle_tpu_torch.inference import (EngineOverloaded, PagedLlamaDecoder,
                                        SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import \
    KVCacheExhausted  # noqa: E402
from paddle_tpu_torch.utils.chaos import ChaosMonkey  # noqa: E402

SCHEDULERS = [pytest.param(False, id="dense"), pytest.param(True, id="ragged")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models run as fast on one thread, and the suite's
    workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pool_debug(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_POOL_DEBUG", "1")


@pytest.fixture(scope="module")
def weights():
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=64,
                                  block_size=8)
    return jdec, jax.tree.map(np.asarray, jdec.weights)


def _engine(weights, ragged, num_blocks=64, kv_quant=None, **kw):
    """An engine on a decoder of its own (a fault test may leave its
    pool in any state)."""
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("prompt_buckets", (8, 16, 32))
    kw.setdefault("retry_backoff_s", 0.0)
    dec = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), weights[1], num_blocks=num_blocks, block_size=8,
        kv_quant=kv_quant, device="cpu")
    eng = ServingEngine(dec, ragged=ragged, **kw)
    assert eng._debug_pool
    return eng


def _prompts(n=3, seed=42):
    rng = np.random.RandomState(seed)
    lens = [5, 12, 20, 9, 16][:n]
    news = [10, 8, 12, 6, 9][:n]
    return [(rng.randint(0, 512, (ln,)).astype(np.int32),
             SamplingParams(max_new_tokens=m)) for ln, m in zip(lens, news)]


def _clean(weights, ragged, reqs, **kw):
    eng = _engine(weights, ragged, **kw)
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


def _pool_whole(eng):
    cache = eng.dec.cache
    cache.debug_check()
    assert cache.free_blocks + cache.cached_blocks == cache.num_blocks - 1


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_clean_outputs_equal_jax(weights, ragged):
    reqs = _prompts(3)
    jdec = weights[0]
    jdec.cache.clear_prefix_cache()
    jeng = JaxEngine(jdec, max_batch_size=2, prompt_buckets=(8, 16, 32),
                     ragged=ragged, overlap=not ragged)
    rids = [jeng.add_request(p, JaxParams(max_new_tokens=s.max_new_tokens))
            for p, s in reqs]
    jeng.run_to_completion()
    jdec.cache.clear_prefix_cache()
    assert _clean(weights, ragged, reqs) \
        == [jeng.result(r).tolist() for r in rids]


# -- cancel ------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_queued(weights, ragged):
    eng = _engine(weights, ragged, max_batch_size=1)
    reqs = _prompts(3)
    rids = [eng.add_request(p, s) for p, s in reqs]
    assert eng.cancel(rids[2]) is True
    eng.run_to_completion()
    req = eng.request(rids[2])
    assert req.state == "aborted" and req.error == "cancelled"
    assert eng.result(rids[2]).size == 0
    clean = _clean(weights, ragged, reqs[:2], max_batch_size=1)
    assert [eng.result(r).tolist() for r in rids[:2]] == clean
    assert eng.stats()["aborted"] == 1


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_running_releases_pool(weights, ragged):
    eng = _engine(weights, ragged)
    reqs = [(p, SamplingParams(max_new_tokens=24)) for p, _ in _prompts(2)]
    rids = [eng.add_request(p, s) for p, s in reqs]
    for _ in range(3):
        eng.step()
    assert eng.cancel(rids[1]) is True
    eng.run_to_completion()
    req = eng.request(rids[1])
    assert req.state == "aborted" and req.t_done is not None
    assert 0 < len(req.out_tokens) < 24          # partial tokens kept
    assert eng.result(rids[0]).tolist() \
        == _clean(weights, ragged, reqs[:1])[0]
    _pool_whole(eng)


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_mid_chunked_prefill_unwinds(weights, ragged):
    eng = _engine(weights, ragged, prefill_chunk=8, prefill_budget=8,
                  prompt_buckets=(8, 32))
    long_p = np.random.RandomState(7).randint(0, 512, (29,)) \
        .astype(np.int32)
    rid = eng.add_request(long_p, SamplingParams(max_new_tokens=4))
    eng.step()
    assert eng.cancel(rid) is True
    while eng.step():
        pass
    assert eng.request(rid).state == "aborted"
    _pool_whole(eng)


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_terminal_and_unknown(weights, ragged):
    eng = _engine(weights, ragged)
    rid = eng.add_request(*_prompts(1)[0])
    eng.run_to_completion()
    assert eng.cancel(rid) is False
    with pytest.raises(KeyError):
        eng.cancel(12345)


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_splice_writer_restarts_reader(weights, ragged):
    """Cancelling a writer mid-prefill whose unwritten blocks a reader
    spliced restarts the reader, which still gets the clean tokens."""
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 512, (24,)).astype(np.int32)
    tailed = np.concatenate([shared, rng.randint(0, 512, (6,))
                             .astype(np.int32)])
    kw = dict(prefill_chunk=8, prompt_buckets=(8, 32), prefill_budget=8)
    eng = _engine(weights, ragged, **kw)
    w = eng.add_request(shared, SamplingParams(max_new_tokens=4))
    r = eng.add_request(tailed, SamplingParams(max_new_tokens=4))
    eng.step()
    eng.cancel(w)
    eng.run_to_completion()
    assert eng.request(w).state == "aborted"
    assert eng.request(r).state == "done"
    assert eng.result(r).tolist() == _clean(
        weights, ragged, [(tailed, SamplingParams(max_new_tokens=4))],
        **kw)[0]
    eng.dec.cache.debug_check()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_writer_with_chained_readers_no_double_restart(weights,
                                                             ragged):
    rng = np.random.RandomState(13)
    shared = rng.randint(0, 512, (16,)).astype(np.int32)
    full = np.concatenate([shared, rng.randint(0, 512, (16,))
                           .astype(np.int32)])
    kw = dict(max_batch_size=3, prefill_chunk=8, prefill_budget=1,
              prompt_buckets=(16, 32))
    eng = _engine(weights, ragged, **kw)
    w = eng.add_request(shared, SamplingParams(max_new_tokens=4))
    r1 = eng.add_request(full, SamplingParams(max_new_tokens=4))
    r2 = eng.add_request(full.copy(), SamplingParams(max_new_tokens=4))
    eng._admit()
    eng.cancel(w)
    ids = [q.req_id for q in eng._queue]
    assert len(ids) == len(set(ids)), ids
    eng.run_to_completion()
    clean = _clean(weights, ragged,
                   [(full, SamplingParams(max_new_tokens=4))], **kw)[0]
    assert eng.request(w).state == "aborted"
    assert eng.result(r1).tolist() == clean
    assert eng.result(r2).tolist() == clean
    eng.dec.cache.debug_check()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_cancel_splice_writer_with_decode_in_flight(weights, ragged):
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 512, (24,)).astype(np.int32)
    reader_p = np.concatenate([shared, rng.randint(0, 512, (6,))
                               .astype(np.int32)])
    decoy = rng.randint(0, 512, (8,)).astype(np.int32)
    kw = dict(max_batch_size=3, prefill_chunk=8, prefill_budget=8,
              prompt_buckets=(8, 32))
    eng = _engine(weights, ragged, **kw)
    a = eng.add_request(decoy, SamplingParams(max_new_tokens=30))
    for _ in range(3):
        eng.step()
    w = eng.add_request(shared, SamplingParams(max_new_tokens=4))
    r = eng.add_request(reader_p, SamplingParams(max_new_tokens=4))
    eng.step()
    eng.cancel(w)
    eng.run_to_completion()
    assert eng.request(w).state == "aborted"
    assert eng.request(a).state == "done"
    assert eng.result(r).tolist() == _clean(
        weights, ragged, [(reader_p, SamplingParams(max_new_tokens=4))],
        **kw)[0]
    eng.dec.cache.debug_check()


# -- deadlines and shedding ----------------------------------------------------------
@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_deadlines(weights, ragged):
    eng = _engine(weights, ragged)
    reqs = _prompts(3)
    ok = eng.add_request(*reqs[0])
    doomed = eng.add_request(reqs[1][0], SamplingParams(max_new_tokens=8,
                                                        deadline_s=1e-6))
    roomy = eng.add_request(reqs[2][0], SamplingParams(max_new_tokens=6,
                                                       deadline_s=300.0))
    eng.run_to_completion()
    assert eng.request(doomed).state == "aborted"
    assert "deadline" in eng.request(doomed).error
    assert eng.request(roomy).state == "done"
    st = eng.stats()
    assert st["deadline_misses"] == 1 and st["finished"] == 2
    assert st["aborted"] == 1
    assert eng.result(ok).tolist() == _clean(weights, ragged, reqs[:1])[0]


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_queue_depth_cap(weights, ragged):
    eng = _engine(weights, ragged, max_batch_size=1, max_queue_depth=1)
    reqs = _prompts(3)
    eng.add_request(*reqs[0])
    eng.step()
    eng.add_request(*reqs[1])
    with pytest.raises(EngineOverloaded):
        eng.add_request(*reqs[2])
    assert eng.stats()["shed_requests"] == 1
    eng.run_to_completion()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_deadline_math_sheds_infeasible_request(weights, ragged):
    eng = _engine(weights, ragged)
    reqs = _prompts(2)
    eng.add_request(*reqs[0])
    eng.run_to_completion()          # the engine has a token rate now
    with pytest.raises(EngineOverloaded):
        eng.add_request(reqs[1][0], SamplingParams(max_new_tokens=200,
                                                   deadline_s=1e-9))
    assert eng.stats()["shed_requests"] == 1
    rid = eng.add_request(reqs[1][0], SamplingParams(max_new_tokens=4))
    eng.run_to_completion()
    assert eng.request(rid).state == "done"


# -- dispatch and collection faults ----------------------------------------------------
def _flaky_family(eng, family, times, rich=None):
    """Make ``family``'s program raise its first ``times`` runs."""
    fn = eng.programs._fns[family]
    state = {"raised": 0}

    def flaky(key, *ops):
        if state["raised"] < times:
            state["raised"] += 1
            raise RuntimeError("transient device error (test)")
        return fn(key, *ops)

    eng.programs._fns[family] = flaky
    return state


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_failed_dispatch_fails_its_requests_alone(weights, ragged):
    reqs = _prompts(3)
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged, max_dispatch_retries=0)
    rids = [eng.add_request(p, s) for p, s in reqs]
    state = _flaky_family(eng, "ragged" if ragged else "prefill", 1)
    eng.run_to_completion()
    assert state["raised"] == 1
    failed = [r for r in rids if eng.request(r).state == "failed"]
    assert len(failed) >= 1
    assert "dispatch failed" in eng.request(failed[0]).error
    st = eng.stats()
    assert st["failed"] == len(failed) and st["dispatch_exhaustions"] == 1
    for rid, want in zip(rids, clean):
        if eng.request(rid).state == "done":
            assert eng.result(rid).tolist() == want
    _pool_whole(eng)


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_transient_fault_retried_token_identical(weights, ragged):
    """With retries left, a transient error is invisible: the same
    operands and keys run again. Sampled rows included."""
    reqs = _prompts(3)
    reqs[1] = (reqs[1][0], SamplingParams(max_new_tokens=8,
                                          temperature=0.9, top_p=0.9))
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged, max_dispatch_retries=2)
    rids = [eng.add_request(p, s) for p, s in reqs]
    state = _flaky_family(eng, "ragged" if ragged else "decode", 2)
    eng.run_to_completion()
    assert state["raised"] == 2 and eng.stats()["retries"] == 2
    assert [eng.result(r).tolist() for r in rids] == clean


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_failed_collection_is_contained(weights, ragged):
    eng = _engine(weights, ragged, max_dispatch_retries=0)
    rids = [eng.add_request(p, SamplingParams(max_new_tokens=24))
            for p, _ in _prompts(2)]
    while not any(r is not None and r.state == "running"
                  for r in eng._slots):
        eng.step()
    orig = eng._device_call
    state = {"armed": 0}

    def torn(*args):
        raise RuntimeError("torn read (test)")

    def flaky(kind, fn, *args):
        if kind.startswith("collect:") and kind != "collect:prefill" \
                and not state["armed"]:
            state["armed"] = 1
            return orig(kind, torn, *args)
        return orig(kind, fn, *args)

    eng._device_call = flaky
    eng.run_to_completion()
    assert state["armed"] == 1
    states = {eng.request(r).state for r in rids}
    assert states <= {"done", "failed"} and "failed" in states
    _pool_whole(eng)


# -- preemption with recompute -----------------------------------------------------------
def _long_pair():
    return [(p, SamplingParams(max_new_tokens=40)) for p, _ in _prompts(2)]


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_oom_preemption_recomputes_token_identical(weights, ragged):
    reqs = _long_pair()
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged, num_blocks=8, admission="optimistic")
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["recompute_tokens"] > 0
    assert [eng.result(r).tolist() for r in rids] == clean
    assert all(eng.request(r).state == "done" for r in rids)
    _pool_whole(eng)


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_priority_protects_high_priority_request(weights, ragged):
    (p0, _), (p1, _) = _prompts(2)
    eng = _engine(weights, ragged, num_blocks=8, admission="optimistic")
    hi = eng.add_request(p0, SamplingParams(max_new_tokens=40, priority=1))
    lo = eng.add_request(p1, SamplingParams(max_new_tokens=40, priority=0))
    eng.run_to_completion()
    assert eng.stats()["preemptions"] >= 1
    assert eng.request(hi).state == eng.request(lo).state == "done"
    assert eng.request(hi).t_done <= eng.request(lo).t_done


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_mid_chunk_victim_rows_neutralized(weights, ragged):
    """The victim is the OLDER request (low priority), scheduled before
    the one whose extend hits the pressure: its rows already in the
    chunk are re-aimed at the scratch page, or the survivor's K/V is
    overwritten in the same program."""
    (p0, _), (p1, _) = _prompts(2)
    reqs = [(p0, SamplingParams(max_new_tokens=40, priority=0)),
            (p1, SamplingParams(max_new_tokens=40, priority=5))]
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged, num_blocks=8, admission="optimistic")
    lo, hi = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    assert eng.stats()["preemptions"] >= 1
    assert eng.result(hi).tolist() == clean[1]
    assert eng.result(lo).tolist() == clean[0]


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_extend_fault_victim_in_later_group_skipped(weights, ragged):
    rng = np.random.RandomState(21)
    reqs = [(rng.randint(0, 512, (8,)).astype(np.int32),
             SamplingParams(max_new_tokens=6)) for _ in range(5)]
    clean = _clean(weights, ragged, reqs, max_batch_size=5)
    eng = _engine(weights, ragged, max_batch_size=5)
    cache = eng.dec.cache
    orig, calls = cache.extend, {"n": 0}

    def failing_extend(seq_id):
        calls["n"] += 1
        if calls["n"] == 1:
            raise KVCacheExhausted("injected")
        return orig(seq_id)

    cache.extend = failing_extend
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.step()
    del cache.extend
    assert eng.stats()["preemptions"] >= 1
    eng.run_to_completion()
    assert [eng.result(r).tolist() for r in rids] == clean
    eng.dec.cache.debug_check()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_mid_chunk_rich_victim_drops_rich_sampling(weights, ragged):
    """A preempted rich victim takes its rich flag with it: every rich
    dispatch coincides with a rich request holding a slot, and the
    greedy survivor is clean."""
    (p0, _), (p1, _) = _prompts(2)
    clean = _clean(weights, ragged, [(p1, SamplingParams(max_new_tokens=40))])
    eng = _engine(weights, ragged, num_blocks=8, admission="optimistic")
    family = "ragged" if ragged else "decode"
    fn = eng.programs._fns[family]
    seen = []

    def spy(key, *ops):
        # a ragged chunk may also be rich for a rich request's final
        if key[-1]:
            seen.append(any(r is not None and r.sampling.needs_rich_sampling
                            and (r.state == "running"
                                 or ragged and r.state == "prefilling")
                            for r in eng._slots))
        return fn(key, *ops)

    eng.programs._fns[family] = spy
    lo = eng.add_request(p0, SamplingParams(
        max_new_tokens=40, priority=0, temperature=0.8, top_p=0.9,
        repetition_penalty=1.3))
    hi = eng.add_request(p1, SamplingParams(max_new_tokens=40, priority=5))
    eng.run_to_completion()
    assert eng.stats()["preemptions"] >= 1
    assert eng.result(hi).tolist() == clean[0]
    assert eng.request(lo).state == "done"
    assert seen and all(seen), seen


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_injected_alloc_oom_triggers_preemption(weights, ragged):
    reqs = [(p, SamplingParams(max_new_tokens=24)) for p, _ in _prompts(2)]
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged)
    monkey = ChaosMonkey(seed=5, p_alloc_oom=0.25).attach(eng)
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    monkey.detach(eng)
    assert monkey.counts["alloc_oom"] >= 1
    assert eng.dec.cache.fault_hook is None and eng.chaos is None
    for rid, want in zip(rids, clean):
        if eng.request(rid).state == "done":
            assert eng.result(rid).tolist() == want
    eng.dec.cache.debug_check()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_no_recompute_decoder_fails_instead_of_preempting(weights, ragged):
    reqs = _long_pair()
    clean = _clean(weights, ragged, reqs)
    eng = _engine(weights, ragged, num_blocks=8, admission="optimistic")
    eng._can_recompute = False
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    st = eng.stats()
    assert st["preemptions"] == 0 and st["failed"] >= 1
    n_failed = 0
    for rid, want in zip(rids, clean):
        req = eng.request(rid)
        if req.state == "done":
            assert eng.result(rid).tolist() == want
        else:
            assert req.state == "failed" and "recompute" in req.error
            n_failed += 1
    assert n_failed == st["failed"]
    eng.dec.cache.debug_check()


def test_ragged_preemption_identity_against_unpressured_dense(weights):
    """tests/test_ragged_batching.py:274: a tiny optimistic pool on the
    ragged path gives the unpressured dense engine's streams."""
    rng = np.random.RandomState(17)
    reqs = [(rng.randint(0, 512, (n,)).astype(np.int32),
             SamplingParams(max_new_tokens=24)) for n in (8, 16, 24, 8, 12)]
    kw = dict(max_batch_size=3, prompt_buckets=(8, 16, 32, 64),
              chunk_size=4, prefill_chunk=8)
    ref = _clean(weights, False, reqs, num_blocks=96, **kw)
    eng = _engine(weights, True, num_blocks=12, admission="optimistic", **kw)
    rids = [eng.add_request(p, s) for p, s in reqs]
    eng.run_to_completion()
    assert eng.stats()["preemptions"] >= 1
    assert [eng.result(r).tolist() for r in rids] == ref


def test_ragged_self_victim_blanks_partial_rows(weights):
    """tests/test_ragged_batching.py:375: a decode request that becomes
    its own victim mid-build has its written rows blanked, and recovers
    token-identically."""
    rng = np.random.RandomState(17)
    reqs = [(rng.randint(0, 512, (n,)).astype(np.int32),
             SamplingParams(max_new_tokens=16)) for n in (8, 12)]
    kw = dict(max_batch_size=3, prompt_buckets=(8, 16, 32, 64),
              chunk_size=4, prefill_chunk=8)
    ref = _clean(weights, True, reqs, **kw)
    eng = _engine(weights, True, **kw)
    rids = [eng.add_request(p, s) for p, s in reqs]
    while eng.generated_tokens < 4:
        eng.step()
    victim = next(r for r in eng._slots
                  if r is not None and r.req_id == rids[0])
    orig = eng._extend_with_preempt
    state = {"n": 0}

    def extend(req, exclude=()):
        if req is victim and state["n"] == 1:
            state["n"] += 1
            raise KVCacheExhausted("injected self-victim")
        if req is victim:
            state["n"] += 1
        return orig(req, exclude)

    eng._extend_with_preempt = extend
    eng.step()
    eng._extend_with_preempt = orig
    assert eng.stats()["preemptions"] >= 1
    eng.run_to_completion()
    assert [eng.result(r).tolist() for r in rids] == ref
    eng.dec.cache.debug_check()


@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_tight_int8_pool_preemption(weights, ragged):
    """Optimistic admission on a tight int8 pool: preemption frees
    quantized blocks and the resume prefills them again. Held against
    JAX's engine on the same pools, tight and roomy. On the ragged
    scheduler the tight streams also equal the roomy ones; on the dense
    one a resume's K/V comes from prefill rows, whose int8 rounding may
    differ from the decode rows' it replaces, in JAX as in the port, and
    a stream may then leave the roomy one at a near-tie."""
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 512, (n,)).astype(np.int32),
             SamplingParams(max_new_tokens=40)) for n in (9, 14, 7)]
    kw = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              prefill_chunk=8)
    outs = {}
    for nb, adm in ((64, "worst_case"), (14, "optimistic")):
        jdec = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=nb,
                                      block_size=8, kv_quant="int8")
        jeng = JaxEngine(jdec, ragged=ragged, admission=adm,
                         overlap=not ragged, retry_backoff_s=0.0, **kw)
        rids = [jeng.add_request(p, JaxParams(max_new_tokens=40))
                for p, _ in reqs]
        jeng.run_to_completion()
        eng = _engine(weights, ragged, num_blocks=nb, kv_quant="int8",
                      admission=adm, **kw)
        tids = [eng.add_request(p, s) for p, s in reqs]
        eng.run_to_completion()
        assert eng.stats()["preemptions"] \
            == jeng.stats()["preemptions"] >= (nb == 14)
        outs[nb] = [eng.result(r).tolist() for r in tids]
        assert outs[nb] == [jeng.result(r).tolist() for r in rids]
        eng.dec.cache.debug_check()
    if ragged:
        assert outs[14] == outs[64]


# -- the chaos monkey -------------------------------------------------------------------
@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_seeded_chaos_run(weights, ragged):
    """Allocator OOMs, dispatch and collection faults and two cancels
    on an optimistic pool: every request that finishes equals the clean
    run, every retry and every exhaustion answers one injected fault,
    and every failed request names a fault."""
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, 512, (int(rng.randint(4, 30)),))
             .astype(np.int32),
             SamplingParams(max_new_tokens=int(rng.randint(4, 14))))
            for _ in range(8)]
    kw = dict(max_batch_size=3, prompt_buckets=(8, 16, 32), chunk_size=4,
              prefill_chunk=8)
    clean = _clean(weights, ragged, reqs, **kw)
    eng = _engine(weights, ragged, num_blocks=14, admission="optimistic",
                  max_dispatch_retries=1, **kw)
    monkey = ChaosMonkey(seed=1, p_alloc_oom=0.05, p_dispatch=0.08,
                         p_collect=0.05).attach(eng)
    rids = [eng.add_request(p, s) for p, s in reqs]
    steps = 0
    while eng.step():
        steps += 1
        if steps in (3, 7):
            live = [r for r in rids
                    if eng._find_request(r).state in ("queued", "prefilling",
                                                      "running")]
            if live:
                eng.cancel(live[-1])
    monkey.detach(eng)
    st = eng.stats()
    faults = monkey.counts["dispatch_faults"] + monkey.counts["collect_faults"]
    assert faults >= 1
    assert st["retries"] + st["dispatch_exhaustions"] == faults
    for rid, want in zip(rids, clean):
        req = eng.request(rid)
        if req.state == "done":
            assert req.out_tokens == want
        elif req.state == "failed":
            assert "after retries" in req.error \
                or "KV pool exhausted" in req.error
        else:
            assert req.state == "aborted" and req.error == "cancelled"
    eng.dec.cache.debug_check()


# -- counters -----------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", SCHEDULERS)
def test_robustness_counters_present_and_reset(weights, ragged):
    eng = _engine(weights, ragged)
    st = eng.stats()
    for key in ("preemptions", "recompute_tokens", "aborted", "failed",
                "deadline_misses", "shed_requests", "retries",
                "dispatch_exhaustions"):
        assert st[key] == 0
    rid = eng.add_request(*_prompts(1)[0])
    eng.cancel(rid)
    eng.run_to_completion()
    assert eng.stats()["aborted"] == 1 and eng.stats()["finished"] == 0
    assert "slot 0: idle" in eng.debug_dump()
    eng.clear_finished()
    st = eng.stats()
    assert st["aborted"] == 0 and st["finished"] == 0
    with pytest.raises(ValueError, match="admission"):
        ServingEngine(eng.dec, admission="hopeful")
