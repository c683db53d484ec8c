"""The port's serving programs, its grid warmup and the sealed set,
against tests/test_program_observatory.py.

On the CPU a program is its eager function; the first run of a key is
its compile. Held here: ``reachable_ragged_widths`` equals JAX's for
several (T, max_b, prefill_budget, ragged_idle_cap); an engine after
``warmup_programs`` + ``seal_programs`` (or ``warmup(seal_programs=
True)``) serves mixed greedy and temperature traffic with no unexpected
recompile, on both schedulers; ``max_width=1`` leaves a rung cold and
the cold rung is counted, with its family and signature; the grid
warmup is schedule-neutral (seed 11 with a temperature-1.0 row: the
same streams as a cold engine, no block claimed, the dense carry buffer
untouched); ``warmup()`` leaves the prefix cache clean; one seed gives
one stream, with one engine key consumed per sampling-capable dispatch;
and ministep t of a ragged chunk draws with the t-th key of its key
operand. Also the port's ``CompileWatch`` and the operand packing of
``ProgramSet``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.utils.telemetry import \
    CompileWatch as JaxWatch  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.inference.programs import (_check_arrays, _pack,
                                                 _views)  # noqa: E402
from paddle_tpu_torch.models import llama_tiny  # noqa: E402
from paddle_tpu_torch.utils import prng  # noqa: E402
from paddle_tpu_torch.utils.telemetry import CompileWatch  # noqa: E402

# tests/test_program_observatory.py CFG and KW
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=96, num_hidden_layers=2, vocab_size=256,
             max_position_embeddings=256)
KW = dict(max_batch_size=3, prompt_buckets=(8, 16, 32), chunk_size=4,
          prefill_chunk=8)


@pytest.fixture(scope="module")
def dec():
    return PagedLlamaDecoder.from_config(llama_tiny(**SMALL), seed=0,
                                         num_blocks=24, block_size=8,
                                         device="cpu")


def _prompt(n=12, seed=0):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _serve(eng, specs):
    rids = [eng.add_request(p, SamplingParams(**sp)) for p, sp in specs]
    while eng.step():
        eng.dec.cache.debug_check()
    return [eng.result(r).tolist() for r in rids]


@pytest.mark.parametrize("setting", [
    dict(chunk_schedule=(4,), max_batch_size=3, prefill_budget=None,
         ragged_idle_cap=8, prefill_chunk=8),
    dict(chunk_schedule=(1, 2, 4), max_batch_size=4, prefill_budget=16,
         ragged_idle_cap=None, prefill_chunk=8),
    dict(chunk_schedule=(8,), max_batch_size=8, prefill_budget=None,
         ragged_idle_cap=256, prefill_chunk=256),
    dict(chunk_schedule=(2, 8), max_batch_size=2, prefill_budget=100,
         ragged_idle_cap=40, prefill_chunk=None),
])
def test_reachable_ragged_widths_match_jax(dec, setting):
    jdec = JaxDecoder.from_config(jax_tiny(**SMALL), seed=0, num_blocks=24,
                                  block_size=8)
    kw = dict(setting, ragged=True, prompt_buckets=(8, 16, 32))
    jeng, teng = JaxEngine(jdec, **kw), ServingEngine(dec, **kw)
    for T in (1, 2, 4, 8):
        for mw in (None, 1, 12, 100):
            assert teng.reachable_ragged_widths(T, mw) \
                == jeng.reachable_ragged_widths(T, mw), (T, mw)


@pytest.mark.parametrize("ragged", [True, False])
def test_sealed_grid_holds_through_traffic(dec, ragged):
    eng = ServingEngine(dec, ragged=ragged, ragged_idle_cap=8, **KW)
    eng.warmup(seal_programs=True)
    st = eng.stats()
    assert st["programs_sealed"] is True and st["program_compiles"] == 0
    assert eng.compile_watch.compiles > 0
    out = _serve(eng, [(_prompt(seed=s), dict(
        max_new_tokens=10, temperature=0.8 if s % 2 else 0.0))
        for s in range(5)])
    st = eng.stats()
    assert st["unexpected_recompiles"] == 0 and st["finished"] == 5
    assert all(len(o) == 10 for o in out)
    rec = eng.compile_watch.records[0]
    assert rec["decoder"] == "PagedLlamaDecoder"
    assert rec["kv_quant"] == "none" and rec["tp"] == 1
    eng.close()


def test_cold_rung_post_seal_is_counted(dec):
    eng = ServingEngine(dec, ragged=True, ragged_idle_cap=8, **KW)
    eng.warmup_programs(max_width=1)
    eng.seal_programs()
    _serve(eng, [(_prompt(seed=s), dict(max_new_tokens=6))
                 for s in range(3)])
    st = eng.stats()
    assert st["unexpected_recompiles"] >= 1
    late = [r for r in eng.compile_watch.records if r["sealed"]]
    assert len(late) == st["unexpected_recompiles"]
    assert all(r["family"] == "ragged" and r["signature"].startswith("i4[")
               and r["key"][1] > 1 for r in late)
    # a cold key runs eagerly each time but counts once
    before = eng.compile_watch.unexpected_recompiles
    _serve(eng, [(_prompt(seed=s), dict(max_new_tokens=6))
                 for s in range(3)])
    assert eng.compile_watch.unexpected_recompiles == before


@pytest.mark.parametrize("ragged", [True, False])
def test_warmup_programs_is_schedule_neutral(dec, ragged):
    outs = {}
    for tag in ("cold", "sealed"):
        eng = ServingEngine(dec, seed=11, ragged=ragged, ragged_idle_cap=8,
                            top_k=5, **KW)
        if tag == "sealed":
            eng._carry.fill_(7)
            eng.warmup_programs()
            eng.seal_programs()
            assert dec.cache.free_blocks == dec.cache.num_blocks - 1
            assert bool((eng._carry == 7).all())
            eng._carry.zero_()
        outs[tag] = _serve(eng, [(_prompt(seed=s), dict(
            max_new_tokens=8, temperature=1.0 if s == 1 else 0.0))
            for s in range(3)])
        assert eng.stats()["unexpected_recompiles"] == 0
        eng.close()
    assert outs["cold"] == outs["sealed"]


def test_warmup_leaves_prefix_cache_clean(dec):
    for ragged in (True, False):
        eng = ServingEngine(dec, ragged=ragged,
                            **dict(KW, prompt_buckets=(8, 16)))
        eng.warmup(prompt_len=8)
        st = eng.stats()
        assert dec.cache.cached_blocks == 0 and st["cached_blocks"] == 0
        assert st["prefix_cache_hit_tokens"] == 0 and st["finished"] == 0
        assert st["generated_tokens"] == 0 and st["program_compiles"] == 0
        dec.cache.debug_check()
        eng.close()


def _iterated_key(seed, n):
    """The engine key after n ``_next_key()`` calls."""
    key = prng.PRNGKey(seed)
    for _ in range(n):
        key = prng.split(key)[0]
    return key


@pytest.mark.parametrize("ragged", [True, False])
def test_one_stream_per_seed(dec, ragged):
    """One seed gives one stream; the engine key is consumed once per
    sampling-capable dispatch (ragged chunks, dense decode chunks and
    finals; no-sample mid chunks draw none), as in JAX."""
    specs = [(_prompt(seed=s), dict(max_new_tokens=8, temperature=0.9))
             for s in range(3)]
    runs = []
    for seed in (7, 7, 8):
        eng = ServingEngine(dec, ragged=ragged, seed=seed, **KW)
        runs.append(_serve(eng, specs))
        drawing = sum(n for (fam, _), n in eng.programs.dispatches.items()
                      if not fam.startswith("prefill_mid"))
        assert (eng._key == _iterated_key(seed, drawing)).all()
        eng.close()
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_ragged_chunk_draws_per_chunk(dec):
    """A ragged chunk draws ministep t with keys[t] of its [T, 2] key
    operand: with every row on the scratch page each ministep sees the
    same logits, so a sampled row at the first ministep under key k and
    one at the last ministep under key k draw the same token, a greedy
    chunk ignores its keys, and the same operands replay the same
    tokens."""
    eng = ServingEngine(dec, ragged=True, seed=3, **KW)
    T, W, mb = 4, 2, eng.max_b
    sched = np.zeros((6, T, W), np.int32)
    sched[2] = eng._scratch_slot
    sched[3] = mb
    tables = np.full((mb + 1, dec.max_pages), eng._scratch_block, np.int32)
    keys = prng.split(prng.PRNGKey(5), T)

    def run(sampled_at, keys, temp=50.0):
        temps = np.zeros((T, W), np.float32)
        if sampled_at is not None:
            temps[sampled_at, 1] = temp
        key = (T, W, sampled_at is not None, False)
        with torch.inference_mode():
            toks, = eng.programs.run(
                "ragged", key, [np.zeros(W, np.int32), sched, tables,
                                temps, eng._key_operand(keys)])
        return toks.numpy()

    first = run(0, keys)
    last = run(T - 1, np.roll(keys, -1, axis=0))
    assert first[0, 1] == last[T - 1, 1]
    assert (run(0, keys) == first).all()
    greedy = run(None, keys)
    assert (run(None, prng.split(prng.PRNGKey(9), T)) == greedy).all()
    draws = {int(run(0, prng.split(prng.PRNGKey(s), T))[0, 1])
             for s in range(8)}
    assert len(draws) > 1          # hot rows do draw
    eng.close()


def test_compile_watch_sealed_set():
    w = CompileWatch()
    w.register("fam", decoder="x")
    args = [np.zeros((2, 3), np.int32), np.zeros(4, np.float32)]
    assert w.observe("fam", (1,), 0.0, 0.5, args) == (1, 0)
    assert w.observe("fam", (1,), 0.0, 0.5, args) == (0, 0)
    w.seal()
    assert w.observe("fam", (1,), 0.0, 0.5, args) == (0, 0)
    assert w.observe("fam", (2,), 0.0, 0.5, args) == (1, 1)
    assert (w.compiles, w.unexpected_recompiles) == (2, 1)
    assert [r["sealed"] for r in w.records] == [False, True]
    assert w.records[1]["signature"] == "i4[2x3],f4[4]"
    assert w.records[1]["decoder"] == "x" and w.families == ["fam"]
    # the same signature as the JAX watch (which elides weights, k, v)
    arrays = [np.zeros((2, 3), np.int32), np.ones((5,), np.float32),
              np.zeros((1, 4, 2), np.int32)]
    assert CompileWatch.signature_of(arrays) \
        == JaxWatch.signature_of((0, 0, 0, *arrays))
    assert CompileWatch.signature_of([torch.zeros(3, dtype=torch.int32)]) \
        == "i4[3]"


def test_operand_packing_round_trip():
    rng = np.random.RandomState(0)
    arrays = [rng.randint(-9, 9, (2, 3)).astype(np.int32),
              rng.randn(4).astype(np.float32),
              rng.randint(0, 9, (3, 1, 2)).astype(np.int32)]
    buf = np.zeros(sum(a.size for a in arrays), np.int32)
    _pack(buf, arrays)
    views = _views(torch.from_numpy(buf), arrays)
    for a, v in zip(arrays, views):
        assert v.shape == a.shape
        np.testing.assert_array_equal(v.numpy(), a)
    with pytest.raises(TypeError):
        _check_arrays([np.zeros(2, np.int64)])
