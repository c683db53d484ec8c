"""Serving a model: the port's ``ServingEngine(model)`` and
``PagedLlamaDecoder.from_model`` against JAX's ``ServingEngine(model)``
and ``PagedLlamaDecoder(model)`` on the CPU.

The JAX ``LlamaForCausalLM(llama_tiny())`` (float32; untied and tied) is
built from ``paddle.seed(0)`` and carried into the port's model by
``load_numpy_state``; each engine then builds its decoder from its own
model. Held:
- ``from_model``'s weights tree equal to JAX's ``_extract_weights``
  (fused q/k/v and gate/up, a tied head ``embed.T``; int8 and int4 bit
  for bit), the model's tensors shared when kept as they are, and the
  pool's dtype, bytes and bytes per token equal to JAX's;
- greedy and sampled streams token for token equal to JAX's over a
  matrix that is covered, not crossed: both schedulers, ``weight_dtype``
  None / int8 / int4, an int8 KV pool, tied and untied. JAX's ragged
  engine runs with ``overlap=False`` (the port's collects within its
  step); the dense ones run without prefix caching on both sides;
- ``stats()``: the keys JAX added for latency and the pool, with a clock
  that moves only between steps, so both engines stamp the same times:
  every latency, TTFT, queue-wait and ITL percentile equal to JAX's on
  the workloads of ``tests/test_chunked_prefill.py:398`` and
  ``tests/test_kv_quant.py:492``, pool bytes exact, the pool gauges kept
  by ``clear_finished``;
- the ITL repair: read mid-run, ``itl_p50_s`` / ``itl_p99_s`` equal JAX's
  (finished requests' reservoir plus the live slots' samples), where the
  old finished-only aggregation gives other values;
- a prebuilt decoder keeps its pool; a contradicting ``kv_quant``, a
  ``device`` for a prebuilt decoder and a foreign object raise; JAX's
  tensor-parallel arguments follow JAX's rules (``tp=2`` serves); the telemetry arguments are accepted; without
  ``device="cpu"`` the model form raises on a machine without a card.
One torch thread.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.inference.serving as jserving  # noqa: E402
from paddle_tpu.inference import SamplingParams as JaxParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
import paddle_tpu_torch.inference.serving as tserving  # noqa: E402
from paddle_tpu_torch.inference import (PagedLlamaDecoder, SamplingParams,
                                        ServingEngine)  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.qweight import QWeight  # noqa: E402
from paddle_tpu_torch.utils.telemetry import SLOPolicy, Tracer  # noqa: E402
from _torch_serving_cases import assert_identical, prompts  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def untied():
    return _pair()


@pytest.fixture(scope="module")
def tied():
    return _pair(tie_word_embeddings=True)


def _leaves(w):
    """A weight as numpy arrays: (q, scale) for a quantized one."""
    if isinstance(w, QWeight):
        return [w.q.numpy(), w.scale.numpy()]
    if isinstance(w, tuple):
        return [np.asarray(a) for a in w]
    return [w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)]


@pytest.mark.parametrize("which,weight_dtype,kv_quant", [
    ("untied", None, None), ("tied", None, "int8"), ("untied", "int8", None),
    ("tied", "int4", None), ("untied", "int4", "int8")])
def test_from_model_matches_jax_decoder(which, weight_dtype, kv_quant,
                                        request):
    jm, tm = request.getfixturevalue(which)
    pool = dict(num_blocks=16, block_size=8, weight_dtype=weight_dtype,
                kv_quant=kv_quant)
    jdec = JaxDecoder(jm, **pool)
    tdec = PagedLlamaDecoder.from_model(tm, device="cpu", **pool)
    jw, (tw,) = jdec.weights, tdec.weights
    for name in ("embed", "norm", "head"):
        for a, b in zip(_leaves(tw[name]), _leaves(jw[name])):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for jl, tl in zip(jw["layers"], tw["layers"]):
        assert sorted(jl) == sorted(tl)
        for name in jl:
            for a, b in zip(_leaves(tl[name]), _leaves(jl[name])):
                np.testing.assert_array_equal(a, b, err_msg=name)
    jc, tc = jdec.cache, tdec.cache
    assert tc.pool_dtype == jc.pool_dtype
    assert tc.pool_bytes() == jc.pool_bytes()
    assert tc.bytes_per_token() == jc.bytes_per_token()
    if weight_dtype is None:
        # the model's tensors, shared: the embedding (and so a tied head),
        # the norms, wo and wd
        emb = tm.model.embed_tokens.weight
        assert tw["embed"].data_ptr() == emb.data_ptr()
        head = emb if which == "tied" else tm.lm_head.weight
        assert tw["head"].data_ptr() == head.data_ptr()
        lyr = tm.model.layers[0]
        assert tw["layers"][0]["wo"].data_ptr() == \
            lyr.self_attn.o_proj.weight.data_ptr()
        assert tw["layers"][0]["ln1"].data_ptr() == \
            lyr.input_layernorm.weight.data_ptr()


def test_bf16_model_serves_in_float32():
    jm, tm = _pair(dtype="bfloat16")
    jeng = JaxEngine(jm, max_batch_size=2, num_blocks=16, block_size=8,
                     prompt_buckets=(16,))
    teng = ServingEngine(tm, max_batch_size=2, num_blocks=16, block_size=8,
                         prompt_buckets=(16,), device="cpu")
    assert teng.dec.cache.k[0][0].dtype == torch.float32
    assert teng.dec.weights[0]["layers"][0]["ln1"].dtype == torch.bfloat16
    for key in ("kv_quant", "kv_pool_bytes", "kv_bytes_per_token"):
        assert teng.stats()[key] == jeng.stats()[key]
    assert teng.stats()["kv_quant"] == "float32"


# (scheduler, weight_dtype, kv_quant, model, sampled): each option is
# covered, the matrix is not crossed
STREAMS = [
    ("ragged", None, None, "untied", False),
    ("ragged", "int4", None, "tied", False),
    ("ragged", None, "int8", "untied", False),
    ("ragged", "int8", None, "tied", True),
    ("dense", None, None, "tied", False),
    ("dense", "int8", None, "untied", False),
    ("dense", "int4", None, "untied", True),
]


def _requests(sampled, seed=42):
    """tests/test_serving.py's mixed lengths; sampled: two rows at 0.8."""
    lens, news = [5, 12, 20, 9, 16], [6, 4, 8, 5, 3]
    temps = [0.0, 0.8, 0.0, 0.8, 0.0] if sampled else [0.0] * 5
    return [(p, dict(max_new_tokens=m, temperature=t)) for p, m, t in
            zip(prompts(np.random.RandomState(seed), lens), news, temps)]


def _drive(eng, reqs, params):
    rids = [eng.add_request(p, params(**sp)) for p, sp in reqs]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids]


@pytest.mark.parametrize("sched,weight_dtype,kv_quant,which,sampled",
                         STREAMS)
def test_streams_match_jax(sched, weight_dtype, kv_quant, which, sampled,
                           request):
    jm, tm = request.getfixturevalue(which)
    ragged = sched == "ragged"
    kw = dict(max_batch_size=2, num_blocks=96, block_size=8,
              prompt_buckets=(8, 16, 32), chunk_size=4, prefill_chunk=8,
              weight_dtype=weight_dtype, kv_quant=kv_quant, ragged=ragged,
              seed=3)
    if not ragged:
        kw["prefix_caching"] = False
    reqs = _requests(sampled)
    jeng = JaxEngine(jm, overlap=not ragged, **kw)
    want = _drive(jeng, reqs, JaxParams)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert teng.ragged is ragged and teng.kv_quant == kv_quant
    got = _drive(teng, reqs, SamplingParams)
    teng.dec.cache.debug_check()
    if sampled:
        assert got == want
    else:
        assert_identical(teng.dec, reqs, got, want)
    assert [len(o) for o in got] == [6, 4, 8, 5, 3]
    teng.close()


class _Clock:
    """A ``time`` module whose clock moves only when the test moves it."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    time = monotonic = perf_counter

    def sleep(self, s):
        pass


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jserving, "time", c)
    monkeypatch.setattr(tserving, "time", c)
    return c


STAT_KEYS = ("finished", "generated_tokens", "latency_p50_s",
             "latency_p99_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
             "itl_p99_s", "queue_wait_p50_s", "kv_quant", "kv_pool_bytes",
             "kv_bytes_per_token")


def _stepped(clock, engines, until=None, dt=0.01):
    """Step every engine once per clock tick until none has work (or
    ``until(step)`` is true); each tick's stats must agree."""
    step = 0
    while any(e.has_work for e in engines):
        step += 1
        clock.t = step * dt
        for e in engines:
            e.step()
        sts = [e.stats() for e in engines]
        for key in STAT_KEYS:
            assert sts[0][key] == sts[1][key], (step, key, sts)
        if until is not None and until(step):
            break
    return step


def _pool_and_latency(st):
    return {k: st[k] for k in STAT_KEYS}


def test_stats_match_jax_chunked_prefill_workload(untied, clock):
    """tests/test_chunked_prefill.py:398: three requests of 6, 11 and 9
    tokens, 12 new each, on the dense engine."""
    jm, tm = untied
    kw = dict(max_batch_size=2, num_blocks=64, block_size=8,
              prompt_buckets=(8, 16, 32), chunk_size=4)
    rng = np.random.RandomState(9)
    reqs = [rng.randint(0, 512, (n,)).astype(np.int32) for n in (6, 11, 9)]
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    rids = [(jeng.add_request(p, JaxParams(max_new_tokens=12)),
             teng.add_request(p, SamplingParams(max_new_tokens=12)))
            for p in reqs]
    _stepped(clock, (jeng, teng))
    st = teng.stats()
    assert _pool_and_latency(st) == _pool_and_latency(jeng.stats())
    assert st["itl_p50_s"] > 0 and st["itl_p99_s"] >= st["itl_p50_s"]
    assert st["queue_wait_p50_s"] >= 0
    assert st["latency_p99_s"] >= st["latency_p50_s"] > 0
    assert st["ttft_p99_s"] >= st["ttft_p50_s"] > 0
    for _, r in rids:
        req = teng.request(r)
        assert len(req.itls) == 11
        assert req.latency_s == req.t_done - req.t_submit
        assert req.queue_wait_s == req.t_admit - req.t_submit
    assert st["kv_quant"] == "float32"
    for eng in (jeng, teng):
        eng.clear_finished()
    st2 = teng.stats()
    assert _pool_and_latency(st2) == _pool_and_latency(jeng.stats())
    for key in ("itl_p50_s", "queue_wait_p50_s", "latency_p50_s",
                "ttft_p99_s"):
        assert st2[key] is None
    assert st2["kv_pool_bytes"] == st["kv_pool_bytes"]


def test_stats_match_jax_kv_quant_workload(untied, clock):
    """tests/test_kv_quant.py:492: the ragged engine on an int8 pool of 16
    blocks of 8, one 9-token prompt, 4 new."""
    jm, tm = untied
    kw = dict(max_batch_size=2, num_blocks=16, block_size=8,
              prompt_buckets=(16, 32), chunk_size=4, ragged=True,
              kv_quant="int8")
    prompt = prompts(np.random.RandomState(0), (9,))[0]
    jeng = JaxEngine(jm, overlap=False, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    for eng, params in ((jeng, JaxParams), (teng, SamplingParams)):
        eng.add_request(prompt, params(max_new_tokens=4))
    _stepped(clock, (jeng, teng))
    st = teng.stats()
    assert st["kv_quant"] == "int8"
    # 2 layers x (k + v) x (int8 values + float32 scales)
    want = 2 * 2 * (16 * 2 * 8 * 32 + 16 * 2 * 8 * 4)
    assert st["kv_pool_bytes"] == want == teng.dec.cache.pool_bytes()
    assert st["kv_bytes_per_token"] == want / (16 * 8)
    assert _pool_and_latency(st) == _pool_and_latency(jeng.stats())
    teng.clear_finished()
    st2 = teng.stats()
    assert st2["finished"] == 0 and st2["generated_tokens"] == 0
    assert (st2["kv_quant"], st2["kv_pool_bytes"],
            st2["kv_bytes_per_token"]) == ("int8", want,
                                           st["kv_bytes_per_token"])


def _finished_only_itls(eng):
    """The aggregation the port's stats() used before: the ITL samples of
    finished requests only."""
    itls = [x for r in eng._done.values() if r.state == "done"
            for x in r.itls]
    if not itls:
        return None, None
    return (float(np.quantile(itls, 0.5)), float(np.quantile(itls, 0.99)))


def test_itl_mid_run_matches_jax(untied, clock):
    """stats() read while requests still decode: JAX aggregates the
    finished requests' reservoir and the live slots' samples, and so does
    the port now; the finished-only list it kept before differs."""
    jm, tm = untied
    kw = dict(max_batch_size=3, num_blocks=64, block_size=8,
              prompt_buckets=(8, 16, 32), chunk_size=2, prefill_chunk=8,
              ragged=True)
    lens, news = (5, 12, 9, 7), (3, 14, 10, 12)
    reqs = list(zip(prompts(np.random.RandomState(5), lens), news))
    jeng = JaxEngine(jm, overlap=False, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    for eng, params in ((jeng, JaxParams), (teng, SamplingParams)):
        for p, n in reqs:
            eng.add_request(p, params(max_new_tokens=n))
    mid = []

    def read(step):
        st = teng.stats()
        live = any(r is not None and r.itls for r in teng._slots)
        if teng._done and live:
            mid.append((st["itl_p50_s"], st["itl_p99_s"],
                        _finished_only_itls(teng)))
        return False

    _stepped(clock, (jeng, teng), until=read)
    assert mid, "no step had finished and live requests together"
    # the port equals JAX at every step (_stepped); the old aggregation
    # would not have
    assert any((p50, p99) != old for p50, p99, old in mid)
    assert len(teng._itl_res) == sum(len(r.itls)
                                     for r in teng._done.values())


def test_reservoir_is_exact_then_bounded():
    from paddle_tpu_torch.utils.telemetry import Reservoir
    from paddle_tpu.utils.telemetry import Reservoir as JaxReservoir
    r, j = Reservoir(k=8, seed=3), JaxReservoir(k=8, seed=3)
    xs = np.random.RandomState(0).rand(50)
    r.extend(xs[:8])
    assert list(r) == [float(x) for x in xs[:8]]
    r.extend(xs[8:])
    j.extend(xs)
    assert len(r) == 8 and r.n == 50 and list(r) == list(j)


def test_prebuilt_decoder_and_refusals(untied):
    _, tm = untied
    dec = PagedLlamaDecoder.from_model(tm, num_blocks=16, block_size=8,
                                       device="cpu")
    eng = ServingEngine(dec, num_blocks=999, block_size=4)
    assert eng.dec is dec and eng.stats()["kv_pool_bytes"] == \
        dec.cache.pool_bytes()
    eng.close()
    with pytest.raises(ValueError, match="prebuilt decoder"):
        ServingEngine(dec, kv_quant="int8")
    with pytest.raises(ValueError, match="prebuilt decoder"):
        ServingEngine(dec, device="meta")
    with pytest.raises(TypeError, match="LlamaForCausalLM"):
        ServingEngine(object())
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(tm, kv_quant="int4", device="cpu")
    # tp_comm="fp32" is the one mode a single device has
    ServingEngine(dec, tp_comm="fp32").close()
    with pytest.raises(ValueError, match="tp_comm"):
        ServingEngine(dec, tp_comm="fp16")


@pytest.mark.parametrize("arg,value,item", [
    ("tp", 2, "5"), ("mesh", object(), "5"), ("devices", ["cpu"], "5"),
    ("tp_comm", "int8", "5")])
def test_unported_arguments_raise(untied, arg, value, item):
    """JAX's tensor-parallel arguments, once refused as ROADMAP item
    ``item``, now take JAX's rules: tp=2 over two CPU shards serves the
    model's streams; a mesh that is not a ProcessMesh, devices at tp 1
    and int8 comm at tp 1 raise as JAX's engine does, naming no
    ROADMAP item."""
    _, tm = untied
    if arg == "tp":
        p = np.random.RandomState(3).randint(0, 512, 9).astype(np.int32)
        streams = []
        for kw in (dict(device="cpu"), dict(tp=2, devices=["cpu"] * 2)):
            eng = ServingEngine(tm, ragged=True, **kw)
            rid = eng.add_request(p, SamplingParams(max_new_tokens=5))
            eng.run_to_completion()
            streams.append(eng.result(rid).tolist())
        assert eng.tp == 2 and eng.ragged and streams[0] == streams[1]
        return
    err = {"mesh": TypeError, "devices": ValueError,
           "tp_comm": ValueError}[arg]
    with pytest.raises(err) as e:
        ServingEngine(tm, device="cpu", **{arg: value})
    assert f"item {item}" not in str(e.value)
    assert {"mesh": "ProcessMesh", "devices": "devices= requires",
            "tp_comm": "int8"}[arg] in str(e.value)


@pytest.mark.parametrize("arg", ["tracer", "slo", "profile_every",
                                 "profile_seed"])
def test_telemetry_arguments_accepted(untied, arg):
    """The four telemetry arguments, once refused, build an engine and set
    what they name."""
    _, tm = untied
    value = {"tracer": Tracer(), "slo": [SLOPolicy("all", ttft_p99_s=1.0)],
             "profile_every": 4, "profile_seed": 1}[arg]
    eng = ServingEngine(tm, device="cpu", **{arg: value})
    st = eng.stats()
    if arg == "tracer":
        assert eng.tracer is value and eng.dec.cache.tracer is value
        assert value.metrics.value("engine.finished") == 0
    elif arg == "slo":
        assert st["slo"]["policies"]["all"]["headroom"] == 1.0
        assert st["slo_min_headroom"] == 1.0
    elif arg == "profile_every":
        assert eng._prof_n == 4 and st["profiled_dispatches"] == 0
    else:
        # the seed sets the phase of the sampling; without profile_every
        # nothing is sampled
        assert eng._prof_n == 0 and st["profiled_dispatches"] == 0
    eng.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is present")
def test_model_form_needs_a_card_or_cpu(untied):
    _, tm = untied
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedLlamaDecoder.from_model(tm)
