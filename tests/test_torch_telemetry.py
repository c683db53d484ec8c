"""Serving telemetry in the port against the JAX package's.

Held:
- the host objects driven by the same calls under one fake clock:
  ``Tracer`` records (ring wraparound, ``dropped``, ``reopen_request``,
  counter tracks, ``drain_since`` / ``ingest``), its Perfetto ``export``
  JSON and ``summary``; ``MetricsRegistry`` snapshots, ``publish``'s type
  mapping and ``openmetrics_text``; ``SLOMonitor.evaluate`` on
  ``tests/test_program_observatory.py``'s synthetic windows;
  ``Reservoir.merge``. Each equal to JAX's exactly;
- the port's ``CompileWatch`` bound to a tracer: compile spans and
  ``compile.*`` counters in the tracer's registry, as JAX's;
- the engine with a tracer against JAX's engine with a tracer (the dense
  default, and ragged with JAX ``overlap=False``) on the done, aborted,
  failed and preempted lifecycles: every record's kind, name, trace id,
  pid and non-time arguments equal, in order. Program records (compile
  spans, ``programs_sealed``) are left out: a JAX program compiles per
  operand shape, a port program per static key. The registry's
  ``engine.*`` keys equal JAX's but for ``PORT_ONLY_KEYS``;
- tracer on / off: streams (greedy and sampled) and counters equal;
- ``profile_every``: histograms present when on, absent when off,
  ``ValueError`` below 1, tokens unchanged;
- SLO TTFT fed once per request across a preemption;
- ``tools/trace_report.analyze`` reading the port's export;
- ``watch_engine`` reporting a stalled engine with the flight-recorder
  tail and the ``.trace.json`` export.
Model: llama_tiny at ``tests/test_fleet_serving.py``'s geometry, JAX's
seeded weights carried by ``load_numpy_state``. One torch thread.
"""
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.utils.telemetry as jtel  # noqa: E402
from paddle_tpu.inference import SamplingParams as JParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JEngine  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.utils.chaos import ChaosMonkey as JMonkey  # noqa: E402
import paddle_tpu_torch.utils.telemetry as ttel  # noqa: E402
from paddle_tpu_torch.distributed.watchdog import watch_engine  # noqa: E402
from paddle_tpu_torch.inference import (SamplingParams,  # noqa: E402
                                        ServingEngine)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.utils.chaos import ChaosMonkey  # noqa: E402
from paddle_tpu_torch.utils.telemetry import (SLOPolicy,  # noqa: E402
                                              Tracer)

GEOM = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, num_hidden_layers=2, vocab_size=256,
            max_position_embeddings=256)
KW = dict(max_batch_size=3, num_blocks=24, block_size=8,
          prompt_buckets=(8, 16, 32), chunk_size=4, prefill_chunk=8)
# stats() keys of the port's engine that JAX's lacks: the queue length,
# the delivered-token count behind decode_utilization and the tp degree
PORT_ONLY_KEYS = {"queued", "decode_useful_tokens", "tp"}
# records of the program sets, which differ by design (module docstring)
PROGRAM_RECORDS = {"compile", "programs_sealed", "unexpected_recompile"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(jax_tiny(**GEOM))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**GEOM), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _prompt(n=12, seed=0):
    return np.random.RandomState(seed).randint(
        0, GEOM["vocab_size"], n).astype(np.int32)


class _Clock:
    """A perf_counter that moves only when told to."""

    def __init__(self, t=100.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def tick(self, dt=0.25):
        self.t += dt


def _on_clock(monkeypatch, clock):
    fake = types.SimpleNamespace(perf_counter=clock.perf_counter)
    for mod in (jtel, ttel):
        monkeypatch.setattr(mod, "time", fake)


# -- host objects, same calls ------------------------------------------------

def _drive_tracer(mod, clock):
    """One script of Tracer calls; returns the tracer."""
    tr = mod.Tracer(capacity=24, id_base=5)
    t1 = tr.begin_request(0, tenant="a", replica=0, prompt_len=12)
    clock.tick()
    t2 = tr.begin_request(1, replica=1)
    tr.span("queued", t1, 100.0, clock.t, pid=0, epoch=0, resume=False)
    for i in range(30):
        clock.tick(0.01)
        tr.event("dispatch", trace=t1 if i % 2 else None, pid=i % 2,
                 kind="ragged", T=4, W=8)
        tr.counter("queue_depth", 30 - i, pid=i % 3)
    tr.counter("healthy_replicas", 2, pid=mod.FLEET_PID)
    tr.end_request(t2, "failed", replica=1, error="boom")
    tr.reopen_request(t2)
    tr.reopen_request(999)
    tr.end_request(t1, "done", replica=0, tokens=8)
    tr.end_request(None, "done")
    mark0 = tr.appended - 3
    recs, mark = tr.drain_since(mark0)
    other = mod.Tracer(id_base=1000)
    other.ingest(recs, ts_offset=0.5)
    other.ingest(tr.drain_since(mark)[0])
    return tr, other, recs, mark


def test_tracer_records_export_summary_equal(monkeypatch, tmp_path):
    clock = _Clock()
    _on_clock(monkeypatch, clock)
    out = {}
    for name, mod in (("jax", jtel), ("port", ttel)):
        clock.t = 100.0
        tr, other, recs, mark = _drive_tracer(mod, clock)
        path = tr.export(str(tmp_path / f"{name}.json"))
        opath = other.export(str(tmp_path / f"{name}_o.json"))
        out[name] = (tr.records(), tr.dropped, tr.appended,
                     json.load(open(path)), tr.summary(last=40),
                     other.records(), json.load(open(opath)), recs, mark,
                     tr.metrics.snapshot(), other.metrics.snapshot())
    assert out["port"] == out["jax"]
    recs, dropped = out["port"][0], out["port"][1]
    assert dropped > 0 and len(recs) == 24        # the ring wrapped


def test_registry_snapshot_and_openmetrics_equal():
    snaps = {}
    for name, mod in (("jax", jtel), ("port", ttel)):
        m = mod.MetricsRegistry()
        m.inc("events.tick")
        m.inc("events.tick", 2)
        m.set_gauge("track.free_blocks.r1", 7)
        m.publish("engine", {"finished": 3, "np_int": np.int64(4),
                             "rate": 0.5, "np_float": np.float32(0.25),
                             "flag": True, "none": None, "nested": {}})
        m.publish("engine", {"rate": None})
        h = m.histogram("engine.itl_s")
        for v, n in ((0.0004, 1), (0.003, 2), (0.7, 1), (99.0, 3)):
            h.observe(v, n=n)
        m.histogram("x.y-z/q", buckets=(1, 2.5)).observe(2.0)
        snap = m.snapshot()
        snaps[name] = (snap, mod.openmetrics_text(snap), m.to_openmetrics(),
                       m.value("engine.finished"), m.value("engine.rate"),
                       m.value("engine.np_float"))
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][0]["counters"]["engine.np_int"] == 4
    assert "engine.flag" not in snaps["port"][0]["counters"]


def _slo_script(mod):
    """tests/test_program_observatory.py's TestSLOMonitor windows, one
    evaluate() after each."""
    P, M = mod.SLOPolicy, mod.SLOMonitor
    evals = []
    mon = M([P("api", ttft_p99_s=1.0)], windows_s=(60.0, 300.0))
    for _ in range(80):
        mon.observe("ttft", 0.1, now=800.0)
    for i in range(20):
        mon.observe("ttft", 2.0 if i < 4 else 0.1, now=990.0)
    evals.append(mon.evaluate(now=1000.0))
    mon = M([P("api", itl_p99_s=0.1)], windows_s=(60.0, 3600.0))
    for _ in range(2000):
        mon.observe("itl", 0.01, now=8200.0)
    for i in range(10):
        mon.observe("itl", 1.0 if i < 2 else 0.01, now=9995.0)
    evals.append(mon.evaluate(now=10_000.0))
    mon = M([P("q", ttft_p99_s=2.0, quantile=0.5)], windows_s=(100.0,))
    for v in (1.0, 1.0, 1.0, 3.0):
        mon.observe("ttft", v, now=50.0)
    evals.append(mon.evaluate(now=50.0))
    mon = M([P("tenant_a", itl_p99_s=1.0,
               class_selector=lambda a: a.get("adapter_id") == "a"),
             P("all", itl_p99_s=1.0)], windows_s=(60.0,))
    mon.observe("itl", 2.0, {"adapter_id": "a"}, n=3, now=100.0)
    mon.observe("itl", 0.1, {"adapter_id": "b"}, n=5, now=100.0)
    evals.append(mon.evaluate(now=100.0))
    evals.append(mon.evaluate(now=500.0))
    mon.reset()
    evals.append(mon.evaluate(now=100.0))
    evals.append(M([P("x", ttft_p99_s=1.0)]).evaluate(now=0.0))
    pols = M.coerce_policies(M([P("a", 1.0)]))
    evals.append([(p.name, p.ttft_p99_s) for p in pols]
                 + [len(M.coerce_policies(None)),
                    len(M.coerce_policies(P("b", 2.0)))])
    errors = []
    for bad in (lambda: M([P("a", 1.0), P("a", 2.0)]),
                lambda: M([P("a", 1.0)], windows_s=(0.0,)),
                lambda: M([P("a", 1.0)]).observe("nope", 1.0)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    evals.append(errors)
    return evals


def test_slo_monitor_evaluations_equal():
    port, jax_ = _slo_script(ttel), _slo_script(jtel)
    assert port == jax_
    assert port[0]["policies"]["api"]["violating"]
    assert len(port[-1]) == 3


def test_reservoir_merge_equal():
    out = {}
    for name, mod in (("jax", jtel), ("port", ttel)):
        rng = np.random.RandomState(1)
        a = mod.Reservoir(k=256, seed=3)
        a.extend(rng.lognormal(-3.0, 0.7, 10_000))
        b = mod.Reservoir(k=256)
        b.extend([1.0] * 100)
        out[name] = (list(a), a.n,
                     mod.Reservoir.merge([a, b], k=256),
                     mod.Reservoir.merge([(list(b), b.n), ([], 0)], k=512),
                     mod.Reservoir.merge([a, (list(b), 40_000)], k=64,
                                         seed=9))
    assert out["port"] == out["jax"]


def test_compile_watch_bound_to_tracer():
    tr = Tracer()
    w = ttel.CompileWatch()
    w.register("decode", tp=1)
    assert w.observe("decode", (4, False), 1.0, 1.5) == (1, 0)
    w.bind(tr, pid=2)
    arr = np.zeros((2, 3), np.int32)
    assert w.observe("decode", (8, False), 2.0, 2.25, [arr]) == (1, 0)
    assert w.observe("decode", (8, False), 3.0, 3.1) == (0, 0)
    w.seal()
    assert w.observe("decode", (16, True), 4.0, 4.5) == (1, 1)
    m = tr.metrics
    assert m.value("compile.total") == 2 and m.value("compile.decode") == 2
    assert m.value("compile.unexpected") == 1
    assert m.value("compile.sealed") == 1.0
    spans = [r for r in tr.records() if r["name"] == "compile"]
    assert [(r["pid"], r["args"]["family"], r["args"]["signature"],
             r["args"]["sealed"], r["args"]["tp"]) for r in spans] == [
        (2, "decode", "i4[2x3]", False, 1), (2, "decode", "", True, 1)]
    assert [r["name"] for r in tr.records() if r["kind"] == "event"] == [
        "programs_sealed", "unexpected_recompile"]
    assert w.compiles == 3 and w.unexpected_recompiles == 1


# -- the engine's traces against JAX's ---------------------------------------

def _sig(tracer):
    out = []
    for r in tracer.records():
        if r["name"] in PROGRAM_RECORDS:
            continue
        args = tuple(sorted((k, v) for k, v in r["args"].items()
                            if not k.endswith("_s")))
        out.append((r["kind"], r["name"], r["trace"], r["pid"], args))
    return out


def _lifecycle(kind, eng_cls, sp_cls, monkey_cls, model, ragged, overlap):
    """Run one lifecycle scenario; (tracer, engine, request ids)."""
    tr = (jtel if eng_cls is JEngine else ttel).Tracer()
    kw = dict(KW, ragged=ragged, tracer=tr)
    if eng_cls is JEngine:
        if ragged:
            kw["overlap"] = False
    else:
        kw["device"] = "cpu"
    if kind == "failed":
        kw.update(max_dispatch_retries=0, retry_backoff_s=0.0)
    if kind == "preempted":
        kw.update(admission="optimistic", num_blocks=12)
    eng = eng_cls(model, **kw)
    if kind == "done_aborted":
        rids = [eng.add_request(_prompt(seed=s),
                                sp_cls(max_new_tokens=8 if s else 64))
                for s in range(2)]
        for _ in range(4):
            eng.step()
        eng.cancel(rids[0])
        eng.run_to_completion()
    elif kind == "failed":
        monkey = monkey_cls(seed=0, p_dispatch=1.0).attach(eng)
        rids = [eng.add_request(_prompt(), sp_cls(max_new_tokens=8))]
        eng.run_to_completion()
        monkey.detach(eng)
    else:
        rids = [eng.add_request(_prompt(seed=s), sp_cls(max_new_tokens=24))
                for s in range(3)]
        eng.run_to_completion()
    eng.stats()
    return tr, eng, rids


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("kind", ["done_aborted", "failed", "preempted"])
def test_engine_trace_equals_jax(models, ragged, kind):
    jm, tm = models
    jtr, jeng, jrids = _lifecycle(kind, JEngine, JParams, JMonkey, jm,
                                  ragged, False)
    ttr, teng, trids = _lifecycle(kind, ServingEngine, SamplingParams,
                                  ChaosMonkey, tm, ragged, False)
    states = [teng.request(r).state for r in trids]
    assert states == [jeng.request(r).state for r in jrids]
    assert [teng.result(r).tolist() for r in trids] == \
        [jeng.result(r).tolist() for r in jrids]
    want = {"done_aborted": ["aborted", "done"], "failed": ["failed"],
            "preempted": ["done"] * 3}[kind]
    assert states == want
    if kind == "preempted":
        assert teng.preemptions > 0
        assert any(r["name"] == "preempt" for r in ttr.records())
    assert _sig(ttr) == _sig(jtr)
    ends = [r for r in ttr.records() if r["kind"] == "end"]
    assert sorted(r["args"]["state"] for r in ends) == sorted(want)
    tkeys = {k for k in ttr.metrics.snapshot()["counters"]} | \
        {k for k in ttr.metrics.snapshot()["gauges"]}
    jkeys = {k for k in jtr.metrics.snapshot()["counters"]} | \
        {k for k in jtr.metrics.snapshot()["gauges"]}
    t_eng = {k for k in tkeys if k.startswith("engine.")}
    j_eng = {k for k in jkeys if k.startswith("engine.")}
    assert t_eng - j_eng == {f"engine.{k}" for k in PORT_ONLY_KEYS}
    assert j_eng - t_eng == set()
    # every numeric stats() value is mirrored under engine.*
    st = teng.stats()
    for k, v in st.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert ttr.metrics.value(f"engine.{k}") == pytest.approx(v), k


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_tracer_off_is_bitwise_noop(models, ragged):
    _, tm = models
    outs = {}
    for tag in ("off", "on"):
        tr = Tracer() if tag == "on" else None
        eng = ServingEngine(tm, seed=7, tracer=tr, ragged=ragged,
                            device="cpu", **KW)
        rids = [eng.add_request(
            _prompt(seed=s),
            SamplingParams(max_new_tokens=8,
                           temperature=1.0 if s == 1 else 0.0,
                           top_k=5 if s == 1 else None))
            for s in range(3)]
        eng.run_to_completion()
        st = {k: v for k, v in eng.stats().items()
              if not k.endswith("_s")}
        outs[tag] = ([eng.result(r).tolist() for r in rids], st,
                     prng_key(eng))
        if tr is None:
            assert eng.request(rids[0]).trace_id is None
            assert eng.dec.cache.tracer is None
    assert outs["on"] == outs["off"]


def prng_key(eng):
    return np.asarray(eng._key).tolist()


def test_profile_every_histograms(models):
    _, tm = models
    with pytest.raises(ValueError, match="profile_every"):
        ServingEngine(tm, profile_every=0, device="cpu", **KW)
    outs = {}
    for n in (None, 2, 1):
        tr = Tracer()
        eng = ServingEngine(tm, ragged=True, seed=5, tracer=tr,
                            profile_every=n, device="cpu", **KW)
        rids = [eng.add_request(
            _prompt(seed=s),
            SamplingParams(max_new_tokens=8,
                           temperature=0.9 if s == 2 else 0.0))
            for s in range(3)]
        eng.run_to_completion()
        st = eng.stats()
        outs[n] = [eng.result(r).tolist() for r in rids]
        h = tr.metrics.histograms
        if n is None:
            assert st["profiled_dispatches"] == 0
            assert not any(k.startswith("profile.") for k in h)
            assert not any(r["name"] == "profile_sample"
                           for r in tr.records())
            continue
        assert st["profiled_dispatches"] > 0
        for name in ("profile.host_schedule_s", "profile.dispatch_queue_s",
                     "profile.device_execute_s"):
            assert h[name].n == st["profiled_dispatches"], name
        fams = [k for k in h if k.startswith("profile.device_execute_s.")]
        assert fams == ["profile.device_execute_s.ragged"]
        assert h[fams[0]].n == st["profiled_dispatches"]
        samples = [r for r in tr.records() if r["name"] == "profile_sample"]
        assert len(samples) == st["profiled_dispatches"]
        assert {r["args"]["kind"] for r in samples} == {"dispatch:ragged"}
        if n == 1:
            assert st["profiled_dispatches"] == st["device_dispatches"]
    assert outs[None] == outs[2] == outs[1]
    # without a tracer the engine keeps a registry of its own
    eng = ServingEngine(tm, ragged=True, profile_every=1, device="cpu",
                        **KW)
    eng.add_request(_prompt(), SamplingParams(max_new_tokens=4))
    eng.run_to_completion()
    assert eng._profile_metrics().histograms[
        "profile.device_execute_s"].n == eng.profiled_dispatches > 0


def test_slo_ttft_fed_once_across_preemption(models):
    _, tm = models
    tr = Tracer()
    eng = ServingEngine(tm, tracer=tr, admission="optimistic",
                        slo=SLOPolicy("i", ttft_p99_s=30.0, itl_p99_s=30.0),
                        device="cpu", **dict(KW, num_blocks=10))
    rids = [eng.add_request(_prompt(seed=s),
                            SamplingParams(max_new_tokens=40))
            for s in range(3)]
    eng.run_to_completion()
    st = eng.stats()
    assert st["preemptions"] >= 1
    assert all(eng.request(r).state == "done" for r in rids)
    pol = st["slo"]["policies"]["i"]
    assert pol["metrics"]["ttft"]["windows"]["1800s"]["n"] == len(rids)
    assert pol["metrics"]["itl"]["windows"]["1800s"]["n"] > 0
    assert tr.metrics.histogram("engine.ttft_s").snapshot()["n"] == 3
    assert st["slo_min_headroom"] == pol["headroom"] > 0
    assert tr.metrics.value("slo.i.headroom") == pol["headroom"]
    eng.clear_finished()
    st = eng.stats()
    assert st["slo"]["policies"]["i"]["metrics"]["ttft"]["windows"][
        "1800s"]["n"] == 0 and st["profiled_dispatches"] == 0


def test_trace_report_reads_port_export(models, tmp_path):
    from tools.trace_report import analyze
    _, tm = models
    tr = Tracer()
    eng = ServingEngine(tm, tracer=tr, device="cpu", **KW)
    for s in range(2):
        eng.add_request(_prompt(seed=s), SamplingParams(max_new_tokens=6))
    eng.run_to_completion()
    path = tr.export(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    rep = analyze(doc)
    assert rep["requests"]["begun"] == 2
    assert rep["requests"]["states"] == {"done": 2}
    assert set(rep["phases"]) >= {"queued", "prefill", "decode"}
    assert rep["replicas"]["replica0"]["dispatches"]
    assert doc["metrics"]["counters"]["trace.requests"] == 2


def test_watch_engine_reports_stall(models, tmp_path):
    _, tm = models
    tr = Tracer()
    eng = ServingEngine(tm, tracer=tr, device="cpu", **KW)
    eng.add_request(_prompt(), SamplingParams(max_new_tokens=4))
    eng.step()
    dump = str(tmp_path / "hang.txt")
    reports = []
    wd = watch_engine(eng, timeout=0.25, poll_interval=0.05,
                      on_hang=reports.append, dump_path=dump)
    try:
        deadline = time.monotonic() + 5.0
        while not reports and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert reports, "the watchdog never reported the stall"
    text = reports[0]
    assert "hang detected" in text and "serving engine state:" in text
    assert "flight recorder:" in text and "[begin] request" in text
    assert "---- device state ----" in text
    assert text in open(dump).read()
    doc = json.load(open(dump + ".trace.json"))
    assert any(e.get("name") == "queued" for e in doc["traceEvents"])
    # the wrapped step still serves
    eng.run_to_completion()
    assert eng.stats()["finished"] == 1
