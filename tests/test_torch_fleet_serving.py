"""The fleet Router and ``ServingEngine.adopt_request`` in the port against
the JAX package's, in process, on the CPU.

JAX's ``LlamaForCausalLM`` at ``tests/test_fleet_serving.py``'s geometry
(``hidden_size=64``, 2 layers, vocab 256, its ``KW``) is built from
``paddle.seed(0)`` and its parameters carried into the port's model by
``load_numpy_state``; each Router builds its replicas from its own model.
Held against JAX, scenario by scenario (``test_fleet_serving.py``'s):
the tie-break, affinity on and off, the spill, fleet saturation shedding,
cross-replica greedy identity, failover mid-decode and mid-prefill
through a ``ChaosMonkey`` wedge, and JAX's ``TestDpTp`` (dp 2 x tp 2,
also through a wedge): the replica each request lands on, the
routing and breaker counters, the replicas' health records and the greedy
streams are equal. ``adopt_request`` (mid-history, a finished history,
the queue-cap bypass, the kept submit time) against JAX's. The port alone
(the same assertions as JAX's tests): the stall strike, probation and the
re-wedge on probation, ``clear_finished``, the SLO headroom roll-up, one
continuous request span across replica pids with fleet events on
``FLEET_PID``, ``tp=2`` replicas placed on the rows of the device grid
and ``devices`` with tp 1 raising as JAX's engine does; decoders over one weight tree (fused
or not) sharing its tensors with pools of their own, and a Router over
such replicas serving one engine's streams through a failover. The GPT
twin's failover (``test_fleet_serving.py::test_gpt_twin_failover``):
replicas built by an ``engine_factory`` over ``PagedGPTDecoder``, a
wedge mid-decode, the streams and fleet view equal JAX's. One torch
thread.
"""
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.inference as jinf  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.utils.chaos import ChaosMonkey as JMonkey  # noqa: E402
import paddle_tpu_torch.inference as tinf  # noqa: E402
from paddle_tpu_torch.inference import (EngineOverloaded, Router,  # noqa: E402
                                        SamplingParams, ServingEngine)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.utils.chaos import ChaosMonkey  # noqa: E402
from paddle_tpu_torch.utils.telemetry import (FLEET_PID,  # noqa: E402
                                              SLOPolicy, Tracer)

GEOM = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, num_hidden_layers=2, vocab_size=256,
            max_position_embeddings=256)
KW = dict(max_batch_size=3, num_blocks=24, block_size=8,
          prompt_buckets=(8, 16, 32), chunk_size=4, prefill_chunk=8)
# the fleet stats() counters held equal to JAX's
FLEET_KEYS = ("replicas", "healthy_replicas", "wedged_replicas",
              "routed_requests", "affinity_hits", "spills", "failovers",
              "migrated_requests", "migrated_done", "failed_migrations",
              "shed_requests", "finished", "generated_tokens",
              "goodput_tokens", "preemptions", "aborted", "failed",
              "retries", "dispatch_exhaustions", "device_dispatches",
              "prefix_cache_hit_rate")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """The JAX side and the port's: the same weights, and each side's
    classes and engine arguments."""
    paddle.seed(0)
    jm = JLlama(jax_tiny(**GEOM))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**GEOM), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    jax_side = types.SimpleNamespace(
        name="jax", model=jm, Router=jinf.Router, Engine=jinf.ServingEngine,
        SP=jinf.SamplingParams, Overloaded=jinf.EngineOverloaded,
        Monkey=JMonkey, kw=dict(KW),
        # tp replicas run the ragged engine, which the port collects
        # within its step: JAX's without overlap
        tp_kw=dict(KW, overlap=False))
    port = types.SimpleNamespace(
        name="port", model=tm, Router=tinf.Router, Engine=ServingEngine,
        SP=SamplingParams, Overloaded=EngineOverloaded, Monkey=ChaosMonkey,
        kw=dict(KW, device="cpu"),
        tp_kw=dict(KW, device="cpu", devices=["cpu"] * 4))
    return jax_side, port


def _prompts(n=4, seed=0, shared_prefix=True):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, GEOM["vocab_size"], 16).astype(np.int32)
    out = []
    for _ in range(n):
        tail = rng.randint(0, GEOM["vocab_size"], 8).astype(np.int32)
        out.append(np.concatenate([pre, tail]) if shared_prefix else tail)
    return out


def _oracle(s, prompts, max_new=12, **kw):
    eng = s.Engine(s.model, **dict(s.kw, **kw))
    outs = []
    for p in prompts:
        rid = eng.add_request(p, s.SP(max_new_tokens=max_new))
        eng.run_to_completion()
        outs.append(eng.result(rid).tolist())
    return outs


def _wedge(s, router, idx):
    return s.Monkey(seed=0).attach(router.replicas[idx].engine).wedge()


def _view(router, fids):
    """What is held equal across the two Routers."""
    st = router.stats()
    return {"replica": [router._record(f).replica for f in fids],
            "migrations": [router.migrations(f) for f in fids],
            "states": [router.request(f).state for f in fids],
            "tokens": [router.result(f).tolist() for f in fids],
            "fleet": {k: st["fleet"][k] for k in FLEET_KEYS},
            "health": [(rep.state, rep.wedges, rep.strikes)
                       for rep in router.replicas]}


# -- Router scenarios, each run on both sides --------------------------------

def _tie_break(s):
    prompts = _prompts(4, shared_prefix=False)
    router = s.Router(s.model, dp=2, **s.kw)
    fids = [router.add_request(p, s.SP(max_new_tokens=4)) for p in prompts]
    placed = [router._record(f).replica for f in fids]
    router.run_to_completion()
    assert placed[0] == 0 and set(placed) == {0, 1}
    return dict(_view(router, fids), placed=placed)


def _affinity_on(s):
    prompts = _prompts(4)
    router = s.Router(s.model, dp=2, **s.kw)
    fids = []
    for p in prompts:
        fids.append(router.add_request(p, s.SP(max_new_tokens=6)))
        router.run_to_completion()
    v = _view(router, fids)
    assert v["replica"] == [v["replica"][0]] * 4
    assert v["fleet"]["affinity_hits"] >= 3
    return v


def _affinity_off(s):
    prompts = _prompts(4)
    router = s.Router(s.model, dp=2, affinity=False, **s.kw)
    fids = [router.add_request(prompts[0], s.SP(max_new_tokens=6))]
    router.run_to_completion()
    fids += [router.add_request(p, s.SP(max_new_tokens=6))
             for p in prompts[1:3]]
    placed = [router._record(f).replica for f in fids]
    router.run_to_completion()
    assert placed[1:] == [0, 1]
    v = _view(router, fids)
    assert v["fleet"]["affinity_hits"] == 0
    return dict(v, placed=placed)


def _spill(s):
    prompts = _prompts(3)
    router = s.Router(s.model, dp=2, max_queue_depth=1, **s.kw)
    fids = [router.add_request(prompts[0], s.SP(max_new_tokens=6))]
    router.run_to_completion()
    home = router._record(fids[0]).replica
    router.replicas[home].engine.add_request(
        _prompts(1, seed=7, shared_prefix=False)[0], s.SP(max_new_tokens=4))
    fids.append(router.add_request(prompts[1], s.SP(max_new_tokens=6)))
    assert router._record(fids[1]).replica != home
    router.run_to_completion()
    v = _view(router, fids)
    assert v["fleet"]["spills"] == 1
    return v


def _saturated(s):
    router = s.Router(s.model, dp=2, max_queue_depth=0, **s.kw)
    with pytest.raises(s.Overloaded, match="saturated"):
        router.add_request(_prompts(1)[0], s.SP(max_new_tokens=4))
    with pytest.raises(ValueError, match="empty prompt"):
        router.add_request([], s.SP(max_new_tokens=4))
    with pytest.raises(ValueError, match="bucket"):
        router.add_request(np.zeros(99, np.int32), s.SP(max_new_tokens=4))
    v = _view(router, [])
    assert v["fleet"]["shed_requests"] == 1
    return v


def _cross_replica(s):
    prompts = _prompts(2)
    router = s.Router(s.model, dp=2, **s.kw)
    outs = []
    for p in prompts:
        row = []
        for rep in router.replicas:
            rid = rep.engine.add_request(p, s.SP(max_new_tokens=12))
            rep.engine.run_to_completion()
            row.append(rep.engine.result(rid).tolist())
        assert row[0] == row[1]
        outs.append(row[0])
    assert outs == _oracle(s, prompts)
    return {"tokens": outs}


def _failover_decode(s):
    prompts = _prompts(4)
    oracle = _oracle(s, prompts)
    router = s.Router(s.model, dp=2, breaker_threshold=1,
                      max_dispatch_retries=1, retry_backoff_s=0.0, **s.kw)
    fids = [router.add_request(p, s.SP(max_new_tokens=12))
            for p in prompts]
    for _ in range(4):
        router.step()
    victim = router._record(fids[0]).replica
    assert len(router.request(fids[0]).out_tokens) > 0
    _wedge(s, router, victim)
    router.run_to_completion()
    v = _view(router, fids)
    assert v["tokens"] == oracle
    assert v["fleet"]["failovers"] == 1 and v["fleet"]["migrated_done"] >= 1
    assert router.replicas[victim].state == "wedged"
    return dict(v, victim=victim)


def _failover_prefill(s):
    rng = np.random.RandomState(3)
    shorts = _prompts(2, shared_prefix=False)
    long_p = rng.randint(0, GEOM["vocab_size"], 64).astype(np.int32)
    kw = {"prompt_buckets": (8, 16, 32, 64), "num_blocks": 32}
    oracle = _oracle(s, [long_p], max_new=8, **kw)
    router = s.Router(s.model, dp=2, breaker_threshold=1,
                      max_dispatch_retries=1, retry_backoff_s=0.0,
                      **dict(s.kw, **kw))
    fids = [router.add_request(p, s.SP(max_new_tokens=20)) for p in shorts]
    for _ in range(2):
        router.step()
    fid = router.add_request(long_p, s.SP(max_new_tokens=8))
    router.step()
    assert router.request(fid).state == "prefilling"
    victim = router._record(fid).replica
    _wedge(s, router, victim)
    router.run_to_completion()
    v = _view(router, fids + [fid])
    assert v["tokens"][-1] == oracle[0] and v["migrations"][-1] == 1
    assert v["fleet"]["failovers"] == 1
    return dict(v, victim=victim)


def _dp_tp(s, wedge=False):
    """tests/test_fleet_serving.py:470 TestDpTp: two tp-2 replicas (rows
    of the dp x tp device grid) serve greedy traffic token for token
    equal to one tp-1 engine; with ``wedge`` a replica wedged
    mid-decode hands its requests to the other tp replica."""
    prompts = _prompts(3)
    oracle = _oracle(s, prompts, max_new=10)
    router = s.Router(s.model, dp=2, tp=2, breaker_threshold=1,
                      max_dispatch_retries=1, retry_backoff_s=0.0,
                      **s.tp_kw)
    assert [rep.engine.tp for rep in router.replicas] == [2, 2]
    fids = []
    for p in prompts:
        fids.append(router.add_request(p, s.SP(max_new_tokens=10)))
        router.step()
    if wedge:
        router.step()
        victim = router._record(fids[0]).replica
        assert len(router.request(fids[0]).out_tokens) > 0
        _wedge(s, router, victim)
    router.run_to_completion()
    v = _view(router, fids)
    assert v["tokens"] == oracle
    if wedge:
        assert v["fleet"]["failovers"] == 1
    return v


SCENARIOS = {"tie_break": _tie_break, "affinity_on": _affinity_on,
             "affinity_off": _affinity_off, "spill": _spill,
             "saturated_shed": _saturated, "cross_replica": _cross_replica,
             "failover_mid_decode": _failover_decode,
             "failover_mid_prefill": _failover_prefill,
             "dp2_tp2": _dp_tp,
             "dp2_tp2_failover": lambda s: _dp_tp(s, wedge=True)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_matches_jax(sides, name):
    jax_side, port = sides
    got = SCENARIOS[name](port)
    assert got == SCENARIOS[name](jax_side)
    if name == "tie_break":
        # equal fleets route equal traffic equally
        assert SCENARIOS[name](port) == got


# -- adopt_request, against JAX ----------------------------------------------

def _adopt(s):
    prompt = _prompts(1)[0]
    full = _oracle(s, [prompt], max_new=14)[0]
    out = {}
    for cut in (1, 7, 13):
        eng = s.Engine(s.model, **s.kw)
        rid = eng.adopt_request(prompt, s.SP(max_new_tokens=14),
                                out_tokens=full[:cut])
        eng.run_to_completion()
        out[cut] = (eng.result(rid).tolist(), eng.stats()["recompute_tokens"])
        assert out[cut][0] == full
    eng = s.Engine(s.model, **s.kw)
    rid = eng.adopt_request(prompt, s.SP(max_new_tokens=14),
                            out_tokens=full)
    assert eng.request(rid).state == "done"
    rid2 = eng.adopt_request(prompt, s.SP(max_new_tokens=14,
                                          eos_token_id=full[3]),
                             out_tokens=full[:4])
    assert eng.request(rid2).state == "done"
    out["finished"] = (eng.result(rid).tolist(), eng.result(rid2).tolist())
    eng = s.Engine(s.model, max_queue_depth=0, **s.kw)
    with pytest.raises(s.Overloaded):
        eng.add_request(prompt, s.SP(max_new_tokens=4))
    t0 = time.perf_counter() - 100.0
    rid = eng.adopt_request(prompt, s.SP(max_new_tokens=4), t_submit=t0)
    assert eng._find_request(rid).t_submit == t0
    eng.run_to_completion()
    assert eng.request(rid).state == "done"
    out["bypass"] = eng.result(rid).tolist()
    return out


def test_adopt_request_matches_jax(sides):
    jax_side, port = sides
    assert _adopt(port) == _adopt(jax_side)


# -- the port's Router alone -------------------------------------------------

def test_stall_strike_trips_breaker(sides):
    _, s = sides
    router = Router(s.model, dp=2, breaker_threshold=2,
                    stall_timeout_s=0.6, **s.kw)
    fid = router.add_request(_prompts(1)[0], SamplingParams(max_new_tokens=10))
    router.step()
    rep = router.replicas[router._record(fid).replica]
    orig = rep.engine.step

    def slow_step():
        time.sleep(0.9)
        return orig()
    rep.engine.step = slow_step
    router.run_to_completion()
    assert rep.state == "wedged"
    assert router.stats()["fleet"]["failovers"] == 1
    assert router.request(fid).state == "done"


def test_probation_readmission_and_rewedge(sides):
    _, s = sides
    prompts = _prompts(4)
    router = Router(s.model, dp=2, breaker_threshold=1,
                    max_dispatch_retries=1, retry_backoff_s=0.0,
                    cooldown_steps=2, probation_steps=2, **s.kw)
    fid = router.add_request(prompts[0], SamplingParams(max_new_tokens=8))
    for _ in range(2):
        router.step()
    victim = router._record(fid).replica
    monkey = _wedge(s, router, victim)
    router.run_to_completion()
    rep = router.replicas[victim]
    assert rep.wedges == 1 and rep.state in ("wedged", "probation")
    monkey.detach(rep.engine)
    rep.engine.chaos = None
    for _ in range(3):
        router.step()
    assert rep.state == "probation"
    rids = [rep.engine.add_request(p, SamplingParams(max_new_tokens=6))
            for p in prompts]
    while router.step():
        pass
    assert rep.state == "healthy"
    assert all(rep.engine.request(r).state == "done" for r in rids)
    assert router.request(fid).state == "done"
    # a persistent fault: one faulty step on probation wedges again
    router = Router(s.model, dp=2, breaker_threshold=2,
                    max_dispatch_retries=0, retry_backoff_s=0.0,
                    cooldown_steps=1, probation_steps=4, **s.kw)
    fid = router.add_request(prompts[0], SamplingParams(max_new_tokens=8))
    for _ in range(2):
        router.step()
    rep = router.replicas[router._record(fid).replica]
    _wedge(s, router, rep.idx)
    router.run_to_completion()
    assert rep.wedges == 1 and router.request(fid).state == "done"
    for _ in range(3):
        router.step()
    assert rep.state == "probation"
    rep.engine.add_request(_prompts(1, seed=9)[0],
                           SamplingParams(max_new_tokens=8))
    assert rep.strikes == 0
    router.step()
    assert rep.wedges == 2 and rep.state == "wedged"


def test_clear_finished_resets_everything(sides):
    _, s = sides
    router = Router(s.model, dp=2, breaker_threshold=1,
                    max_dispatch_retries=1, retry_backoff_s=0.0, **s.kw)
    fids = [router.add_request(p, SamplingParams(max_new_tokens=8))
            for p in _prompts(4)]
    for _ in range(3):
        router.step()
    _wedge(s, router, router._record(fids[0]).replica)
    router.run_to_completion()
    before = router.stats()["fleet"]
    assert before["failovers"] >= 1 and before["migrated_requests"] >= 1
    router.clear_finished()
    st = router.stats()["fleet"]
    for key in ("routed_requests", "affinity_hits", "spills", "failovers",
                "migrated_requests", "migrated_done", "failed_migrations",
                "shed_requests", "finished", "generated_tokens",
                "goodput_tokens", "preemptions", "aborted", "failed",
                "retries", "dispatch_exhaustions", "journal_requests"):
        assert st[key] == 0, key
    assert st["itl_p50_s"] is None
    with pytest.raises(KeyError):
        router.result(fids[0])


def test_slo_headroom_rollup_and_registry(sides):
    _, s = sides
    tr = Tracer()
    router = Router(s.model, dp=2, tracer=tr,
                    slo=[SLOPolicy("interactive", ttft_p99_s=30.0)], **s.kw)
    for seed in range(4):
        router.add_request(_prompts(1, seed=seed)[0],
                           SamplingParams(max_new_tokens=4))
    router.run_to_completion()
    st = router.stats()
    fleet = st["fleet"]
    head = fleet["slo"]["headroom"]["interactive"]
    assert set(head) == {"0", "1"}
    assert fleet["slo"]["min_headroom"]["interactive"] == \
        pytest.approx(min(head.values()))
    assert len({id(rep.engine._slo) for rep in router.replicas}) == 2
    assert tr.metrics.value("fleet.routed_requests") == 4
    assert tr.metrics.value("fleet.slo.interactive.r1.headroom") == head["1"]
    assert tr.metrics.value("engine1.finished") == \
        st["replicas"][1]["finished"]
    # the fleet ITL: the replicas' reservoirs merged in proportion
    itls = [x for rep in router.replicas for x in rep.engine._itl_res]
    assert fleet["itl_p50_s"] == pytest.approx(float(np.quantile(itls, 0.5)))
    with pytest.raises(ValueError, match="engine_factory"):
        Router(s.model, dp=2, slo=[SLOPolicy("x", ttft_p99_s=1.0)],
               engine_factory=lambda r, d: None)


def test_migrated_request_is_one_span_across_replicas(sides):
    _, s = sides
    tr = Tracer()
    router = Router(s.model, dp=2, breaker_threshold=1,
                    max_dispatch_retries=0, retry_backoff_s=0.0,
                    tracer=tr, **s.kw)
    fid = router.add_request(_prompts(1)[0],
                             SamplingParams(max_new_tokens=24))
    for _ in range(4):
        router.step()
    src = router._record(fid).replica
    # the burst fails the request before the breaker trips: the drain
    # rescinds that end
    _wedge(s, router, src)
    router.run_to_completion()
    rec = router._requests[fid]
    assert rec.migrations == 1 and rec.replica != src
    recs = tr.records()
    begins = [r for r in recs if r["kind"] == "begin"
              and r["trace"] == rec.trace_id]
    ends = [r for r in recs if r["kind"] == "end"
            and r["trace"] == rec.trace_id]
    assert len(begins) == 1 and len(ends) == 1
    assert ends[0]["args"]["state"] == "done"
    assert (tr.metrics.value("trace.requests_failed") or 0) == 0
    pids = {r["pid"] for r in recs if r["kind"] == "span"
            and r["trace"] == rec.trace_id}
    assert {src, rec.replica} <= pids
    fleet_names = {"route", "breaker_strike", "breaker_wedge", "failover",
                   "migrate"}
    for name in fleet_names:
        evs = [r for r in recs if r["name"] == name]
        assert evs and all(r["pid"] == FLEET_PID for r in evs), name
    assert any(r["name"] == "adopt" and r["pid"] == rec.replica
               for r in recs)
    assert any(r["name"] == "healthy_replicas" and r["pid"] == FLEET_PID
               for r in recs)


def test_constructor_rules(sides):
    jax_side, s = sides
    # tp 2 replicas sit on the rows of the dp x tp grid of devices
    router = Router(s.model, dp=2, tp=2, devices=["cpu"] * 4, **s.kw)
    assert [r.engine.dec.devices for r in router.replicas] == \
        [[torch.device("cpu")] * 2] * 2
    assert all(r.engine.tp == 2 for r in router.replicas)
    router.close()
    with pytest.raises(ValueError, match="needs 4 devices"):
        Router(s.model, dp=2, tp=2, devices=["cpu"] * 3, **s.kw)
    with pytest.raises(ValueError, match="devices= requires"):
        Router(s.model, dp=2, devices=["cpu"], **s.kw)
    # the message JAX's engine raises for the same mistake
    with pytest.raises(ValueError, match="devices= requires"):
        jax_side.Engine(jax_side.model, devices=[jax.devices()[0]],
                        **jax_side.kw)
    with pytest.raises(ValueError, match="transport"):
        Router(s.model, dp=2, transport="tcp", **s.kw)
    with Router(s.model, dp=1, **s.kw) as router:
        fid = router.add_request(_prompts(1)[0],
                                 SamplingParams(max_new_tokens=3))
        router.run_to_completion()
        assert len(router.result(fid)) == 3
    assert router._closed


def test_replicas_share_one_weight_tree(sides):
    """Decoders built over one weight tree, fused or not, share every
    weight tensor and keep pools of their own; the tree given is left as
    it was. A Router over such replicas serves the streams of one engine
    on its own weights."""
    from paddle_tpu_torch.inference import PagedLlamaDecoder
    _, s = sides
    cfg = s.model.cfg
    base = PagedLlamaDecoder.from_model(s.model, num_blocks=24,
                                        block_size=8, device="cpu")
    tree = base.weights[0]
    raw = {k: v for k, v in tree.items() if k != "layers"}
    raw["layers"] = []
    for lw in tree["layers"]:
        q, k, v = torch.split(lw["wqkv"], [cfg.hidden_size, 32, 32], dim=1)
        g, u = torch.split(lw["wgu"], [cfg.intermediate_size] * 2, dim=1)
        raw["layers"].append(dict(lw, wq=q, wk=k, wv=v, wg=g, wu=u))
        del raw["layers"][-1]["wqkv"], raw["layers"][-1]["wgu"]
    names = [sorted(lw) for lw in raw["layers"]]
    decs = [PagedLlamaDecoder(cfg, t, num_blocks=24, block_size=8,
                              device="cpu")
            for t in (raw, raw, tree)]
    assert [sorted(lw) for lw in raw["layers"]] == names
    assert "wqkv" in decs[0].weights[0]["layers"][0]
    assert decs[2].weights[0]["layers"][0]["wqkv"] is \
        tree["layers"][0]["wqkv"]
    assert decs[0].weights[0]["head"] is decs[2].weights[0]["head"]
    assert len({id(d.cache.k) for d in decs + [base]}) == 4
    prompts = _prompts(4)
    want = _oracle(s, prompts)
    router = Router(None, dp=2, breaker_threshold=1, max_dispatch_retries=1,
                    retry_backoff_s=0.0,
                    engine_factory=lambda r, d: ServingEngine(
                        PagedLlamaDecoder(cfg, tree, num_blocks=24,
                                          block_size=8, device="cpu"),
                        **{k: v for k, v in KW.items()
                           if k not in ("num_blocks", "block_size")}))
    fids = [router.add_request(p, SamplingParams(max_new_tokens=12))
            for p in prompts]
    for _ in range(4):
        router.step()
    _wedge(s, router, router._record(fids[0]).replica)
    router.run_to_completion()
    assert [router.result(f).tolist() for f in fids] == want
    assert router.stats()["fleet"]["migrated_requests"] >= 1


def _gpt_failover(s):
    """test_fleet_serving.py::test_gpt_twin_failover: replicas from a
    factory over ``PagedGPTDecoder``; the replica serving the first
    request is wedged after three steps and its requests finish on the
    other, equal to one engine's streams."""
    ekw = {k: v for k, v in s.kw.items()
           if k not in ("num_blocks", "block_size")}

    def factory(idx, devs):
        return s.Engine(s.make_dec(), max_dispatch_retries=1,
                        retry_backoff_s=0.0, **ekw)

    prompts = _prompts(3)
    single = factory(0, None)
    oracle = []
    for p in prompts:
        rid = single.add_request(p, s.SP(max_new_tokens=10))
        single.run_to_completion()
        oracle.append(single.result(rid).tolist())
    router = s.Router(None, dp=2, breaker_threshold=1,
                      engine_factory=factory)
    fids = [router.add_request(p, s.SP(max_new_tokens=10)) for p in prompts]
    for _ in range(3):
        router.step()
    _wedge(s, router, router._record(fids[0]).replica)
    router.run_to_completion()
    v = _view(router, fids)
    assert v["fleet"]["failovers"] >= 1
    assert v["tokens"] == oracle
    assert all(router.request(f).state == "done" for f in fids)
    return v


def test_gpt_twin_failover_matches_jax(sides):
    from paddle_tpu.inference.gpt_decode import \
        PagedGPTDecoder as JaxGPTDecoder
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.inference import PagedGPTDecoder
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    jax_side, port = sides
    geom = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**geom))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**geom), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    jax_gpt = types.SimpleNamespace(
        **vars(jax_side),
        make_dec=lambda: JaxGPTDecoder(jm, num_blocks=24, block_size=8))
    port_gpt = types.SimpleNamespace(
        **vars(port),
        make_dec=lambda: PagedGPTDecoder.from_model(
            tm, num_blocks=24, block_size=8, device="cpu"))
    port_gpt.kw = {k: v for k, v in port.kw.items() if k != "device"}
    assert _gpt_failover(port_gpt) == _gpt_failover(jax_gpt)
