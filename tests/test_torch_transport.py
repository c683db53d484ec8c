"""The process transport of the port's fleet Router, and the kernel
build's lock across processes.

- the build lock: two spawned processes call ``load_library`` at once
  with ``nvcc`` stubbed by a slow script; the library is built once
  (three stub calls: two sources and the link), one process reports
  ``built`` and both read the ptxas notes whole;
- a process fleet (``transport="process"``, dp 2, spawned workers on the
  CPU) gives the in-process fleet's streams with the reply of each
  replica's first step dropped by the parent-side fault hook (the RPC
  retried under the same message id, the step run once, every token in
  the journal once), the journal gauges, the telemetry forwarded from
  the workers with disjoint trace ids, and ``clear_finished``;
- a tp-2 replica in a spawned worker (its row of the device grid
  computed there) gives the in-process fleet's streams;
- a SIGKILL: ``kill_worker`` while replica 0's requests prefill, then
  ``inject_kill`` (the worker kills itself) mid-decode on the same
  fleet: each time the Router sees the pipe close, drains the replica
  from its journal, migrates token-identically and respawns the worker
  onto probation, which clean steps then promote.
- the GPT twin (JAX ``test_transport_fleet.py::test_gpt_twin_process_
  fleet_identity``): a process fleet of replicas built in the workers by
  a module-level ``engine_factory`` over ``PagedGPTDecoder``
  (``tests/_torch_gpt_worker.py``) gives one engine's streams; and a
  ``GPTForCausalLM`` given to the Router crosses the pipe as its config
  and ``model_state``, its workers' streams equal to the in-process
  fleet's.
The in-process streams are held against JAX's Router in
``test_torch_fleet_serving.py``. A spawned worker runs on the parent's
torch thread count (one here).
"""
import multiprocessing as mp
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference import Router, SamplingParams  # noqa: E402
from paddle_tpu_torch.inference.transport import (  # noqa: E402
    InProcTransport, ProcTransport)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.utils.chaos import InjectedTransportError  # noqa: E402
from paddle_tpu_torch.utils.telemetry import Tracer  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_build_lock_worker  # noqa: E402
import _torch_gpt_worker  # noqa: E402

GEOM = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, num_hidden_layers=2, vocab_size=256,
            max_position_embeddings=256)
KW = dict(max_batch_size=3, num_blocks=24, block_size=8,
          prompt_buckets=(8, 16, 32), chunk_size=4, prefill_chunk=8,
          device="cpu")
PROC = dict(transport="process", rpc_timeout_s=90.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(llama_tiny(**GEOM), seed=3, device="cpu")


def _prompts(n=3, seed=0):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, GEOM["vocab_size"], 16).astype(np.int32)
    return [np.concatenate(
        [pre, rng.randint(0, GEOM["vocab_size"], 8).astype(np.int32)])
        for _ in range(n)]


def _inproc(model, prompts, max_new):
    """The in-process fleet's streams."""
    with Router(model, dp=2, **KW) as router:
        for rep in router.replicas:
            assert isinstance(rep.transport, InProcTransport)
        fids = [router.add_request(p, SamplingParams(max_new_tokens=max_new))
                for p in prompts]
        router.run_to_completion()
        return [router.result(f).tolist() for f in fids]


def _drain(router, budget_s=120.0):
    t0 = time.perf_counter()
    while router.has_work:
        router.step()
        assert time.perf_counter() - t0 < budget_s, "fleet wedged"


def test_build_lock_builds_once_across_processes(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    (src / "common.cuh").write_text("// header\n")
    calls = tmp_path / "nvcc_calls.txt"
    nvcc = tmp_path / "nvcc"
    # a slow stand-in for nvcc: notes each call, writes its -o output,
    # prints a long report (so a half-written notes file would show)
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "time.sleep(0.4)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'\\0' * 4096)\n"
        "print('ptxas info : Used 168 registers ' * 4000)\n")
    nvcc.chmod(0o755)
    ctx = mp.get_context("spawn")
    start = time.time() + 3.0
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [ctx.Process(target=_torch_build_lock_worker.build,
                         args=(str(tmp_path / "build"), str(src), str(nvcc),
                               str(o), start)) for o in outs]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    import json
    res = [json.loads(o.read_text()) for o in outs]
    lines = calls.read_text().splitlines()
    assert len(lines) == 3 and sum("-shared" in ln for ln in lines) == 1
    assert sorted(r["built"] for r in res) == [False, True]
    assert res[0]["lib"] == res[1]["lib"]
    assert res[0]["ptxas"] == res[1]["ptxas"]
    assert set(res[0]["ptxas"]) == {"a.cu", "b.cu"}
    assert all(len(v) > 100_000 for v in res[0]["ptxas"].values())
    build = tmp_path / "build"
    assert not [p for p in build.iterdir() if p.name.startswith(".notes_")
                or p.name.startswith("tmp_")]


def test_process_fleet_identity_journal_retry_telemetry(model):
    dropped = set()

    def drop_first_step_reply(replica):
        def hook(stage, verb):
            if stage == "recv" and verb == "step" and replica not in dropped:
                dropped.add(replica)
                raise InjectedTransportError("test: dropped reply")
        return hook

    prompts = _prompts(4)
    want = _inproc(model, prompts, 10)
    tr = Tracer()
    with Router(model, dp=2, tracer=tr, **PROC, **KW) as router:
        for r, rep in enumerate(router.replicas):
            assert isinstance(rep.transport, ProcTransport)
            assert rep.engine is None
            rep.transport.fault_hook = drop_first_step_reply(r)
        fids = [router.add_request(p, SamplingParams(max_new_tokens=10))
                for p in prompts]
        fleet = router.stats()["fleet"]
        assert fleet["journal_requests"] == 4 and fleet["journal_bytes"] > 0
        _drain(router)
        assert dropped == {0, 1}
        for f, w in zip(fids, want):
            assert router.request(f).state == "done"
            assert router.result(f).tolist() == w
        st = router.stats()
        fleet = st["fleet"]
        assert fleet["finished"] == 4 and fleet["rpc_retries"] >= 2
        assert fleet["worker_exits"] == fleet["worker_restarts"] == 0
        assert fleet["heartbeat_misses"] == 0
        # the workers' records reached the parent: each request one
        # span, its ids from its replica's range
        recs = tr.records()
        ends = [r for r in recs if r["kind"] == "end"]
        assert sorted(r["trace"] // 1_000_000_000 for r in ends) == \
            sorted(router._record(f).replica + 1 for f in fids)
        assert {r["pid"] for r in recs if r["kind"] == "span"} == {0, 1}
        assert tr.metrics.value("engine1.finished") == \
            st["replicas"][1]["finished"]
        router.clear_finished()
        fleet = router.stats()["fleet"]
        assert fleet["journal_requests"] == fleet["journal_bytes"] == 0
        assert fleet["rpc_retries"] == fleet["finished"] == 0
    for rep in router.replicas:
        assert not rep.transport.alive()


def test_process_fleet_tp2(model):
    """A spawned worker builds a tp-2 engine on its own row of the dp x tp
    device grid (the devices cross the pipe as strings; the worker
    computes its row): one tp-2 replica gives the in-process fleet's
    streams."""
    prompts = _prompts(3)
    want = _inproc(model, prompts, 8)
    with Router(model, dp=1, tp=2, devices=["cpu"] * 2, **PROC,
                **KW) as router:
        assert isinstance(router.replicas[0].transport, ProcTransport)
        assert router.replicas[0].transport.spec.devices == ["cpu"] * 2
        fids = [router.add_request(p, SamplingParams(max_new_tokens=8))
                for p in prompts]
        _drain(router)
        assert [router.result(f).tolist() for f in fids] == want
        st = router.stats()
        assert st["replicas"][0]["tp"] == 2
        assert st["fleet"]["finished"] == 3


def test_sigkill_migrates_then_respawns(model):
    p1, p2 = _prompts(3, seed=2), _prompts(4, seed=1)
    want1, want2 = _inproc(model, p1, 8), _inproc(model, p2, 12)
    with Router(model, dp=2, breaker_threshold=1, probation_steps=2,
                **PROC, **KW) as router:
        victim = router.replicas[0]
        fids1 = [router.add_request(p, SamplingParams(max_new_tokens=8))
                 for p in p1]
        router.step()                   # replica 0 still prefilling
        gen = victim.transport.generation
        victim.transport.kill_worker()
        _drain(router)
        for f, w in zip(fids1, want1):
            assert router.result(f).tolist() == w
        assert victim.transport.generation == gen + 1
        fids2 = [router.add_request(p, SamplingParams(max_new_tokens=12))
                 for p in p2]
        for _ in range(4):
            router.step()
        owned = [f for f, rec in router._requests.items()
                 if rec.replica == 0 and router.request(f).state == "running"
                 and router.request(f).out_tokens]
        assert owned, "nothing decoding on replica 0"
        victim.transport.inject_kill()
        _drain(router)
        fleet = router.stats()["fleet"]
        assert fleet["worker_exits"] == fleet["worker_restarts"] == 2
        assert fleet["failovers"] == 2 and fleet["migrated_done"] >= 1
        assert fleet["failed_migrations"] == 0
        assert victim.transport.generation == gen + 2
        assert victim.state == "probation"
        for f, w in zip(fids2, want2):
            assert router.request(f).state == "done"
            assert router.result(f).tolist() == w
        f3 = router.add_request(_prompts(1, seed=7)[0],
                                SamplingParams(max_new_tokens=6))
        _drain(router)
        assert router.request(f3).state == "done"
        assert victim.state == "healthy"


def test_gpt_process_fleet_identity():
    """A factory-built GPT process fleet gives one in-process engine's
    streams; a GPT model given to the Router itself travels as its
    config and parameters and gives the in-process fleet's streams."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    prompts = _prompts(2, seed=4)
    single = _torch_gpt_worker.gpt_engine(0, None)
    oracle = []
    for p in prompts:
        rid = single.add_request(p, SamplingParams(max_new_tokens=8))
        single.run_to_completion()
        oracle.append(single.result(rid).tolist())
    with Router(None, dp=2, engine_factory=_torch_gpt_worker.gpt_engine,
                **PROC) as router:
        fids = [router.add_request(p, SamplingParams(max_new_tokens=8))
                for p in prompts]
        _drain(router, budget_s=180.0)
        assert [router.result(f).tolist() for f in fids] == oracle
    gm = GPTForCausalLM(GPTConfig(**_torch_gpt_worker.GPT_GEOM), seed=0,
                        device="cpu")
    want = _inproc(gm, prompts, 8)
    assert want == oracle
    with Router(gm, dp=2, **PROC, **KW) as router:
        assert router.replicas[0].transport.spec.config == gm.cfg
        fids = [router.add_request(p, SamplingParams(max_new_tokens=8))
                for p in prompts]
        _drain(router, budget_s=180.0)
        assert [router.result(f).tolist() for f in fids] == want
