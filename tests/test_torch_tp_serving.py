"""Tensor-parallel serving in the port against the JAX package's manual
shard_map path, on the CPU.

JAX runs its tp programs on the virtual CPU devices of
``tests/conftest.py``; the port runs every shard on ``"cpu"`` (a device
may repeat). Held:
- the placement table (``distributed/spec_layout.py``) against JAX's
  ``CANONICAL_SPECS`` key for key and spec for spec; strict mode; a
  quantized pair's placement, an int4 row shard repacked over its own
  in-dim; ``fleet_device_slices`` against JAX's grid rows;
- ``int8_all_reduce`` against JAX's on the same seeded inputs, within
  JAX's own bound of the exact sum (``tests/test_tp_serving.py:150``),
  and the indivisible fallback exact;
- engine streams at tp 2 and tp 4 (the kv-heads-4 twin) token for token
  equal to JAX's tp engine and to the port's tp 1, on
  ``tests/test_tp_serving.py``'s workloads: mixed lengths with chunked
  prefill, a prefix splice, rich sampling, an EOS cut, preemption with
  recompute. JAX's ragged engine runs with ``overlap=False``;
- ``tp_comm="int8"``: prefill logits within rel 0.02 of fp32 comm with
  the same argmax (the reference's stream-identity half of that test is
  red in JAX itself, so it is not held);
- the tp decoder's ``generate()``;
- weights carried from JAX's tp decoder (per-projection, interleaved
  int4) give its logits within 1e-5;
- every surface rule of ``TestTPEngineSurface``, the graph capture
  refusal across distinct cards, and the default device list.
One torch thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import spec_layout as jlayout  # noqa: E402
from paddle_tpu.inference import SamplingParams as JParams  # noqa: E402
from paddle_tpu.inference import ServingEngine as JEngine  # noqa: E402
from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JDecoder  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch.distributed import ProcessMesh  # noqa: E402
from paddle_tpu_torch.distributed import spec_layout as tlayout  # noqa: E402
from paddle_tpu_torch.distributed.collective import (  # noqa: E402
    all_gather_logits, all_reduce, int8_all_reduce)
from paddle_tpu_torch.inference import (PagedLlamaDecoder,  # noqa: E402
                                        SamplingParams, ServingEngine)
from paddle_tpu_torch.inference.programs import ProgramSet  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.ops.qweight import (  # noqa: E402
    QWeight, halves_from_interleaved, int4_values)
from paddle_tpu_torch.utils.telemetry import CompileWatch  # noqa: E402
from _torch_serving_cases import assert_identical  # noqa: E402

ENGINE = dict(max_batch_size=3, num_blocks=96, block_size=8,
              prompt_buckets=(8, 16, 32, 64), chunk_size=4, prefill_chunk=8,
              ragged=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    paddle.seed(0)
    jm = JLlama(jax_tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def kvh2():
    return _pair()


@pytest.fixture(scope="module")
def kvh4():
    return _pair(num_key_value_heads=4)


def _jmesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _tmesh(n):
    return ProcessMesh(list(range(n)), ["tp"], devices=["cpu"] * n)


def _prompts(lengths, seed=17):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


def _serve(eng, reqs):
    params = JParams if isinstance(eng, JEngine) else SamplingParams
    rids = [eng.add_request(p, params(**sp)) for p, sp in reqs]
    eng.run_to_completion()
    return [eng.result(r).tolist() for r in rids], eng.stats()


def _jax(jm, reqs, **kw):
    return _serve(JEngine(jm, overlap=False, **dict(ENGINE, **kw)), reqs)


def _port(tm, reqs, tp=1, **kw):
    devs = dict(devices=["cpu"] * tp) if tp > 1 else dict(device="cpu")
    return _serve(ServingEngine(tm, tp=tp, **devs, **dict(ENGINE, **kw)),
                  reqs)


# -- the placement table ----------------------------------------------------------

def test_table_equals_jax():
    assert set(tlayout.CANONICAL_SPECS) == set(jlayout.CANONICAL_SPECS)
    tl, jl = tlayout.SpecLayout(), jlayout.SpecLayout()
    for name, spec in jlayout.CANONICAL_SPECS.items():
        assert tlayout.CANONICAL_SPECS[name] == tuple(spec), name
        assert tl.spec(name, strict=True) == tuple(jl.spec(name)), name
    assert tl.spec("wot_is_this") == tuple(jl.spec("wot_is_this")) == ()
    with pytest.raises(KeyError, match="no canonical"):
        tl.spec("wot_is_this", strict=True)
    w = {"embed": torch.zeros(8, 4),
         "layers": [{"wq": torch.zeros(4, 4), "mystery": torch.zeros(4)}]}
    with pytest.raises(KeyError, match="mystery"):
        tl.shard_tree(w, ["cpu"] * 2, strict=True)


def test_quantized_placement_and_int4_repack():
    """Column shards cut columns and scales; row shards cut in-rows and
    keep the scale whole; an int4 shard (of halves packed directly or
    repacked from JAX's interleaved bytes) is halves over its own in-dim
    and dequantizes to exactly its rows and columns of the whole
    weight."""
    rng = np.random.RandomState(0)
    vals = torch.from_numpy(rng.randint(-8, 8, (16, 8)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
    u = vals.view(torch.uint8)
    inter = QWeight(halves_from_interleaved(
        ((u[0::2] & 0x0F) | ((u[1::2] & 0x0F) << 4)).view(torch.int8)),
        scale, "int4_halves")
    halves = QWeight(((u[:8] & 0x0F) | ((u[8:] & 0x0F) << 4))
                     .view(torch.int8), scale, "int4_halves")
    assert torch.equal(inter.q, halves.q)
    for w in (inter, halves):
        assert torch.equal(int4_values(w), vals)
        for s in range(2):
            col = tlayout.shard_qweight(w, "out", s, 2, "cpu")
            row = tlayout.shard_qweight(w, "in", s, 2, "cpu")
            assert col.kind == row.kind == "int4_halves"
            assert torch.equal(int4_values(col), vals[:, 4 * s:4 * s + 4])
            assert torch.equal(col.scale, scale[4 * s:4 * s + 4])
            assert torch.equal(int4_values(row), vals[8 * s:8 * s + 8])
            assert torch.equal(row.scale, scale)
            assert row.q.is_contiguous() and col.q.is_contiguous()
    tree = {"layers": [{"wq": QWeight(vals, scale, "int8"),
                        "wo": QWeight(vals, scale, "int8")}]}
    shards = tlayout.SpecLayout().shard_tree(tree, ["cpu"] * 2, strict=True)
    assert shards[1]["layers"][0]["wq"].q.shape == (16, 4)
    assert shards[1]["layers"][0]["wq"].scale.shape == (4,)
    assert shards[1]["layers"][0]["wo"].q.shape == (8, 8)
    assert torch.equal(shards[1]["layers"][0]["wo"].scale, scale)


def test_fleet_device_slices_equal_jax():
    jrows = [[d.id for d in row]
             for row in jlayout.SpecLayout().fleet_device_slices(2, 2)]
    trows = tlayout.SpecLayout().fleet_device_slices(
        2, 2, [f"cuda:{i}" for i in range(8)])
    assert [[d.index for d in row] for row in trows] == jrows == [[0, 1],
                                                                  [2, 3]]
    assert tlayout.SpecLayout().fleet_device_slices(
        2, 2, ["cpu"] * 4) == [[torch.device("cpu")] * 2] * 2
    with pytest.raises(ValueError, match="needs 6 devices"):
        tlayout.SpecLayout().fleet_device_slices(3, 2, ["cpu"] * 4)


# -- the collectives ----------------------------------------------------------------

def _jax_collective(body, x, n):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("rank",))
    f = shard_map(body, mesh=mesh, in_specs=(P("rank"),),
                  out_specs=P("rank"), check_vma=False)
    return np.asarray(jax.jit(f)(x))


@pytest.mark.parametrize("n", [2, 4])
def test_int8_all_reduce_against_jax(n):
    from paddle_tpu.distributed.collective import int8_all_reduce_body
    x = np.random.RandomState(0).randn(n, 6, 64).astype(np.float32)
    want = _jax_collective(int8_all_reduce_body(n), x, n)
    psum = _jax_collective(lambda a: jax.lax.psum(a, "rank"), x, n)
    got = int8_all_reduce([torch.from_numpy(x[i:i + 1]) for i in range(n)])
    exact = all_reduce([torch.from_numpy(x[i:i + 1]) for i in range(n)])
    step = np.abs(x).max() / 127.0 * n + np.abs(psum).max() / 127.0
    for i in range(n):
        g = got[i].numpy()
        assert g.dtype == np.float32 and g.shape == (1, 6, 64)
        assert np.abs(g - psum[i:i + 1]).max() <= 2.05 * step
        np.testing.assert_allclose(g, want[i:i + 1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(exact[i].numpy(), psum[i:i + 1],
                                   rtol=0, atol=1e-5)


def test_int8_indivisible_falls_back_exactly():
    from paddle_tpu.distributed.collective import int8_all_reduce_body
    x = np.random.RandomState(1).randn(2, 3, 7).astype(np.float32)
    want = _jax_collective(int8_all_reduce_body(2), x, 2)
    got = int8_all_reduce([torch.from_numpy(x[0:1]), torch.from_numpy(x[1:2])])
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), want[i:i + 1])
    cat = all_gather_logits([torch.ones(2, 3), torch.zeros(2, 3)])
    assert cat.shape == (2, 6) and cat[:, :3].eq(1).all()


# -- engine streams -------------------------------------------------------------------

def _greedy(lengths_new, seed=17):
    ps = _prompts([n for n, _ in lengths_new], seed)
    return [(p, dict(max_new_tokens=m)) for p, (_, m) in zip(ps, lengths_new)]


def _hold(tm, reqs, tp, jm, **kw):
    """The port's tp engine's streams equal JAX's tp engine's and the
    port's tp 1; returns (port tp streams, its stats, tp 1 stats)."""
    want, _ = _jax(jm, reqs, tp=tp, **kw)
    one, st1 = _port(tm, reqs, **kw)
    got, st = _port(tm, reqs, tp=tp, **kw)
    dec = PagedLlamaDecoder.from_model(tm, num_blocks=96, block_size=8,
                                       device="cpu")
    assert_identical(dec, reqs, got, want)
    assert got == one
    assert st["tp"] == tp and st1["tp"] == 1
    return got, st, st1


def test_streams_tp2_mixed_lengths_chunked(kvh2):
    jm, tm = kvh2
    _, st, _ = _hold(tm, _greedy(((5, 10), (30, 12), (60, 8), (9, 6))), 2,
                     jm)
    assert st["device_dispatches"] > 0


def test_streams_tp4(kvh4):
    jm, tm = kvh4
    _hold(tm, _greedy(((7, 10), (18, 8), (29, 9))), 4, jm)


def test_streams_tp2_prefix_splice(kvh2):
    jm, tm = kvh2
    base, a, b, c = _prompts((16, 6, 9, 11))
    reqs = [(np.concatenate([base, a]), dict(max_new_tokens=8)),
            (np.concatenate([base, b]), dict(max_new_tokens=8)),
            (c, dict(max_new_tokens=8))]
    _, st, st1 = _hold(tm, reqs, 2, jm)
    assert st["prefix_cache_hit_tokens"] == \
        st1["prefix_cache_hit_tokens"] > 0


def test_streams_tp2_rich_sampling(kvh2):
    jm, tm = kvh2
    reqs = [(p, dict(max_new_tokens=8, temperature=0.8, top_k=40, top_p=0.9,
                     repetition_penalty=1.2)) for p in _prompts((6, 13, 21))]
    _hold(tm, reqs, 2, jm)


def test_streams_tp2_eos_cut(kvh2):
    jm, tm = kvh2
    p, q = _prompts((10, 7))
    (stream,), _ = _port(tm, [(p, dict(max_new_tokens=12))])
    eos = stream[len(stream) // 2]
    reqs = [(p, dict(max_new_tokens=12, eos_token_id=eos)),
            (q, dict(max_new_tokens=12))]
    got, _, _ = _hold(tm, reqs, 2, jm)
    assert got[0][-1] == eos and len(got[0]) < 12


def test_streams_tp2_preemption_recompute(kvh2):
    jm, tm = kvh2
    reqs = _greedy(((8, 24), (16, 24), (24, 24), (8, 24), (12, 24)))
    want, _ = _jax(jm, reqs, tp=2, num_blocks=12, admission="optimistic")
    base, _ = _port(tm, reqs)
    got, st = _port(tm, reqs, tp=2, num_blocks=12, admission="optimistic")
    assert st["preemptions"] >= 1
    assert got == want == base


def _prefill_logits(dec, ids):
    c = dec.cache
    c.allocate(0, ids.shape[1] + 1)
    slots = torch.as_tensor([[c.extend(0) for _ in range(ids.shape[1])]],
                            dtype=torch.int32)
    with torch.inference_mode():
        lg, _, _ = dec._prefill_impl(dec.weights, c.k, c.v,
                                     torch.from_numpy(ids), slots)
    c.free(0)
    return lg[0].numpy()


def test_int8_comm_logits_tolerance(kvh2):
    """tp_comm="int8" against fp32 comm on one prefill (the reference's
    tolerance: rel < 0.02, same argmax), and the int8 engine serving
    the mixed workload."""
    _, tm = kvh2
    ids = _prompts((30,))[0][None]
    lf, li = (_prefill_logits(PagedLlamaDecoder.from_model(
        tm, num_blocks=64, block_size=8, mesh=_tmesh(2), mp_axis="tp",
        tp_shard_map=True, tp_comm=comm), ids) for comm in ("fp32", "int8"))
    rel = np.abs(lf - li).max() / np.abs(lf).max()
    assert 0 < rel < 0.02, rel
    assert int(lf.argmax()) == int(li.argmax())
    got, st = _port(tm, _greedy(((5, 10), (12, 8), (30, 12))), tp=2,
                    tp_comm="int8")
    assert [len(s) for s in got] == [10, 8, 12] and st["tp"] == 2


def test_decoder_generate_tp2(kvh2):
    jm, tm = kvh2
    ids = np.random.RandomState(17).randint(0, 512, (2, 7)).astype(np.int32)
    want = JDecoder(jm, num_blocks=64, block_size=8, mesh=_jmesh(2),
                    mp_axis="tp", tp_shard_map=True).generate(
                        ids, max_new_tokens=8)
    one = PagedLlamaDecoder.from_model(tm, num_blocks=64, block_size=8,
                                       device="cpu").generate(ids, 8)
    dec = PagedLlamaDecoder.from_model(tm, num_blocks=64, block_size=8,
                                       mesh=_tmesh(2), mp_axis="tp",
                                       tp_shard_map=True)
    got = dec.generate(ids, max_new_tokens=8)
    assert got.tolist() == np.asarray(want).tolist() == one.tolist()
    assert dec.n_shards == 2 and dec._tp == 2
    assert len(dec.weights) == 2 and len(dec.cache.k) == 2


@pytest.mark.parametrize("weight_dtype", [None, "int4"])
def test_weights_from_jax_tp_decoder(kvh2, weight_dtype):
    """A JAX tp decoder's tree (per projection; int4 interleaved) builds
    the port's shards, whose logits equal JAX's within 1e-5, and the
    port's one-device decoder over the same tree."""
    jm, _ = kvh2
    jdec = JDecoder(jm, num_blocks=32, block_size=8, mesh=_jmesh(2),
                    mp_axis="tp", tp_shard_map=True,
                    weight_dtype=weight_dtype)
    tree = jax.tree.map(np.asarray, jdec.weights)
    ids = _prompts((13,))[0][None]
    c = jdec.cache
    c.allocate(0, ids.shape[1] + 1)
    slots = np.asarray([[c.extend(0) for _ in range(ids.shape[1])]],
                       np.int32)
    want, c.k, c.v = jdec._prefill(jdec.weights, c.k, c.v, ids, slots)
    want = np.asarray(want)[0]
    kw = dict(weight_dtype=weight_dtype, int4_layout="interleaved",
              num_blocks=32, block_size=8)
    tp2 = PagedLlamaDecoder.from_numpy_weights(
        jm.cfg, tree, mesh=_tmesh(2), mp_axis="tp", tp_shard_map=True, **kw)
    one = PagedLlamaDecoder.from_numpy_weights(jm.cfg, tree, device="cpu",
                                               **kw)
    if weight_dtype == "int4":
        # repacked as halves when loaded, so both take the GEMV kernel
        assert tp2.weights[1]["layers"][0]["wo"].kind == "int4_halves"
        assert one.weights[0]["layers"][0]["wqkv"].kind == "int4_halves"
    for dec in (tp2, one):
        np.testing.assert_allclose(_prefill_logits(dec, ids), want,
                                   rtol=0, atol=1e-5)


# -- the surface ----------------------------------------------------------------------

def _tiny_engine(tm, **kw):
    return ServingEngine(tm, max_batch_size=2, num_blocks=32, block_size=8,
                         prompt_buckets=(16,), **kw)


def test_tp_forces_ragged(kvh2):
    _, tm = kvh2
    eng = _tiny_engine(tm, ragged=False, tp=2, devices=["cpu"] * 2)
    assert eng.ragged and eng.tp == 2 and eng.tp_comm == "fp32"
    assert eng.dec.devices == [torch.device("cpu")] * 2
    assert eng.compile_watch._families["ragged"]["info"]["tp"] == 2


def test_tp_and_mesh_conflict(kvh2):
    _, tm = kvh2
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(tm, tp=2, mesh=_tmesh(2), devices=["cpu"] * 2)


def test_mesh_without_shard_map_is_gspmd(kvh2):
    """JAX's GSPMD decoder: the same function on the sharded execution,
    its tp degree 1 for the engine, as in JAX."""
    _, tm = kvh2
    mesh = ProcessMesh([0, 1], ["mp"], devices=["cpu"] * 2)
    eng = ServingEngine(tm, mesh=mesh, **ENGINE)
    assert eng.tp == 1 and eng.dec.n_shards == 2
    reqs = _greedy(((5, 6), (12, 5)))
    got, _ = _serve(eng, reqs)
    assert got == _port(tm, reqs)[0]


def test_prebuilt_decoder_rules(kvh2):
    _, tm = kvh2
    dec = PagedLlamaDecoder.from_model(tm, num_blocks=32, block_size=8,
                                       mesh=_tmesh(2), mp_axis="tp",
                                       tp_shard_map=True)
    with pytest.raises(ValueError, match="tp degree"):
        ServingEngine(dec, tp=4)
    with pytest.raises(ValueError, match="devices= only applies"):
        ServingEngine(dec, tp=2, devices=["cpu"] * 2)
    assert ServingEngine(dec, tp=2, max_batch_size=2,
                         prompt_buckets=(16,)).tp == 2
    assert ServingEngine(dec, max_batch_size=2, prompt_buckets=(16,)).tp == 2
    with pytest.raises(ValueError, match="tp_comm"):
        ServingEngine(dec, tp=2, tp_comm="int8")
    dec8 = PagedLlamaDecoder.from_model(tm, num_blocks=32, block_size=8,
                                        mesh=_tmesh(2), mp_axis="tp",
                                        tp_shard_map=True, tp_comm="int8")
    with pytest.raises(ValueError, match="tp_comm"):
        ServingEngine(dec8, tp=2, tp_comm="fp32")
    assert ServingEngine(dec8, tp=2, max_batch_size=2,
                         prompt_buckets=(16,)).tp_comm == "int8"


def test_bad_flags_fail_loudly(kvh2):
    _, tm = kvh2
    with pytest.raises(ValueError, match="tp_comm"):
        _tiny_engine(tm, tp=2, tp_comm="fp8", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        PagedLlamaDecoder.from_model(tm, num_blocks=32, block_size=8,
                                     device="cpu", tp_shard_map=True)
    with pytest.raises(ValueError, match="int8"):
        PagedLlamaDecoder.from_model(tm, num_blocks=32, block_size=8,
                                     device="cpu", tp_comm="int8")
    with pytest.raises(ValueError, match="int8"):
        _tiny_engine(tm, tp_comm="int8", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        # llama_tiny has 2 kv heads: tp=4 cannot shard them
        _tiny_engine(tm, tp=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="devices= requires"):
        _tiny_engine(tm, devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        _tiny_engine(tm, tp=2, devices=["cpu"])
    with pytest.raises(ValueError, match="tp must be"):
        _tiny_engine(tm, tp=0, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device list of a machine without "
                           "a card")
def test_default_devices_need_a_card(kvh2):
    _, tm = kvh2
    with pytest.raises(RuntimeError, match="visible CUDA devices"):
        _tiny_engine(tm, tp=2)


def test_graphs_across_distinct_cards_refused():
    """One card holds every shard's kernels in one graph; across cards a
    capture is not ported, and the engine says so instead of running
    eagerly in silence."""
    with pytest.raises(NotImplementedError, match=r"item 11\(d\)"):
        ProgramSet("cuda:0", CompileWatch(), graphs=True,
                   devices=["cuda:0", "cuda:1"])
    ProgramSet("cuda:0", CompileWatch(), graphs=True,
               devices=["cuda:0", "cuda:0"])
    ProgramSet("cuda:0", CompileWatch(), graphs=False,
               devices=["cuda:0", "cuda:1"])


def test_warmup_and_seal_at_tp2(kvh2):
    """warmup_programs + seal_programs on a tp-2 engine (on the CPU a
    program's first run is its compile): the mixed workload then
    compiles nothing and gives tp 1's streams; the program keys carry
    the degree and the comm mode."""
    _, tm = kvh2
    reqs = _greedy(((5, 10), (30, 12), (9, 6)))
    eng = ServingEngine(tm, tp=2, devices=["cpu"] * 2, tp_comm="int8",
                        **ENGINE)
    eng.warmup_programs()
    eng.seal_programs()
    got, st = _serve(eng, reqs)
    assert st["unexpected_recompiles"] == 0 and st["tp"] == 2
    info = eng.compile_watch._families["ragged"]["info"]
    assert (info["tp"], info["tp_comm"]) == (2, "int8")
    fp32, _ = _port(tm, reqs, tp=2)
    assert [len(s) for s in got] == [len(s) for s in fp32]
