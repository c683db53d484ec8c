"""One ragged ministep of the port's ``PagedLlamaDecoder`` against the JAX
decoder at ``llama_tiny`` width.

The JAX decoder is built by ``from_config`` and its ``weights`` tree is
carried into the port through ``weights_from_numpy``; both pools start
from the same random contents. One ``_ragged_logits`` ministep runs on
the same rows — two decode rows over earlier context, an 8-row prefill
chunk and two padding rows aimed at a scratch page — for weights
{fp32, int8, int4} x pools {fp32, int8}. Tolerance: logits atol=1e-4;
fp32 pool contents atol=1e-6; int8 pool values identical and their
scales within float32 rounding (rtol=1e-6). At tp 2 (weights carried
from JAX's tp decoder, the pools cut along their kv heads) the same
ministep against JAX's one-device one, and the int8 pool's engine
against JAX's tp-2 engine (``tests/test_kv_quant.py:390``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch.inference import \
    PagedLlamaDecoder as TorchDecoder  # noqa: E402
from paddle_tpu_torch.models import llama_tiny as torch_tiny  # noqa: E402
from _torch_serving_cases import tp_pair  # noqa: E402

NB, BS, SCRATCH = 32, 8, 31


def _schedule(max_pages):
    """(ids, positions, slots, row_seq, row_ctx, tables) as numpy."""
    rng = np.random.RandomState(21)
    blocks = {0: [0, 1, 2], 1: [3, 4, 5], 2: [6, 7]}
    tables = np.full((4, max_pages), SCRATCH, np.int32)   # row 3: scratch
    for s, bl in blocks.items():
        tables[s, :len(bl)] = bl

    def slot(s, p):
        return blocks[s][p // BS] * BS + p % BS

    rows = [(0, 13), (1, 20)] + [(2, p) for p in range(4, 12)]
    seq = [s for s, _ in rows] + [3, 3]
    pos = [p for _, p in rows] + [0, 0]
    slots = [slot(s, p) for s, p in rows] + [SCRATCH * BS] * 2
    ctx = [p + 1 for _, p in rows] + [0, 0]
    ids = rng.randint(0, 512, len(seq))
    return [np.asarray(a, np.int32) for a in (ids, pos, slots, seq, ctx)] \
        + [tables]


def _pools(cfg, kv_quant):
    rng = np.random.RandomState(22)
    kvh = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (NB, kvh, BS, hd)

    def plane():
        if kv_quant == "int8":
            return (rng.randint(-127, 128, shape).astype(np.int8),
                    rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32))
        return (rng.randn(*shape) * 0.5).astype(np.float32)

    return ([plane() for _ in range(cfg.num_hidden_layers)],
            [plane() for _ in range(cfg.num_hidden_layers)])


def _conv(planes, fn):
    return [tuple(fn(a) for a in p) if isinstance(p, tuple) else fn(p)
            for p in planes]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("weight_dtype", [None, "int8", "int4"])
def test_ragged_ministep_matches_jax(weight_dtype, kv_quant):
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=NB,
                                  block_size=BS, weight_dtype=weight_dtype,
                                  kv_quant=kv_quant)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = TorchDecoder.from_numpy_weights(
        torch_tiny(), tree, weight_dtype=weight_dtype, kv_quant=kv_quant,
        num_blocks=NB, block_size=BS, device="cpu")
    assert tdec.max_pages == jdec.max_pages
    sched = _schedule(tdec.max_pages)
    kp, vp = _pools(jdec.cfg, kv_quant)

    jl, jk, jv = jdec._ragged_logits(
        jdec.weights, _conv(kp, jnp.asarray), _conv(vp, jnp.asarray),
        *[jnp.asarray(a) for a in sched])
    tk = _conv(kp, lambda a: torch.from_numpy(a.copy()))
    tv = _conv(vp, lambda a: torch.from_numpy(a.copy()))
    tl, tk2, tv2 = tdec._ragged_logits(
        tdec.weights, [tk], [tv], *[torch.from_numpy(a) for a in sched])
    assert tk2[0] is tk and tv2[0] is tv           # pools updated in place

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for jp, tp in zip(jk + jv, tk + tv):
        if kv_quant == "int8":
            np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
            np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp[1]),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       atol=1e-6, rtol=0)
    # the padding rows wrote only the scratch page
    untouched = [b for b in range(NB) if b not in (1, 5, 6, 7, SCRATCH)]
    before = kp[0][0] if kv_quant else kp[0]
    after = (tk[0][0] if kv_quant else tk[0]).numpy()
    np.testing.assert_array_equal(after[untouched], before[untouched])


def _shard_planes(planes, n):
    """Whole pool planes (numpy; int8 ones (values, scales)) cut along
    their kv-head dim into the list of n shards' per-layer lists."""
    def cut(a, s):
        h = a.shape[1] // n
        return torch.from_numpy(np.ascontiguousarray(a[:, s * h:(s + 1) * h]))
    return [[tuple(cut(a, s) for a in p) if isinstance(p, tuple)
             else cut(p, s) for p in planes] for s in range(n)]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("weight_dtype", [None, "int4"])
def test_tp2_ragged_ministep_matches_jax(weight_dtype, kv_quant):
    """The ministep at tp 2, each shard on its half of the kv heads (int8
    scales included), against JAX's one-device ministep on the whole
    pool: logits within 1e-4, each shard's pool the JAX pool's heads."""
    cfg = dict(weight_dtype=weight_dtype, kv_quant=kv_quant, num_blocks=NB,
               block_size=BS)
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, **cfg)
    _, tdec = tp_pair(2, jax_tiny(), torch_tiny(), **cfg)
    sched = _schedule(tdec.max_pages)
    kp, vp = _pools(jdec.cfg, kv_quant)
    jl, jk, jv = jdec._ragged_logits(
        jdec.weights, _conv(kp, jnp.asarray), _conv(vp, jnp.asarray),
        *[jnp.asarray(a) for a in sched])
    tk, tv = _shard_planes(kp, 2), _shard_planes(vp, 2)
    with torch.inference_mode():
        tl, _, _ = tdec._ragged_logits(tdec.weights, tk, tv,
                                       *[torch.from_numpy(a) for a in sched])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for jp, sh in zip(jk + jv, [list(z) for z in zip(*tk)]
                      + [list(z) for z in zip(*tv)]):
        if kv_quant == "int8":
            for i in range(2):
                got = torch.cat([s[i] for s in sh], dim=1).numpy()
                np.testing.assert_allclose(got, np.asarray(jp[i]),
                                           rtol=1e-6, atol=0)
        else:
            got = torch.cat(sh, dim=1).numpy()
            np.testing.assert_allclose(got, np.asarray(jp), atol=1e-6,
                                       rtol=0)


def test_tp2_int8_pool_engine_matches_jax():
    """tests/test_kv_quant.py:390: tp 2 on the kv-head-sharded int8 pool
    (each shard quantizes its own heads with its own scales) gives JAX's
    tp-2 streams, and the fp32 pool's."""
    from paddle_tpu.inference import SamplingParams as JaxParams
    from paddle_tpu.inference import ServingEngine as JaxEngine
    from paddle_tpu_torch.inference import SamplingParams, ServingEngine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (9, 17, 30)]
    kw = dict(max_batch_size=3, prompt_buckets=(16, 32), chunk_size=4,
              prefill_chunk=8, ragged=True)
    streams = {}
    for kvq in (None, "int8"):
        jdec, tdec = tp_pair(2, jax_tiny(), torch_tiny(), kv_quant=kvq,
                             num_blocks=32, block_size=8)
        out = []
        for eng, params in ((JaxEngine(jdec, tp=2, overlap=False, **kw),
                             JaxParams),
                            (ServingEngine(tdec, tp=2, **kw),
                             SamplingParams)):
            rids = [eng.add_request(p, params(max_new_tokens=12))
                    for p in prompts]
            eng.run_to_completion()
            out.append([eng.result(r).tolist() for r in rids])
        assert out[1] == out[0], kvq
        assert tdec.cache.pool_dtype == ("int8" if kvq else "float32")
        streams[kvq] = out[1]
    assert streams["int8"] == streams[None]
