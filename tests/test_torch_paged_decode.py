"""One ragged ministep of the port's ``PagedLlamaDecoder`` against the JAX
decoder at ``llama_tiny`` width.

The JAX decoder is built by ``from_config`` and its ``weights`` tree is
carried into the port through ``weights_from_numpy``; both pools start
from the same random contents. One ``_ragged_logits`` ministep runs on
the same rows — two decode rows over earlier context, an 8-row prefill
chunk and two padding rows aimed at a scratch page — for weights
{fp32, int8, int4} x pools {fp32, int8}. Tolerance: logits atol=1e-4;
fp32 pool contents atol=1e-6; int8 pool values identical and their
scales within float32 rounding (rtol=1e-6).
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
        tdec.weights, tk, tv, *[torch.from_numpy(a) for a in sched])
    assert tk2 is tk and tv2 is tv                 # pools updated in place

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
