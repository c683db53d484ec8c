"""The dense per-phase programs of the port's ``PagedLlamaDecoder`` against
the JAX decoder at ``llama_tiny`` width, float32.

The JAX decoder is built by ``from_config``; its ``weights`` tree is
carried into the port by ``from_numpy_weights``, and both pools start
from the same random contents. ``_prefill_impl`` (a right-padded bucket
through causal attention), ``_prefill_prefix_impl`` (an offset chunk over
a prefix table, one row at offset 0) and ``_decode_logits`` (one token
per sequence, one row on the scratch page) run on the same schedules:
logits within atol 1e-4 and every pool page but the scratch page (whose
slot several padding rows write, in no defined order, in both packages)
within atol 1e-5. ``generate()`` must be token-identical to the JAX
``PagedLlamaDecoder.generate`` with fp and with int4 weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.paged_decode import \
    PagedLlamaDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch.inference import PagedLlamaDecoder  # noqa: E402
from paddle_tpu_torch.inference.paged_decode import (  # noqa: E402
    _gather_prefix_pages, _prefix_suffix_attention)
from paddle_tpu_torch.models import llama_tiny  # noqa: E402

NB, BS, SCRATCH = 40, 8, 39


def _pair(weight_dtype=None):
    jdec = JaxDecoder.from_config(jax_tiny(), seed=0, num_blocks=NB,
                                  block_size=BS, weight_dtype=weight_dtype)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedLlamaDecoder.from_numpy_weights(
        llama_tiny(), tree, weight_dtype=weight_dtype, num_blocks=NB,
        block_size=BS, device="cpu")
    return jdec, tdec


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _pools(cfg, seed=22):
    rng = np.random.RandomState(seed)
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (NB, cfg.num_key_value_heads, BS, hd)
    return ([(rng.randn(*shape) * 0.5).astype(np.float32)
             for _ in range(cfg.num_hidden_layers)],
            [(rng.randn(*shape) * 0.5).astype(np.float32)
             for _ in range(cfg.num_hidden_layers)])


def _run_both(jdec, tdec, name, *args):
    """The same program on both decoders from the same pools: (jax logits,
    port logits, jax pools, port pools)."""
    kp, vp = _pools(jdec.cfg)
    jl, jk, jv = getattr(jdec, name)(
        jdec.weights, [jnp.asarray(a) for a in kp],
        [jnp.asarray(a) for a in vp], *[jnp.asarray(a) for a in args])
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        tl, tk2, tv2 = getattr(tdec, name)(
            tdec.weights, tk, tv, *[torch.from_numpy(a) for a in args])
    assert tk2 is tk and tv2 is tv               # pools updated in place
    return np.asarray(jl), tl.numpy(), jk + jv, tk + tv


def _check(jl, tl, jpools, tpools):
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4, rtol=0)
    keep = [b for b in range(NB) if b != SCRATCH]
    for jp, tp in zip(jpools, tpools):
        np.testing.assert_allclose(tp.numpy()[keep], np.asarray(jp)[keep],
                                   atol=1e-5, rtol=0)


def test_prefill_matches_jax(pair):
    jdec, tdec = pair
    s = 16
    ids = np.random.RandomState(3).randint(0, 512, (2, s)).astype(np.int32)
    ids[0, 10:] = 0                                   # right padding
    slots = np.full((2, s), SCRATCH * BS, np.int32)
    slots[0, :10] = np.arange(10) + 2 * BS            # pages 2, 3
    slots[1] = np.arange(16) + 5 * BS                 # pages 5, 6
    last = np.asarray([9, 15], np.int32)
    _check(*_run_both(jdec, tdec, "_prefill_impl", ids, slots, last))


def test_prefill_prefix_matches_jax(pair):
    jdec, tdec = pair
    s, p = 8, 4
    ids = np.random.RandomState(4).randint(0, 512, (2, s)).astype(np.int32)
    n_cached = np.asarray([13, 0], np.int32)          # row 0 mid-page
    slots = np.zeros((2, s), np.int32)
    pages0 = [7, 8, 9]                                # positions 0..23
    slots[0] = [pages0[(13 + j) // BS] * BS + (13 + j) % BS
                for j in range(s)]
    slots[1] = np.arange(s) + 11 * BS
    ptab = np.full((2, p), SCRATCH, np.int32)
    ptab[0, :2] = pages0[:2]                          # the covered pages
    last = np.asarray([7, 5], np.int32)
    _check(*_run_both(jdec, tdec, "_prefill_prefix_impl", ids, slots, last,
                      n_cached, ptab))


def test_decode_logits_matches_jax(pair):
    jdec, tdec = pair
    mp = tdec.max_pages
    tables = np.full((3, mp), SCRATCH, np.int32)
    tables[0, :1] = [12]
    tables[1, :3] = [13, 14, 15]
    ctx = np.asarray([5, 17, 0], np.int32)            # row 2: scratch
    slots = np.asarray([12 * BS + 5, 15 * BS + 1, SCRATCH * BS], np.int32)
    last = np.asarray([3, 77, 0], np.int32)
    _check(*_run_both(jdec, tdec, "_decode_logits", last, tables, ctx,
                      slots))


def test_prefix_helpers_match_jax():
    """The two plain helpers on their own, at a GQA group of 2."""
    from paddle_tpu.inference.paged_decode import (
        _gather_prefix_pages as jax_gather,
        _prefix_suffix_attention as jax_attn)
    rng = np.random.RandomState(9)
    pool = rng.randn(10, 2, 4, 16).astype(np.float32)
    ptab = np.asarray([[3, 1, 7], [2, 9, 9]], np.int32)
    g = _gather_prefix_pages(torch.from_numpy(pool), torch.from_numpy(ptab))
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jax_gather(jnp.asarray(pool),
                                         jnp.asarray(ptab))))
    q = rng.randn(2, 5, 4, 16).astype(np.float32)
    ks, vs = (rng.randn(2, 5, 2, 16).astype(np.float32) for _ in range(2))
    kpre, vpre = (rng.randn(2, 2, 12, 16).astype(np.float32)
                  for _ in range(2))
    nc = np.asarray([7, 0], np.int32)
    got = _prefix_suffix_attention(*(torch.from_numpy(a) for a in
                                     (q, ks, vs, kpre, vpre, nc)))
    want = jax_attn(*(jnp.asarray(a) for a in (q, ks, vs, kpre, vpre, nc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("weight_dtype", [None, "int4"])
def test_generate_token_identical(weight_dtype):
    jdec, tdec = _pair(weight_dtype)
    ids = np.random.RandomState(11).randint(0, 512, (3, 13)).astype(
        np.int32)
    want = jdec.generate(ids, max_new_tokens=9)
    timings = {}
    got = tdec.generate(ids, max_new_tokens=9, timings=timings)
    assert got.shape == (3, 22) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert timings["prefill_s"] >= 0 and timings["decode_s"] >= 0
    # generate frees its pages; a second call gives the same tokens
    assert tdec.cache.free_blocks == NB
    np.testing.assert_array_equal(tdec.generate(ids, max_new_tokens=9),
                                  want)
    np.testing.assert_array_equal(tdec.generate(ids, max_new_tokens=1),
                                  want[:, :14])


def test_prefill_bucket_past_max_positions(pair):
    """A bucket longer than max_position_embeddings (256 at llama_tiny):
    its padding rows take clamped positions, as JAX's gather clamps them,
    and the real rows' logits match JAX's."""
    jdec, tdec = pair
    s = 272
    ids = np.zeros((1, s), np.int32)
    ids[0, :200] = np.random.RandomState(5).randint(0, 512, 200)
    slots = np.full((1, s), SCRATCH * BS, np.int32)
    slots[0, :200] = np.arange(200)                   # pages 0..24
    last = np.asarray([199], np.int32)
    _check(*_run_both(jdec, tdec, "_prefill_impl", ids, slots, last))
