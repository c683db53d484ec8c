"""The port's threefry2x32 key stream (``paddle_tpu_torch/utils/prng.py``)
against ``jax.random`` in its default configuration (threefry2x32,
partitionable).

Held: the Random123 known answer of threefry2x32 at key (0, 0), count
(0, 0); ``PRNGKey``, ``split`` and ``fold_in`` equal JAX's keys for
several seeds; the bits and the uniforms of a draw are exactly JAX's for
the shapes (1,), (7,), (3, 5), (8, 512) and (2, 3, 1000) on the
sampler's ranges [0, 1) and [tiny, 1) (within 1e-6 on [-2, 3)); the Gumbel
noise is within 2e-6 absolute (``torch.log`` and XLA's log differ in
the last bit); ``categorical`` draws JAX's token; and a row of a
[W, V] draw does not depend on W.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu_torch.utils import prng  # noqa: E402

SHAPES = [(1,), (7,), (3, 5), (8, 512), (2, 3, 1000)]
SEEDS = [0, 7, 123456, 2 ** 31 - 1, -1]
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_threefry_known_answer():
    out = prng.threefry_2x32(np.zeros(2, np.uint32), np.zeros(2, np.uint32))
    assert [int(x) for x in out] == [0x6B200159, 0x99BA4EFE]
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = _jkey(seed)
    pk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), pk)
    for n in (2, 5, 8):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, n)),
                                      prng.split(pk, n))
    for data in (0, 1, 42, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)),
            prng.fold_in(pk, data))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 11, 987])
def test_bits_and_uniform_exact(shape, seed):
    jk, pk = _jkey(seed), prng.PRNGKey(seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(pk, shape).numpy(), jb)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
        ju = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        pu = prng.uniform(pk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(pu.view(np.int32), ju.view(np.int32))
    # a range of another width: XLA on the CPU fuses the scale and the
    # shift into one multiply-add, the port rounds twice
    ju = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    np.testing.assert_allclose(prng.uniform(pk, shape, -2.0, 3.0).numpy(),
                               ju, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 11, 987])
def test_gumbel_within_2e6(shape, seed):
    jg = np.asarray(jax.random.gumbel(_jkey(seed), shape))
    pg = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    assert pg.dtype == np.float32
    np.testing.assert_allclose(pg, jg, rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", [(1, 9), (3, 5), (8, 512), (2, 3, 1000)])
@pytest.mark.parametrize("seed", [0, 11, 987])
def test_categorical_matches_jax(shape, seed):
    logits = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jt = np.asarray(jax.random.categorical(_jkey(seed), jnp.asarray(logits),
                                           axis=-1))
    pt = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), jt)


def test_rows_do_not_depend_on_width():
    """Partitionable bits: element (r, j) is a function of r * V + j, so
    the first rows of a wider draw equal a narrower draw, and a key as
    an int32 tensor (a program operand) gives the numpy key's bits."""
    key = prng.PRNGKey(3)
    narrow = prng.random_bits(key, (2, 100))
    wide = prng.random_bits(key, (6, 100))
    assert torch.equal(wide[:2], narrow)
    op = torch.from_numpy(key.view(np.int32))
    assert torch.equal(prng.random_bits(op, (6, 100)), wide)
    with pytest.raises(TypeError):
        prng.categorical(key, torch.zeros(2, 3, dtype=torch.float64))
