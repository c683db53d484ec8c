"""The port's weight quantizers and weight-streaming matmul against the
JAX package.

- ``_quantize_w`` / ``_quantize_w4_halves`` are bit-identical to JAX on
  float32 and bfloat16 weights (same float32 divisions; ``torch.round``
  and ``jnp.round`` both round half to even).
- ``decode_matmul_reference`` (the plain version of the CUDA kernel), and
  the port's ``_mm`` that routes to it, against the JAX ``_mm`` on the
  CPU (its XLA composition) for int4 halves, int8 and dense weights,
  b in {1, 8, 32}, K=256, N=384. Tolerance: float32 relative max error
  (max |diff| / max |ref|) < 1e-5; bfloat16 < 2e-2, the bound of
  tests/test_decode_matmul.py.
- The layout tag: a weight whose tag is not a layout the port knows, or
  whose shape disagrees with its tag, raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from paddle_tpu.inference import paged_decode as jpd  # noqa: E402
from paddle_tpu_torch.inference import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.inference.weights import tensor_from_numpy  # noqa: E402
from paddle_tpu_torch.ops.cuda import decode_matmul as dmm  # noqa: E402
from paddle_tpu_torch.ops.qweight import QWeight  # noqa: E402

K, N = 256, 384


def _weights(dtype):
    rng = np.random.RandomState(11)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                  # an all-zero column takes a unit scale
    w[3, 5] = 0.5 * 0.05           # exercise half-way rounding spots
    return w.astype(dtype)


@pytest.mark.parametrize("np_dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("which", ["int8", "int4"])
def test_quantizers_bit_identical(np_dtype, which):
    w = _weights(np_dtype)
    jf = {"int8": jpd._quantize_w, "int4": jpd._quantize_w4_halves}[which]
    tf = {"int8": tpd._quantize_w, "int4": tpd._quantize_w4_halves}[which]
    jq, js = jf(jnp.asarray(w))
    tq = tf(tensor_from_numpy(w, "cpu"))
    assert tq.kind == {"int8": "int8", "int4": "int4_halves"}[which]
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(js))


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.mark.parametrize("kind", ["int4", "int8", "dense"])
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matmul_matches_jax_mm(kind, b, dtype):
    rng = np.random.RandomState(b)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = rng.randn(b, K).astype(np.float32).astype(np_dt)
    w = _weights(np_dt)
    jx = jnp.asarray(x)
    tx = tensor_from_numpy(x, "cpu")
    if kind == "dense":
        jw, tw = jnp.asarray(w), tensor_from_numpy(w, "cpu")
    else:
        jw = {"int8": jpd._quantize_w,
              "int4": jpd._quantize_w4_halves}[kind](jnp.asarray(w))
        tw = QWeight(tensor_from_numpy(np.asarray(jw[0]), "cpu"),
                     tensor_from_numpy(np.asarray(jw[1]), "cpu"),
                     {"int8": "int8", "int4": "int4_halves"}[kind])
    ref = np.asarray(jpd._mm(jx, jw), np.float32)
    bound = 1e-5 if dtype == "float32" else 2e-2
    for got in (dmm.decode_matmul_reference(tx, tw), dmm.decode_matmul(tx, tw),
                tpd._mm(tx, tw)):
        assert got.dtype == tx.dtype and tuple(got.shape) == (b, N)
        assert _rel(got.float().numpy(), ref) < bound


def test_mm_above_32_rows_uses_the_split_contraction():
    """int4 with more than 32 activation rows is the nibble-split torch
    composition (paged_decode.py:143-150 in the JAX package)."""
    rng = np.random.RandomState(5)
    x = rng.randn(40, K).astype(np.float32)
    jw = jpd._quantize_w4_halves(jnp.asarray(_weights(np.float32)))
    tw = QWeight(torch.from_numpy(np.asarray(jw[0])),
                 torch.from_numpy(np.asarray(jw[1])), "int4_halves")
    assert not dmm.decode_matmul_supported(torch.from_numpy(x), tw)
    ref = np.asarray(jpd._mm(jnp.asarray(x), jw))
    assert _rel(tpd._mm(torch.from_numpy(x), tw).numpy(), ref) < 1e-5


def test_supported_gate():
    x = torch.zeros(8, K)
    w4 = tpd._quantize_w4_halves(torch.randn(K, N))
    assert dmm.decode_matmul_supported(x, w4)
    assert dmm.decode_matmul_supported(x, torch.zeros(K, N))
    assert not dmm.decode_matmul_supported(torch.zeros(33, K), w4)
    assert not dmm.decode_matmul_supported(torch.zeros(8, K + 2), w4)
    assert not dmm.decode_matmul_supported(x, torch.zeros(K, N).double())
    assert not dmm.decode_matmul_supported(x.half(), w4)
    assert not dmm.decode_matmul_supported(
        x, tpd._quantize_w(torch.randn(K, N - 2)))


def test_layout_tag_is_checked():
    w4 = tpd._quantize_w4_halves(torch.randn(K, N))
    x = torch.randn(4, K)
    untagged = QWeight(w4.q, w4.scale, "int4")
    with pytest.raises(ValueError, match="kind"):
        tpd._mm(x, untagged)
    with pytest.raises(ValueError, match="kind"):
        dmm.decode_matmul(x, untagged)
    interleaved = QWeight(w4.q, w4.scale, "int4_interleaved")
    with pytest.raises(ValueError, match="kind"):
        dmm.decode_matmul_reference(x, interleaved)
    # halves-packed bytes tagged as int8: the in-dim no longer matches
    mislabeled = QWeight(w4.q, w4.scale, "int8")
    with pytest.raises(ValueError, match="in-dim"):
        tpd._mm(x, mislabeled)
    # a JAX-style bare tuple is not a weight the port accepts
    with pytest.raises((TypeError, AttributeError)):
        tpd._mm(x, (w4.q, w4.scale))
