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


# -- the tensor-core kernel's host plan and bit tricks (no card needed) ----

SHAPES_8B = {"wqkv": (4096, 6144), "wo": (4096, 4096),
             "wgu": (4096, 28672), "wd": (14336, 4096),
             "head": (4096, 128256)}


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["int4_halves", "int8", None])
@pytest.mark.parametrize("name", sorted(SHAPES_8B))
def test_split_plan_covers_rows_and_fills_the_card(name, kind, dtype, sms):
    """split_plan at the 8B shapes, b 1/4/8/32: every weight row (packed
    row for int4) lies in exactly one split, no split is empty, each
    split is whole k-steps (bf16) or x stages (float32), and the grid
    has at least one block per SM."""
    K, N = SHAPES_8B[name]
    dt = getattr(torch, dtype)
    rows_w = K // 2 if kind == "int4_halves" else K
    for b in (1, 4, 8, 32):
        splits, per = dmm.split_plan(kind, dt, b, K, N, sms)
        owner = np.full(rows_w, -1)
        for s in range(splits):
            lo, hi = s * per, min(rows_w, s * per + per)
            assert lo < hi, "an empty split"
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = s
        assert (owner >= 0).all(), "a weight row in no split"
        if dtype == "bfloat16":
            granule = 8 if kind == "int4_halves" else 16
            assert per % granule == 0
            # a block stages the activations of at most 256 / NT k-steps
            assert per // granule <= 256 // (1 if b <= 8 else 4)
            tile_n = 256
        else:
            assert per % (256 if b <= 8 else 64) == 0
            tile_n = 128
        assert splits <= 16
        assert -(-N // tile_n) * splits >= sms


def _bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def test_int4_bit_trick_matches_unpack_for_every_byte():
    """The kernel's int4 -> bf16x2 (csrc/decode_matmul.cu:deq4): the
    words of two packed rows p, q xor 0x88888888 (and, for the high
    nibbles, shifted right by 4); prmt takes byte j of p into byte 0 and
    byte j of q into byte 2; masked by 0x000F000F over 0x43004300 (bf16
    128.0), then one bf16x2 fma with (1, 1) and (-136, -136). Emulated in
    numpy at byte j = 2 of words whose other bytes are random, for all
    256 values of p's byte (q's a permutation of them): the low-nibble
    register holds unpack_int4_halves' lo of p and q, the high-nibble
    register their hi."""
    rng = np.random.RandomState(3)
    j = 2

    def words(byte):
        rest = rng.randint(0, 1 << 32, 256, dtype=np.uint64) \
            .astype(np.uint32) & ~np.uint32(0xFF << (8 * j))
        return rest | (byte.astype(np.uint32) << (8 * j))

    bp = np.arange(256, dtype=np.uint32)
    bq = rng.permutation(256).astype(np.uint32)
    p, q = words(bp) ^ 0x88888888, words(bq) ^ 0x88888888
    one = _bf16_bits_to_f32([0x3F80])[0]
    bias = _bf16_bits_to_f32([0xC308])[0]
    assert one == 1.0 and bias == -136.0

    def deq4(pw, qw):
        t = ((pw >> (8 * j)) & 0xFF) | (((qw >> (8 * j)) & 0xFF) << 16)
        v = (t & 0x000F000F) | 0x43004300
        lo = _bf16_bits_to_f32(v & 0xFFFF).astype(np.float64) * one + bias
        hi = _bf16_bits_to_f32(v >> 16).astype(np.float64) * one + bias
        for vals in (lo, hi):  # exact in bfloat16: the fma rounds nothing
            assert ((vals.astype(np.float32).view(np.uint32) & 0xFFFF)
                    == 0).all()
        return lo, hi

    def unpack(byte):
        q8 = torch.from_numpy(byte.astype(np.uint8).view(np.int8)[None]
                              .copy())
        lo, hi = dmm.unpack_int4_halves(q8, torch.float32)
        return lo[0].numpy(), hi[0].numpy()

    (p_lo, p_hi), (q_lo, q_hi) = unpack(bp), unpack(bq)
    low_p, low_q = deq4(p, q)
    np.testing.assert_array_equal(low_p, p_lo)
    np.testing.assert_array_equal(low_q, q_lo)
    high_p, high_q = deq4(p >> 4, q >> 4)
    np.testing.assert_array_equal(high_p, p_hi)
    np.testing.assert_array_equal(high_q, q_hi)


def test_int8_bit_trick_matches_every_byte():
    """The kernel's int8 -> float32 (csrc/decode_matmul.cu:deq8): the
    byte xor 0x80 under 2^23 (prmt with 0x4B000000), minus 2^23 + 128,
    gives the signed value exactly, and bf16 holds it exactly."""
    byte = np.arange(256, dtype=np.uint32)
    f = ((byte ^ 0x80) | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    ref = byte.astype(np.uint8).view(np.int8).astype(np.float32)
    np.testing.assert_array_equal(f, ref)
    bf = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf, ref)


def test_bf16_gate_takes_whole_k_steps():
    """bfloat16 x needs K % 16 == 0 and N % 16 == 0 (the tensor-core
    kernel's k-steps and lane column groups); float32 keeps N % 4."""
    w4 = tpd._quantize_w4_halves(torch.randn(K, N))
    xb = torch.zeros(8, K, dtype=torch.bfloat16)
    assert dmm.decode_matmul_supported(xb, w4)
    assert not dmm.decode_matmul_supported(
        xb, tpd._quantize_w(torch.randn(K, N - 8)))
    assert dmm.decode_matmul_supported(
        torch.zeros(8, K), tpd._quantize_w(torch.randn(K, N - 4)))
    assert not dmm.decode_matmul_supported(
        torch.zeros(8, K - 8, dtype=torch.bfloat16),
        tpd._quantize_w(torch.randn(K - 8, N)))
