"""The port's paged-KV ops against the JAX package.

- ``ragged_paged_attention_reference`` (the plain version of the CUDA
  kernel) against the JAX Pallas kernel in interpret mode and the JAX
  oracle, on randomized ragged batches: decode rows, a prefill chunk,
  padding rows, contexts on and around page boundaries, fp32 and int8
  pools. Tolerance: fp32 atol=2e-5, rtol=2e-4 (the JAX tests' own kernel
  bound); padding rows exactly 0.
- ``reshape_and_cache``: the int8 append is bit-identical (both quantize
  with absmax/127 in float32 and round half to even); the fp32 append
  writes the same values.
- ``PagedKVCache``: one op sequence replayed on both allocators gives the
  same tables, lengths and free list.
All inputs are numpy arrays from a seed, handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import paged_attention as jpa  # noqa: E402
from paddle_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_attention_pallas  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402

ATOL, RTOL = 2e-5, 2e-4


def _rand_case(rng, kvh, group, d, bs, nblocks, mp, n_seqs, decode_rows,
               chunk_rows, quantized=False):
    """Numpy twin of tests/test_ragged_batching.py::_rand_case: decode
    rows over random contexts, one prefill chunk of consecutive offsets
    and two padding rows; int8 pools carry random values and scales."""
    if quantized:
        kc = (rng.randint(-127, 128, (nblocks, kvh, bs, d)).astype(np.int8),
              rng.uniform(0.001, 0.05, (nblocks, kvh, bs)).astype(np.float32))
        vc = (rng.randint(-127, 128, (nblocks, kvh, bs, d)).astype(np.int8),
              rng.uniform(0.001, 0.05, (nblocks, kvh, bs)).astype(np.float32))
    else:
        kc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
        vc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
    tables = rng.choice(nblocks, (n_seqs, mp), replace=False).astype(np.int32)
    row_seq, row_ctx = [], []
    for i in range(decode_rows):
        row_seq.append(i % n_seqs)
        row_ctx.append(int(rng.randint(1, mp * bs + 1)))
    off = int(rng.randint(0, mp * bs - chunk_rows))
    for j in range(chunk_rows):
        row_seq.append(n_seqs - 1)
        row_ctx.append(off + j + 1)
    row_seq += [0, 0]
    row_ctx += [0, 0]
    q = rng.randn(len(row_seq), kvh * group, d).astype(np.float32)
    return (q, kc, vc, tables, np.asarray(row_seq, np.int32),
            np.asarray(row_ctx, np.int32))


def _to(conv, case):
    def one(a):
        return tuple(conv(x) for x in a) if isinstance(a, tuple) else conv(a)
    return [one(a) for a in case]


def _port(case):
    out = tpa.ragged_paged_attention(*_to(torch.from_numpy, case))
    return out.numpy()


GEOMS = [
    dict(kvh=2, group=4, d=64, bs=16, nblocks=32, mp=4, n_seqs=3,
         decode_rows=3, chunk_rows=7),
    dict(kvh=1, group=1, d=64, bs=8, nblocks=24, mp=5, n_seqs=4,
         decode_rows=5, chunk_rows=4),
    dict(kvh=4, group=1, d=64, bs=8, nblocks=40, mp=3, n_seqs=2,
         decode_rows=2, chunk_rows=11),
]


@pytest.mark.parametrize("gi", range(len(GEOMS)))
@pytest.mark.parametrize("quantized", [False, True])
def test_reference_matches_jax_kernel_and_oracle(gi, quantized):
    rng = np.random.RandomState(100 + gi)
    case = _rand_case(rng, quantized=quantized, **GEOMS[gi])
    jcase = _to(jnp.asarray, case)
    port = _port(case)
    oracle = np.asarray(jpa.ragged_paged_attention_reference(*jcase))
    np.testing.assert_allclose(port, oracle, atol=ATOL, rtol=RTOL)
    kern = np.asarray(ragged_paged_attention_pallas(*jcase))
    np.testing.assert_allclose(port, kern, atol=ATOL, rtol=RTOL)
    # the two padding rows are exact zeros, the real rows are not
    assert np.all(port[-2:] == 0)
    assert np.all(np.abs(port[:-2]).max(axis=(1, 2)) > 0)


def test_page_boundary_contexts():
    rng = np.random.RandomState(3)
    bs, mp = 8, 4
    kc = rng.randn(16, 2, bs, 64).astype(np.float32)
    vc = rng.randn(16, 2, bs, 64).astype(np.float32)
    tables = rng.choice(16, (1, mp), replace=False).astype(np.int32)
    ctxs = [1, bs - 1, bs, bs + 1, 2 * bs, 3 * bs + 1, mp * bs]
    q = rng.randn(len(ctxs), 4, 64).astype(np.float32)
    case = (q, kc, vc, tables, np.zeros(len(ctxs), np.int32),
            np.asarray(ctxs, np.int32))
    jcase = _to(jnp.asarray, case)
    kern = np.asarray(ragged_paged_attention_pallas(*jcase))
    np.testing.assert_allclose(_port(case), kern, atol=ATOL, rtol=RTOL)


def test_bf16_query_keeps_dtype_and_tracks_fp32():
    """A bf16 batch comes back in bf16 and within bf16 rounding of the
    fp32 result (the kernel's working type on the card)."""
    rng = np.random.RandomState(4)
    case = _rand_case(rng, **GEOMS[0])
    ref = _port(case)
    tcase = _to(torch.from_numpy, case)
    tcase = [tcase[0].bfloat16(), tcase[1].bfloat16(),
             tcase[2].bfloat16()] + tcase[3:]
    out = tpa.ragged_paged_attention(*tcase)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("quantized", [False, True])
def test_reshape_and_cache_matches_jax(quantized):
    rng = np.random.RandomState(7)
    nb, kvh, bs, d, n = 6, 2, 4, 16, 9
    k = rng.randn(n, kvh, d).astype(np.float32)
    v = rng.randn(n, kvh, d).astype(np.float32)
    k[3] = 0.0       # an all-zero row quantizes with a unit scale
    slots = rng.choice(nb * bs, n, replace=False).astype(np.int32)
    if quantized:
        def planes(mod):
            return ((mod.zeros((nb, kvh, bs, d), dtype=mod.int8),
                     mod.zeros((nb, kvh, bs), dtype=mod.float32))
                    for _ in range(2))
        jk, jv = planes(jnp)
        tk, tv = planes(torch)
    else:
        jk = jv = jnp.zeros((nb, kvh, bs, d), jnp.float32)
        tk, tv = (torch.zeros((nb, kvh, bs, d)) for _ in range(2))
    jk, jv = jpa.reshape_and_cache(jnp.asarray(k), jnp.asarray(v), jk, jv,
                                   jnp.asarray(slots))
    rk, rv = tpa.reshape_and_cache(torch.from_numpy(k), torch.from_numpy(v),
                                   tk, tv, torch.from_numpy(slots))
    assert rk is tk and rv is tv          # updated in place
    for jp, tp in ((jk, tk), (jv, tv)):
        if quantized:
            np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
            np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
        else:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    q_j = jpa.quantize_kv_rows(jnp.asarray(k))
    q_t = tpa.quantize_kv_rows(torch.from_numpy(k))
    np.testing.assert_array_equal(q_t[0].numpy(), np.asarray(q_j[0]))
    np.testing.assert_array_equal(q_t[1].numpy(), np.asarray(q_j[1]))


def test_allocator_replay_matches_jax():
    kw = dict(num_layers=1, num_blocks=12, block_size=4, kv_heads=1,
              head_dim=8)
    jc = jpa.PagedKVCache(**kw)
    tc = tpa.PagedKVCache(**kw, device="cpu")
    ops = [("allocate", -1, 1), ("allocate", 0, 10), ("allocate", 1, 3),
           ("extend", 0, 6), ("extend", 1, 5), ("free", 0, 0),
           ("allocate", 2, 17), ("extend", 2, 17), ("extend", 1, 2),
           ("free", 1, 0), ("free", 1, 0), ("allocate", 3, 2),
           ("extend", 3, 9)]
    def apply(c, op, sid, n):
        if op == "allocate":
            return list(c.allocate(sid, n))
        if op == "extend":
            return [c.extend(sid) for _ in range(n)]
        return c.free(sid)

    for op, sid, n in ops:
        assert apply(tc, op, sid, n) == apply(jc, op, sid, n), (op, sid)
        assert tc._tables == jc._tables and tc._lens == jc._lens
        assert tc._free == jc._free and tc._ref == jc._ref
        assert tc.free_blocks == jc.free_blocks
        assert tc.available_blocks == jc.available_blocks
        for sid in tc._tables:
            np.testing.assert_array_equal(tc.block_table(sid, 8),
                                          jc.block_table(sid, 8))
            assert tc.context_len(sid) == jc.context_len(sid)
        tc.debug_check()
        jc.debug_check()
    with pytest.raises(jpa.KVCacheExhausted):
        jc.allocate(9, 100)
    with pytest.raises(tpa.KVCacheExhausted):
        tc.allocate(9, 100)
