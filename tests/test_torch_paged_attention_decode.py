"""The port's one-token paged decode attention against the JAX package.

``paged_attention_decode_reference`` (the plain version of the CUDA
decode kernel) and the dispatcher ``paged_attention_decode`` on CPU
tensors are held against the JAX Pallas kernel
``paged_attention_decode_pallas``, run in interpret mode as
tests/test_serving.py runs it, and against the JAX reference, on the
same numpy inputs. Interpret-mode cases compile for ~1.5 s each, so the
cases are sampled, not crossed. Tolerance: float32 at atol 2e-5 and
rtol 2e-4 (the JAX test's); bf16 at atol 1e-2 against the JAX reference
computed in float32 on the same bf16 values (one bf16 ulp near 1 is
0.0078); the int8 pool, routed through the ragged oracle in both
packages, at atol 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.paged_attention import \
    paged_attention_decode as jax_decode  # noqa: E402
from paddle_tpu.ops.paged_attention import \
    paged_attention_decode_reference as jax_reference  # noqa: E402
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention_decode_pallas  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention_decode, paged_attention_decode_reference)

F32_TOL = dict(atol=2e-5, rtol=2e-4)


def _case(seed, b, nh, kvh, d, bs, nblocks, mp, ctx, scratch_rows=()):
    """Numpy q, pools, tables and context lengths. Rows listed in
    scratch_rows get a table that is all page 0 (the dense engine's
    scratch page)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nh, d).astype(np.float32)
    kc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
    vc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
    tables = rng.choice(np.arange(1, nblocks), (b, mp),
                        replace=False).astype(np.int32)
    for r in scratch_rows:
        tables[r] = 0
    return q, kc, vc, tables, np.asarray(ctx, np.int32)


def _port(q, kc, vc, tables, ctx, fn=paged_attention_decode_reference):
    out = fn(torch.from_numpy(q), torch.from_numpy(kc),
             torch.from_numpy(vc), torch.from_numpy(tables),
             torch.from_numpy(ctx))
    return out.numpy()


@pytest.mark.parametrize("name,spec", [
    ("serving_test_case", dict(seed=0, b=3, nh=8, kvh=2, d=64, bs=16,
                               nblocks=32, mp=4, ctx=[5, 37, 64])),
    ("d128_bs64_unaligned", dict(seed=1, b=2, nh=4, kvh=1, d=128, bs=64,
                                 nblocks=12, mp=4, ctx=[70, 201])),
    ("ctx1_scratch_page", dict(seed=2, b=3, nh=4, kvh=2, d=64, bs=16,
                               nblocks=16, mp=3, ctx=[1, 33, 1],
                               scratch_rows=(0, 2))),
])
def test_plain_version_matches_pallas_kernel(name, spec):
    q, kc, vc, tables, ctx = _case(**spec)
    want = np.asarray(paged_attention_decode_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(ctx)))
    np.testing.assert_allclose(_port(q, kc, vc, tables, ctx), want,
                               **F32_TOL)
    # the dispatcher sends CPU tensors to the plain version
    np.testing.assert_allclose(
        _port(q, kc, vc, tables, ctx, paged_attention_decode), want,
        **F32_TOL)


@pytest.mark.parametrize("spec", [
    dict(seed=3, b=4, nh=8, kvh=2, d=64, bs=16, nblocks=40, mp=8,
         ctx=[1, 16, 17, 128]),
    dict(seed=4, b=2, nh=8, kvh=8, d=256, bs=8, nblocks=20, mp=6,
         ctx=[9, 48]),
])
def test_plain_version_matches_jax_reference(spec):
    q, kc, vc, tables, ctx = _case(**spec)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(tables),
                                    jnp.asarray(ctx)))
    np.testing.assert_allclose(_port(q, kc, vc, tables, ctx), want,
                               **F32_TOL)


def test_bf16_plain_version():
    q, kc, vc, tables, ctx = _case(seed=5, b=3, nh=8, kvh=2, d=128, bs=16,
                                   nblocks=24, mp=6, ctx=[3, 50, 96])
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kc, vc))
    out = paged_attention_decode_reference(qb, kb, vb,
                                           torch.from_numpy(tables),
                                           torch.from_numpy(ctx))
    assert out.dtype == torch.bfloat16
    # the same bf16 values, attended in float32 by the JAX reference
    want = np.asarray(jax_reference(
        *(jnp.asarray(t.float().numpy()) for t in (qb, kb, vb)),
        jnp.asarray(tables), jnp.asarray(ctx)))
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-2,
                               rtol=0)


def test_ctx_zero_gives_exact_zeros():
    q, kc, vc, tables, _ = _case(seed=6, b=2, nh=4, kvh=2, d=64, bs=16,
                                 nblocks=8, mp=2, ctx=[0, 0])
    out = _port(q, kc, vc, tables, np.asarray([0, 9], np.int32))
    assert np.all(out[0] == 0.0)
    assert np.abs(out[1]).max() > 0


def test_int8_pool_matches_jax_tuple_pool():
    rng = np.random.RandomState(7)
    b, nh, kvh, d, bs, nblocks, mp = 3, 8, 2, 64, 16, 24, 4
    q = rng.randn(b, nh, d).astype(np.float32)

    def plane():
        return (rng.randint(-127, 128, (nblocks, kvh, bs, d)).astype(np.int8),
                rng.uniform(0.001, 0.05, (nblocks, kvh, bs))
                .astype(np.float32))

    kp, vp = plane(), plane()
    tables = rng.choice(nblocks, (b, mp), replace=False).astype(np.int32)
    ctx = np.asarray([1, 30, 64], np.int32)
    want = np.asarray(jax_decode(
        jnp.asarray(q), tuple(jnp.asarray(a) for a in kp),
        tuple(jnp.asarray(a) for a in vp), jnp.asarray(tables),
        jnp.asarray(ctx)))
    got = paged_attention_decode(
        torch.from_numpy(q), tuple(torch.from_numpy(a) for a in kp),
        tuple(torch.from_numpy(a) for a in vp), torch.from_numpy(tables),
        torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_dispatcher_refuses_other_devices():
    q = torch.empty((2, 4, 64), device="meta")
    pool = torch.empty((4, 2, 16, 64), device="meta")
    tables = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_decode(q, pool, pool, tables,
                               torch.ones(2, dtype=torch.int32,
                                          device="meta"))
