"""The port's flash attention (``paddle_tpu_torch/ops/flash_attention.py``)
against the JAX Pallas kernels on the CPU.

``flash_attention_plain``, the plain version of the CUDA kernels, is held
against the Pallas kernels in interpret mode with blocks of 32
(``_fa_fwd``/``_fa_bwd`` and ``_fas_fwd``/``_fas_bwd``, the VJP halves of
``flash_attention_pallas`` / ``_segmented``, as
tests/test_varlen_attention.py runs them): out, lse and the grads of q,
k and v, on 6 cases that cover every (h, hk) in {(4, 4), (4, 2), (4, 1)}
with both (sq, sk) in {(64, 64), (32, 96)} and every (causal, segmented)
pair. Each interpret case compiles three kernels (~1.5 s here); the full
product of those values runs against the dense oracles in
test_torch_flash_oracle.py. Tolerances are JAX's own: out and lse
atol=2e-5, rtol=2e-4; grads atol=5e-5, rtol=5e-4 (float32).
Also: fully-masked rows give 0 and no NaN in the grads, and the CPU
routing and the dropout rule of ``flash_attention``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_flash_cases as C  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402


@pytest.mark.parametrize("causal,h,hk,sq,sk,segmented", [
    (True, 4, 4, 64, 64, True), (False, 4, 4, 32, 96, False),
    (False, 4, 2, 64, 64, True), (True, 4, 2, 32, 96, False),
    (True, 4, 1, 64, 64, False), (True, 4, 1, 32, 96, True)])
def test_plain_matches_pallas_kernels(causal, h, hk, sq, sk, segmented):
    q, k, v, segs, dout = C.case(causal, h, hk, sq, sk, segmented)
    j_out, j_lse, j_grads = C.pallas(q, k, v, segs, causal, dout)
    t_out, t_lse, t_grads = C.torch_fwd_bwd(q, k, v, segs, causal, dout)
    np.testing.assert_allclose(t_out, np.asarray(j_out), **C.OUT_TOL)
    np.testing.assert_allclose(t_lse, np.asarray(j_lse), **C.OUT_TOL)
    C.assert_grads(t_grads, j_grads)


def test_fully_masked_rows_zero_and_finite_grads():
    rng = np.random.RandomState(2)
    b, s, h = 1, 32, 2
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in C.qkv(rng, b, s, s, h, h))
    qseg = torch.zeros((b, s), dtype=torch.int32)
    qseg[:, :8] = -1                        # rows 0..7 see nothing
    kseg = torch.zeros((b, s), dtype=torch.int32)
    out, lse = tfa.flash_attention_plain(q, k, v, False, 0.3, qseg, kseg)
    assert torch.equal(out[:, :8], torch.zeros_like(out[:, :8]))
    assert bool((lse[:, :, :8] <= -1e29).all())
    out.sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert torch.equal(q.grad[:, :8], torch.zeros_like(q.grad[:, :8]))
    # causal with sq > sk: the first sq - sk rows see no key
    o2, _ = tfa.flash_attention_plain(q, k[:, :20], v[:, :20], True, 0.3)
    assert torch.equal(o2[:, :12], torch.zeros_like(o2[:, :12]))
    # the JAX kernel agrees on those rows
    j_out = C.jpl.flash_attention_pallas_segmented(
        *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)),
        jnp.asarray(qseg.numpy()), jnp.asarray(kseg.numpy()), False, 0.3,
        32, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **C.OUT_TOL)


def test_routing_on_cpu_and_dropout_needs_a_generator():
    rng = np.random.RandomState(8)
    q, k, v = (torch.tensor(a) for a in C.qkv(rng, 1, 16, 16, 4, 2))
    out = tfa.flash_attention(q, k, v, causal=True)
    plain, _ = tfa.flash_attention_plain(q, k, v, True, 1 / math.sqrt(C.D))
    assert torch.equal(out, plain)
    with pytest.raises(ValueError, match="generator"):
        tfa.flash_attention(q, k, v, dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    dropped = tfa.flash_attention(q, k, v, dropout=0.5, generator=gen)
    assert dropped.shape == q.shape and torch.isfinite(dropped).all()
