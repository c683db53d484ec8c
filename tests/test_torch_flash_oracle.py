"""The port's flash attention against the JAX dense oracles on the CPU.

``flash_attention_plain`` (forward and the grads of q, k and v) against
``flash_attention_reference`` / ``_sdpa_segmented_core`` through JAX's
VJP, for causal or not x (h, hk) in {(4, 4), (4, 2), (4, 1)} x (sq, sk)
in {(64, 64), (32, 96)} x segmented or not (the Pallas kernels
themselves: test_torch_flash_attention.py). Also ``flash_attn_varlen``
against per-document attention, and ``_sdpa_core`` (mask, GQA, causal
with sq < sk) against JAX's in float32. Tolerances are JAX's own: out
atol=2e-5, rtol=2e-4; grads atol=5e-5, rtol=5e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_flash_cases as C  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 96)])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_oracle(causal, h, hk, sq, sk, segmented):
    q, k, v, segs, dout = C.case(causal, h, hk, sq, sk, segmented)
    j_out, j_grads = C.oracle(q, k, v, segs, causal, dout)
    t_out, _, t_grads = C.torch_fwd_bwd(q, k, v, segs, causal, dout)
    np.testing.assert_allclose(t_out, np.asarray(j_out), **C.OUT_TOL)
    C.assert_grads(t_grads, j_grads)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_matches_per_document_attention(causal):
    rng = np.random.RandomState(4)
    h, hk = 4, 2
    lens = [5, 17, 10]
    total = sum(lens) + 4                    # a padded tail of 4 tokens
    q = rng.randn(total, h, C.D).astype(np.float32)
    k = rng.randn(total, hk, C.D).astype(np.float32)
    v = rng.randn(total, hk, C.D).astype(np.float32)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32)
    out = tfa.flash_attn_varlen(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), cu, cu, causal=causal)
    for lo, n in zip(np.cumsum([0] + lens)[:-1], lens):
        sl = slice(int(lo), int(lo) + n)
        ref = tfa.flash_attention_reference(
            torch.tensor(q[None, sl]), torch.tensor(k[None, sl]),
            torch.tensor(v[None, sl]), causal=causal)[0]
        np.testing.assert_allclose(out[sl].numpy(), ref.numpy(),
                                   **C.OUT_TOL)
    assert torch.equal(out[sum(lens):], torch.zeros_like(out[sum(lens):]))


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_core_matches_jax(masked):
    rng = np.random.RandomState(6)
    b, sq, sk, h, hk = 2, 12, 20, 4, 2
    q, k, v = C.qkv(rng, b, sq, sk, h, hk)
    bias = rng.randn(b, 1, sq, sk).astype(np.float32) if masked else None
    t = tfa._sdpa_core(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                       None if bias is None else torch.tensor(bias), True,
                       0.35)
    j = C.jfa._sdpa_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if bias is None else jnp.asarray(bias), True,
                         0.35)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **C.OUT_TOL)


