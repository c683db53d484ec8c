"""Cases shared by the flash-attention test files: seeded float32 inputs,
packed-document segment ids, the port's plain version with autograd,
and the JAX references (the Pallas kernels in interpret mode with blocks
of 32, and the dense oracles). Tolerances are JAX's own."""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas import flash_attention as jpl
from paddle_tpu_torch.ops import flash_attention as tfa

# paddle_tpu.ops re-exports a function of the module's name
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

D = 8
OUT_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def qkv(rng, b, sq, sk, h, hk, d=D):
    return (rng.randn(b, sq, h, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, hk, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, hk, d).astype(np.float32) * 0.5)


def segments(rng, b, s, n_docs):
    segs = np.zeros((b, s), np.int32)
    for i in range(b):
        for c in np.sort(rng.choice(np.arange(1, s), n_docs - 1,
                                    replace=False)):
            segs[i, c:] += 1
    return segs


def pallas(q, k, v, segs, causal, dout):
    """(out, lse, (dq, dk, dv)) of the Pallas kernels (interpret mode)."""
    a = [jnp.asarray(x) for x in (q, k, v)]
    if segs is None:
        out, res = jpl._fa_fwd(*a, causal, None, 32, 32)
        grads = jpl._fa_bwd(causal, None, 32, 32, res, jnp.asarray(dout))
    else:
        qs, ks = (jnp.asarray(x) for x in segs)
        out, res = jpl._fas_fwd(*a, qs, ks, causal, None, 32, 32)
        grads = jpl._fas_bwd(causal, None, 32, 32, res,
                             jnp.asarray(dout))[:3]
    return out, res[-1], grads


def oracle(q, k, v, segs, causal, dout):
    """(out, (dq, dk, dv)) of the JAX dense oracles."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if segs is None:
        def fn(*a):
            return jfa.flash_attention_reference(*a, causal=causal)
    else:
        qs, ks = (jnp.asarray(x) for x in segs)

        def fn(*a):
            return jfa._sdpa_segmented_core(*a, qs, ks, causal, scale)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return out, vjp(jnp.asarray(dout))


def torch_fwd_bwd(q, k, v, segs, causal, dout):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    seg_t = (None, None) if segs is None else \
        tuple(torch.tensor(s) for s in segs)
    out, lse = tfa.flash_attention_plain(*ts, causal,
                                         1.0 / math.sqrt(q.shape[-1]),
                                         *seg_t)
    (out * torch.tensor(dout)).sum().backward()
    return out.detach().numpy(), lse.detach().numpy(), \
        [t.grad.numpy() for t in ts]


def case(causal, h, hk, sq, sk, segmented):
    rng = np.random.RandomState(h * 10 + hk + sq)
    b = 2
    q, k, v = qkv(rng, b, sq, sk, h, hk)
    segs = None
    if segmented:
        segs = (segments(rng, b, sq, 3), segments(rng, b, sk, 3))
    dout = rng.randn(b, sq, h, D).astype(np.float32)
    return q, k, v, segs, dout


def assert_grads(t_grads, j_grads):
    for name, t, j in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(t, np.asarray(j), **GRAD_TOL,
                                   err_msg=f"d{name}")
