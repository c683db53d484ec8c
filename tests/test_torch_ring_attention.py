"""The port's ring attention (``paddle_tpu_torch/distributed/ring_attention.py``)
and its blocks (``ops/flash_attention.py``: ``flash_attention_with_lse``,
``flash_attention_bwd_block``) against the JAX package on the CPU.

- The ring blocks against JAX's Pallas ``flash_attention_with_lse`` /
  ``flash_attention_bwd_block`` in interpret mode with blocks of 32, on
  the ring's three block kinds (the causal diagonal, an "earlier" block
  with sq > sk and a "later" block with sq < sk, not causal), the
  backward run against a lse merged by ``_merge_pair`` from two blocks.
  Tolerances are JAX's flash ones (``_torch_flash_cases.py``): out and
  lse atol 2e-5, rtol 2e-4; grads atol 5e-5, rtol 5e-4. Interpret
  cases take ~1.5 s per kernel here, so three are sampled.
- ``flash_attention_bwd_plain`` given a merged lse against JAX's
  ``_jnp_blk_bwd`` (same tolerances).
- ``ring_attention`` against JAX's on a ``ProcessMesh(np.arange(n),
  ["sep"])`` (the port's mesh on ``["cpu"] * n``): zigzag and plain ring,
  causal and not, GQA 4:2, n = 2 and 4. Out atol 2e-5, rtol 2e-4; grads
  of q, k and v atol 1e-4, rtol 1e-3 (JAX's ring tests).
- ``ring_attention_local`` on pre-zigzagged chunks, the zigzag index
  round trip, the merge of two empty partials, the block routing on
  the CPU, and the ring under ``torch.utils.checkpoint`` and
  saved-tensor hooks.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_flash_cases as C  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as cfa  # noqa: E402

# both packages export a function of the module's name
jra = importlib.import_module("paddle_tpu.distributed.ring_attention")
tra = importlib.import_module("paddle_tpu_torch.distributed.ring_attention")

RING_OUT_TOL = dict(atol=2e-5, rtol=2e-4)
RING_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _merged(q, k, v, causal, rng):
    """out (q's dtype) and lse of q against (k, v) merged with a second,
    random kv block: the merged result a ring step's backward runs
    against."""
    k2 = rng.randn(*k.shape).astype(np.float32) * 0.5
    v2 = rng.randn(*v.shape).astype(np.float32) * 0.5
    o1, l1 = jra._jnp_blk_fwd(*(jnp.asarray(a) for a in (q, k, v)), causal,
                              1 / math.sqrt(q.shape[-1]))
    o2, l2 = jra._jnp_blk_fwd(*(jnp.asarray(a) for a in (q, k2, v2)), False,
                              1 / math.sqrt(q.shape[-1]))
    out, lse = jra._merge_pair(o1, l1, o2, l2)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("kind,sq,sk,h,hk", [
    ("diagonal", 64, 64, 4, 2), ("earlier", 64, 32, 4, 4),
    ("later", 32, 64, 4, 1)])
def test_ring_blocks_match_pallas(kind, sq, sk, h, hk):
    causal = kind == "diagonal"
    rng = np.random.RandomState(sq + 3 * sk + h + hk)
    q, k, v = C.qkv(rng, 2, sq, sk, h, hk)
    scale = 1 / math.sqrt(C.D)
    j_out, j_lse = C.jpl.flash_attention_with_lse(
        *(jnp.asarray(a) for a in (q, k, v)), causal, scale, 32, 32)
    t_out, t_lse = tfa.flash_attention_with_lse(
        *(torch.tensor(a) for a in (q, k, v)), causal, scale)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **C.OUT_TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **C.OUT_TOL)
    out, lse = _merged(q, k, v, causal, rng)
    do = rng.randn(*q.shape).astype(np.float32)
    j_grads = C.jpl.flash_attention_bwd_block(
        *(jnp.asarray(a) for a in (q, k, v, out, lse, do)), causal, scale,
        32, 32)
    t_grads = tfa.flash_attention_bwd_block(
        *(torch.tensor(a) for a in (q, k, v, out, lse, do)), causal, scale)
    assert t_grads[0].dtype == torch.float32
    assert t_grads[1].shape == (2, sk, hk, C.D)
    C.assert_grads([g.numpy() for g in t_grads], j_grads)


@pytest.mark.parametrize("causal,sq,sk,h,hk", [
    (True, 48, 48, 4, 2), (False, 48, 16, 4, 4), (False, 16, 48, 4, 1),
    (True, 32, 32, 6, 3)])
def test_plain_bwd_matches_jnp_block(causal, sq, sk, h, hk):
    rng = np.random.RandomState(7 * sq + sk + h)
    q, k, v = C.qkv(rng, 2, sq, sk, h, hk)
    out, lse = _merged(q, k, v, causal, rng)
    do = rng.randn(*q.shape).astype(np.float32)
    scale = 0.3
    j = jra._jnp_blk_bwd(*(jnp.asarray(a) for a in (q, k, v, out, lse, do)),
                         causal, scale)
    t = tfa.flash_attention_bwd_plain(
        *(torch.tensor(a) for a in (q, k, v, out, lse, do)), causal, scale)
    C.assert_grads([g.numpy() for g in t], j)


def _ring_inputs(seed, b, s, h, hk, d=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _cpu_mesh(n):
    return tdist.ProcessMesh(np.arange(n), ["sep"], devices=["cpu"] * n)


@pytest.mark.parametrize("n,causal,zigzag,h,hk", [
    (2, True, True, 4, 2), (4, True, True, 4, 4), (4, True, False, 4, 2),
    (2, True, False, 4, 4), (2, False, False, 4, 2), (4, False, False, 4, 2)])
def test_ring_attention_matches_jax(n, causal, zigzag, h, hk):
    q, k, v, do = _ring_inputs(n * 10 + h + hk + causal + zigzag, 2, 32, h,
                               hk)
    jmesh = jdist.ProcessMesh(np.arange(n), ["sep"])
    j_out, vjp = jax.vjp(
        lambda a, b_, c: jdist.ring_attention(a, b_, c, jmesh, causal=causal,
                                              zigzag=zigzag),
        *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    t_out = tdist.ring_attention(*ts, _cpu_mesh(n), causal=causal,
                                 zigzag=zigzag)
    t_grads = torch.autograd.grad(t_out, ts, torch.tensor(do))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **RING_OUT_TOL)
    for name, t, j in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **RING_GRAD_TOL,
                                   err_msg=f"d{name}")


def test_zigzag_default_and_local_layout():
    """ring_attention_local on pre-zigzagged chunks (JAX's
    test_zigzag_local_layout) equals the dense reference and the
    whole-tensor entry, whose default for causal is zigzag."""
    from paddle_tpu.ops.flash_attention import flash_attention_reference
    n, s = 4, 64
    q, k, v, _ = _ring_inputs(7, 1, s, 2, 2)
    ref = np.asarray(flash_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True))
    order = tra.zigzag_indices(s, n)
    inv = tra.inverse_zigzag_indices(s, n)
    chunks = [list(torch.tensor(x[:, order]).chunk(n, dim=1))
              for x in (q, k, v)]
    outs = tdist.ring_attention_local(*chunks, causal=True, zigzag=True)
    local = torch.cat(outs, dim=1).numpy()[:, inv]
    np.testing.assert_allclose(local, ref, **RING_OUT_TOL)
    whole = tdist.ring_attention(*(torch.tensor(x) for x in (q, k, v)),
                                 _cpu_mesh(n))
    np.testing.assert_array_equal(whole.numpy(), local)
    with pytest.raises(ValueError, match="causal"):
        tdist.ring_attention_local(*chunks, causal=False, zigzag=True)


def test_zigzag_indices_equal_jax():
    for s, n in ((64, 8), (32, 2), (48, 3), (8192, 4)):
        order = tra.zigzag_indices(s, n)
        np.testing.assert_array_equal(order, jra.zigzag_indices(s, n))
        np.testing.assert_array_equal(order[tra.inverse_zigzag_indices(s, n)],
                                      np.arange(s))
    with pytest.raises(ValueError, match="divisible"):
        tra.zigzag_indices(30, 8)


def test_merge_of_empty_partials_stays_finite():
    z_o = torch.zeros((1, 4, 2, 8))
    z_l = torch.full((1, 2, 4), -1e30)
    out, lse = tra._merge_pair(z_o, z_l, z_o, z_l)
    assert torch.equal(out, z_o) and bool(torch.isfinite(lse).all())
    o2 = torch.randn((1, 4, 2, 8))
    l2 = torch.randn((1, 2, 4))
    out, lse = tra._merge_pair(z_o, z_l, o2, l2)
    torch.testing.assert_close(out, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, l2, rtol=0, atol=0)


def test_block_routing_on_cpu():
    q, k, v, _ = _ring_inputs(3, 1, 16, 4, 2)
    ts = [torch.tensor(x) for x in (q, k, v)]
    mesh = _cpu_mesh(2)
    before = (cfa.launches_fwd, cfa.launches_dq, cfa.launches_dkv)
    auto = tdist.ring_attention(*ts, mesh)
    plain = tdist.ring_attention(*ts, mesh, use_pallas=False)
    assert torch.equal(auto, plain)
    assert (cfa.launches_fwd, cfa.launches_dq, cfa.launches_dkv) == before
    with pytest.raises(ValueError, match="CUDA"):
        tdist.ring_attention(*ts, mesh, use_pallas=True)
    with pytest.raises(ValueError, match="does not split"):
        tdist.ring_attention(*(t[:, :15] for t in ts), mesh, zigzag=False)
    # a non-contiguous view (a zigzag half at b > 1) gives what a copy gives
    q2 = torch.tensor(_ring_inputs(4, 2, 16, 4, 2)[0])
    half = q2[:, 8:]
    assert not half.is_contiguous()
    kv = (torch.tensor(_ring_inputs(5, 2, 8, 2, 2)[1]),) * 2
    a = tfa.flash_attention_with_lse(half, *kv)
    b_ = tfa.flash_attention_with_lse(half.contiguous(), *kv)
    assert all(torch.equal(x, y) for x, y in zip(a, b_))


def test_ring_under_checkpoint_and_saved_tensor_hooks():
    """The ring's residuals are saved tensors: non-reentrant
    checkpointing recomputes the ring to the same grads, and
    saved-tensor hooks see every rank's (q, k, v, out, lse)."""
    from torch.utils.checkpoint import checkpoint
    n = 4
    mesh = _cpu_mesh(n)
    ts = [torch.tensor(x, requires_grad=True)
          for x in _ring_inputs(11, 1, 32, 4, 2)[:3]]

    def loss(q, k, v):
        return (tdist.ring_attention(q, k, v, mesh) ** 2).sum()

    ref = torch.autograd.grad(loss(*ts), ts)
    ckpt = torch.autograd.grad(checkpoint(loss, *ts, use_reentrant=False),
                               ts)
    seen = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append(t) or t, lambda t: t):
        hooked = loss(*ts)
    hooked = torch.autograd.grad(hooked, ts)
    assert len(seen) >= 5 * n
    for a, b_, c in zip(ref, ckpt, hooked):
        assert torch.equal(a, b_) and torch.equal(a, c)
