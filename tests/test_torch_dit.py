"""The port's DiT (``paddle_tpu_torch/models/dit.py``) against the JAX
package's (``paddle_tpu/models/dit.py``) on the CPU.

Both models take the same parameters: every one, the zero-initialised
adaLN-Zero projections included, is drawn from a seeded numpy RNG
(normal x 0.02) and set into both (at JAX's own init the output is
exactly 0 and a comparison would prove nothing). Widths: ``dit_tiny``
(hidden 64 over 4 heads: head_dim 16) and "d72" (hidden 144 over 2
heads, depth 2: DiT-XL/2's head_dim 72), ``class_dropout_prob=0``.
Tolerances:
- the float32 forward within 1e-5 of the largest |out|; with
  ``dtype="bfloat16"`` within one bf16 ulp (2**-7) of it;
- every parameter's grad after one backward of the MSE loss: rtol 1e-4
  (atol 1e-5 of the largest |grad| of that parameter, for the elements
  that cancel to ~0);
- five ``TrainStep``s with ``AdamW(1e-3)``, inputs ``(x, t, y)`` and
  the noise as label: losses rtol 1e-4 at every step;
- ``use_recompute`` against the plain forward: loss rtol 1e-5, grads
  rtol 1e-6;
- ``flash_attention_plain`` at head_dim 72 against JAX's
  ``flash_attention`` (its XLA route at these shapes): 1e-6.
Also: the port's own init gives an exactly zero output; parameter names
and shapes equal JAX's; the configs equal JAX's; label dropout raises
without a generator in training, never drops in eval and maps dropped
labels to ``num_classes``; at head_dim 72 the bf16 dq and dk/dv take
the Hopper route and the forward the CUDA-core one, and on a CPU tensor
``flash_attention`` takes the plain route and the CUDA wrappers raise.
On the CPU the port's attention runs the plain version of its kernels.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.models import dit as jdit  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import (DiT, dit_s_2, dit_tiny,  # noqa: E402
                                     dit_xl_2)
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as cfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build as cuda_build  # noqa: E402
from torch.utils import cpp_extension  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

BF16_ULP = 2.0 ** -7
WIDTHS = {"tiny": {}, "d72": dict(hidden_size=144, num_heads=2, depth=2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(width, **kw):
    """JAX's and the port's config at a width (JAX's dit_tiny passes its
    widths itself, so they are replaced afterwards)."""
    kw = dict(class_dropout_prob=0.0, **kw)
    jcfg = dataclasses.replace(jdit.dit_tiny(**kw), **WIDTHS[width])
    return jcfg, dit_tiny(**kw, **WIDTHS[width])


@functools.lru_cache(maxsize=None)
def _jax_model(width, **kw):
    """One JAX model per config (its eager init takes seconds); _pair
    sets every parameter anew."""
    paddle.seed(0)
    return jdit.DiT(_configs(width, **kw)[0])


def _pair(width, seed=1, **kw):
    jm = _jax_model(width, **kw)
    tm = DiT(_configs(width, **kw)[1], device="cpu")
    rng = np.random.RandomState(seed)
    state = {n: (0.02 * rng.randn(*p.shape)).astype(np.float32)
             for n, p in jm.named_parameters()}
    for n, p in jm.named_parameters():
        p.set_value(paddle.to_tensor(state[n])._value)
    tm.load_numpy_state(state)
    return jm, tm


def _inputs(cfg, b=2, seed=2):
    rng = np.random.RandomState(seed)
    s = cfg.input_size
    x = rng.randn(b, cfg.in_channels, s, s).astype(np.float32)
    t = rng.randint(0, 1000, b).astype(np.int32)
    y = rng.randint(0, cfg.num_classes, b).astype(np.int32)
    out_c = cfg.in_channels * (2 if cfg.learn_sigma else 1)
    noise = rng.randn(b, out_c, s, s).astype(np.float32)
    return x, t, y, noise


def _close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1e-30, np.abs(want).max()))


def _jax_loss_and_grads(jm, x, t, y, noise):
    jstep = paddle.jit.TrainStep(
        jm, lambda o, n: JF.mse_loss(o, n),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    loss, _, grads = jax.jit(jstep._make_loss_and_grads())(
        [p._value for p in jstep._p_tensors], [], jax.random.PRNGKey(0),
        (x, t, y), (noise,))
    return float(loss), dict(zip(jstep._param_names, grads))


def _port_loss_and_grads(tm, x, t, y, noise):
    for p in tm.parameters():
        p.grad = None
    out = tm(*(torch.from_numpy(a) for a in (x, t, y)))
    loss = TF.mse_loss(out, torch.from_numpy(noise)).float()
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in tm.named_parameters()}


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_names_shapes_and_configs_match_jax(width):
    jm = _jax_model(width, learn_sigma=True)
    tm = DiT(_configs(width, learn_sigma=True)[1], device="cpu")
    assert [(n, tuple(p.shape)) for n, p in jm.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in tm.named_parameters()]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.num_params() == jm.num_params()
    for jc, tc in ((jdit.dit_tiny(), dit_tiny()), (jdit.dit_s_2(), dit_s_2()),
                   (jdit.dit_xl_2(dtype="bfloat16", learn_sigma=False),
                    dit_xl_2(dtype="bfloat16", learn_sigma=False))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    xl = dit_xl_2()
    assert xl.hidden_size // xl.num_heads == 72


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_forward_matches_jax(width, dtype):
    jm, tm = _pair(width, dtype=dtype)
    x, t, y, _ = _inputs(tm.cfg)
    jx = paddle.to_tensor(x).astype(dtype)._value
    j, _ = jax.jit(lambda ps, *a: paddle.jit.functional_call(jm, ps, [], a))(
        [p._value for p in jm.parameters()], jx, t, y)
    out = tm(torch.from_numpy(x).to(getattr(torch, dtype)),
             torch.from_numpy(t), torch.from_numpy(y))
    assert out.dtype == getattr(torch, dtype)
    assert tuple(out.shape) == (2, 8, 8, 8)
    _close_to_scale(out.detach().float().numpy(), j,
                    1e-5 if dtype == "float32" else BF16_ULP)
    assert np.abs(np.asarray(j, np.float32)).max() > 1e-3


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_grads_match_jax(width):
    jm, tm = _pair(width, learn_sigma=False)
    x, t, y, noise = _inputs(tm.cfg)
    j_loss, j_grads = _jax_loss_and_grads(jm, x, t, y, noise)
    t_loss, t_grads = _port_loss_and_grads(tm, x, t, y, noise)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert list(t_grads) == list(j_grads)
    for name, g in j_grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(t_grads[name].numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=name)
        assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_train_steps_match_jax(width):
    jm, tm = _pair(width, learn_sigma=False)
    x, t, y, noise = _inputs(tm.cfg)
    jstep = paddle.jit.TrainStep(
        jm, lambda o, n: JF.mse_loss(o, n),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, TF.mse_loss,
                      AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    jin = tuple(paddle.to_tensor(a) for a in (x, t, y))
    tin = tuple(torch.from_numpy(a) for a in (x, t, y))
    j_losses = [float(jstep(jin, paddle.to_tensor(noise))) for _ in range(5)]
    t_losses = [float(tstep(tin, torch.from_numpy(noise)))
                for _ in range(5)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_recompute_equals_plain(width):
    x, t, y, noise = _inputs(_configs(width, learn_sigma=False)[1])
    outs = []
    for rc in (False, True):
        _, tm = _pair(width, learn_sigma=False, use_recompute=rc)
        outs.append(_port_loss_and_grads(tm, x, t, y, noise))
    (loss0, g0), (loss1, g1) = outs
    np.testing.assert_allclose(loss1, loss0, rtol=1e-5)
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_own_init_gives_zero_output(mode):
    """adaLN-Zero: the final linear starts at zero, so the output is
    exactly 0 (JAX's TestDiT::test_adaln_zero_init_identity_final)."""
    tm = DiT(dit_tiny(), seed=5, device="cpu")
    getattr(tm, mode)()
    x, t, y, _ = _inputs(tm.cfg, b=1)
    out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
             generator=torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (1, 8, 8, 8)
    assert torch.equal(out, torch.zeros_like(out))
    for blk in tm.blocks:
        lin = blk.adaLN_modulation[1]
        assert not lin.weight.any() and not lin.bias.any()
        assert blk.mlp[0].weight.any()


def test_label_dropout():
    tm = DiT(dit_tiny(class_dropout_prob=1.0), seed=5, device="cpu")
    lab = tm.y_embedder
    y = torch.tensor([1, 3, 7], dtype=torch.int32)
    table = lab.embedding_table.weight
    with pytest.raises(ValueError, match="Generator"):
        lab(y)
    # p = 1 drops every label to the null class num_classes
    dropped = lab(y, torch.Generator().manual_seed(0))
    assert torch.equal(dropped, table[[10, 10, 10]].expand(3, -1))
    lab.dropout_prob = 0.5
    g = torch.Generator().manual_seed(0)
    ys = torch.arange(10, dtype=torch.int32).repeat(20)
    emb = lab(ys, g)
    kept = (emb == table[ys.long()]).all(-1)
    assert bool(((emb == table[10]).all(-1) | kept).all())
    assert 0 < int(kept.sum()) < ys.numel()
    again = lab(ys, torch.Generator().manual_seed(0))
    assert torch.equal(emb, again)
    tm.eval()
    assert torch.equal(lab(y), table[y.long()])          # eval never drops
    tm.train()
    lab.dropout_prob = 0.0
    assert torch.equal(lab(y), table[y.long()])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_d72_matches_jax(causal):
    jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 40, 4, 72).astype(np.float32) for _ in range(3))
    want = np.asarray(jfa.flash_attention(q, k, v, causal=causal))
    out, lse = tfa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, 72 ** -0.5)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6, rtol=1e-6)
    assert tuple(lse.shape) == (2, 4, 40)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_flash_routes_at_d72_on_the_cpu(kind, monkeypatch, tmp_path):
    """At head_dim 72 the bf16 forward, dq and dk/dv take the Hopper
    kernels (a work list is built for each, and kernel_regs goes to the
    library, which cannot be built without nvcc); on a CPU tensor
    ``flash_attention`` takes the plain version and every CUDA wrapper
    raises."""
    assert 72 in cfa.HEAD_DIMS
    assert 72 in cfa.HOPPER_HEAD_DIMS[kind]
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 72).astype(np.float32))
               for _ in range(3))
    np.testing.assert_array_equal(
        tfa.flash_attention(q, k, v).numpy(),
        tfa.flash_attention_plain(q, k, v, False, 72 ** -0.5)[0].numpy())
    monkeypatch.setattr(cfa, "sm_count", lambda device: 132)
    sched, n, pieces, slots = cfa._schedule(
        kind, q.to(torch.bfloat16), 1, 16, 16, 2, 2, False, False)
    assert n == 2 and tuple(sched.shape) == (2, 8)
    assert pieces is None and slots == 1
    # the d-72 kernel is the library's: without nvcc its build raises
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cfa.kernel_regs(kind, 72)
    # float32 keeps the CUDA-core route at every head_dim
    assert cfa._schedule(kind, q, 1, 16, 16, 2, 2, False, False)[0] is None
    lse = torch.zeros(1, 2, 16)
    call = {"fwd": lambda: cfa.flash_fwd_cuda(q, k, v, False, 72 ** -0.5),
            "dq": lambda: cfa.flash_bwd_dq_cuda(q, k, v, q, lse, lse, False,
                                                72 ** -0.5),
            "dkv": lambda: cfa.flash_bwd_dkv_cuda(q, k, v, q, lse, lse,
                                                  False, 72 ** -0.5)}[kind]
    with pytest.raises(ValueError, match="CUDA device"):
        call()
