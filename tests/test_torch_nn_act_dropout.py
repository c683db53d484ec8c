"""The port's ``nn`` pieces of the vision-zoo slice against the JAX
package on the CPU: the activations ``relu6``, ``sigmoid``, ``silu`` /
``swish``, ``hardsigmoid`` and ``hardswish`` and their layers, the
dropouts, and ``conv2d``'s padding forms and NHWC.

Tolerances:
- ``relu6``, ``hardsigmoid`` and ``hardswish``: values and grads bit for
  bit in float32 and in bfloat16, at the clip edges (-6, -3, 0, 3, 6,
  +-2.9999998, 5.9999995) and on random points: JAX's constants rounded
  to x's dtype, and ``jnp.clip``'s split gradient at a tie;
- ``sigmoid``, ``silu`` / ``swish``: float32 within 1e-6 of the largest
  |out| (grads too), bfloat16 within one bf16 ulp (2**-7) of it, its
  grads within two;
- dropout: bit for bit against JAX's own ``F.dropout`` run with the
  port's mask (``jax.random.bernoulli`` replaced by one returning it),
  in both modes, with and without ``axis``, at p 0, 0.3 and 1, in
  training and eval, float32 and bfloat16;
- ``conv2d``: float32 within 1e-6 of the largest |out| at every padding
  form JAX takes ("SAME" / "VALID" in any case, per-side lists, pairs),
  NCHW and NHWC, "SAME" at stride 2 on an even size (pads 0 low, 1 high);
  bfloat16 within one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.framework.core import Tensor  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

BF16_ULP = 2.0 ** -7
EDGES = [-6.0, -3.0, 0.0, 3.0, 6.0, 2.9999998, -2.9999998, 5.9999995,
         -6.0000005, 3.0000002]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(dtype):
    rng = np.random.RandomState(0)
    x = np.concatenate([np.array(EDGES, np.float32),
                        (4 * rng.randn(500)).astype(np.float32)])
    return x


def _jax_value_and_grad(name, x, dtype, **kw):
    fn = getattr(JF, name)
    a = jnp.asarray(x).astype(dtype)
    val = fn(Tensor(a), **kw)._value
    grad = jax.grad(lambda a: fn(Tensor(a), **kw)._value.astype(
        jnp.float32).sum())(a)
    return (np.asarray(val.astype(jnp.float32)),
            np.asarray(grad.astype(jnp.float32)))


def _port_value_and_grad(name, x, dtype, **kw):
    t = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = getattr(TF, name)(t, **kw)
    assert out.dtype == t.dtype
    out.float().sum().backward()
    return out.detach().float().numpy(), t.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", [("relu6", {}), ("hardswish", {}),
                                     ("hardsigmoid", {}),
                                     ("hardsigmoid", dict(slope=0.2,
                                                          offset=0.4))])
def test_clip_activations_bit_for_bit(name, kw, dtype):
    x = _points(dtype)
    jv, jg = _jax_value_and_grad(name, x, dtype, **kw)
    tv, tg = _port_value_and_grad(name, x, dtype, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tg, jg)


def test_hard_activations_are_jax_not_torch():
    """The traps: torch's hardsigmoid uses 1/6 and torch.clamp gives a
    tie's whole gradient to one side."""
    x = torch.tensor([-2.9999998, 2.9999998, 3.0, -3.0],
                     requires_grad=True)
    hs = TF.hardsigmoid(x)
    assert float(hs[0]) == 0.0
    assert float(torch.nn.functional.hardsigmoid(x)[0]) > 0.0
    TF.hardswish(x).sum().backward()
    assert x.grad.tolist() == [-0.4999999403953552, 1.25, 1.25, -0.25]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sigmoid", "silu", "swish"])
def test_smooth_activations_match_jax(name, dtype):
    x = _points(dtype)
    jv, jg = _jax_value_and_grad(name, x, dtype)
    tv, tg = _port_value_and_grad(name, x, dtype)
    # bf16 grads: two ulps, as JAX rounds sigmoid(x) to bf16 before its
    # s (1 - s) and torch takes s (1 - s) in float32 of the bf16 output
    tols = (1e-6, 1e-6) if dtype == "float32" else (BF16_ULP, 2 * BF16_ULP)
    for got, want, tol in ((tv, jv, tols[0]), (tg, jg, tols[1])):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_layers_match_jax(dtype):
    x = _points(dtype).reshape(2, -1)
    jx = paddle.to_tensor(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pairs = [(jnn.ReLU6(), pnn.ReLU6()), (jnn.Hardswish(), pnn.Hardswish()),
             (jnn.Hardsigmoid(), pnn.Hardsigmoid()),
             (jnn.Hardsigmoid(slope=0.25, offset=0.45),
              pnn.Hardsigmoid(slope=0.25, offset=0.45)),
             (jnn.Hardsigmoid(slope=0.3), pnn.Hardsigmoid(slope=0.3)),
             (jnn.Sigmoid(), pnn.Sigmoid()), (jnn.Swish(), pnn.Swish())]
    for jl, tl in pairs:
        out = tl(tx)
        want = np.asarray(jl(jx)._value.astype(jnp.float32))
        got = out.float().numpy()
        if isinstance(tl, (pnn.Sigmoid, pnn.Swish)):
            tol = 1e-6 if dtype == "float32" else BF16_ULP
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=tol * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


# -- dropout ---------------------------------------------------------------

@pytest.fixture
def port_mask(monkeypatch):
    """Run JAX's F.dropout with a given keep mask: jax.random.bernoulli
    returns it (its shape checked); ``calls`` counts the draws."""
    state = {"mask": None, "calls": 0}

    def bernoulli(key, p, shape):
        assert tuple(shape) == tuple(state["mask"].shape)
        state["calls"] += 1
        return jnp.asarray(state["mask"])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return state


def _mask(shape, p, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < 1.0 - p).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p,axis", [(0.3, None), (0.3, [0, 1]), (0.3, 2),
                                    (1.0, None), (0.0, None)])
def test_dropout_rule_matches_jax_on_the_port_mask(port_mask, p, axis, mode,
                                                   dtype):
    x = np.random.RandomState(1).randn(4, 6, 5, 3).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    jx = paddle.to_tensor(x).astype(dtype)
    axes = None if axis is None else ({axis} if isinstance(axis, int)
                                      else set(axis))
    shape = x.shape if axes is None else tuple(
        n if i in axes else 1 for i, n in enumerate(x.shape))
    port_mask["mask"] = _mask(shape, p, seed=5)
    out = TF.dropout(tx, p, axis=axis, training=True, mode=mode,
                     generator=torch.Generator().manual_seed(5))
    want = JF.dropout(jx, p, axis=axis, training=True, mode=mode)
    assert out.dtype == tx.dtype
    assert port_mask["calls"] == (0 if p == 0.0 else 1)
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        np.asarray(want._value.astype(jnp.float32)))
    if p == 1.0:                     # zeros, and zero grads (not NaN)
        assert not out.detach().float().any()
        out.float().sum().backward()
        assert not tx.grad.float().any()
    # eval: the identity, or x (1 - p) in downscale_in_infer
    ev = TF.dropout(tx, p, axis=axis, training=False, mode=mode)
    jev = JF.dropout(jx, p, axis=axis, training=False, mode=mode)
    np.testing.assert_array_equal(ev.detach().float().numpy(),
                                  np.asarray(jev._value.astype(jnp.float32)))


@pytest.mark.parametrize("fn,fmt,axes", [("dropout2d", "NCHW", (0, 1)),
                                         ("dropout2d", "NHWC", (0, 3)),
                                         ("dropout3d", "NCDHW", (0, 1)),
                                         ("dropout3d", "NDHWC", (0, 4))])
def test_dropout_nd_drops_whole_channels_as_jax(port_mask, fn, fmt, axes):
    shape = (3, 4, 5, 6) if fn == "dropout2d" else (2, 3, 4, 5, 6)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    mshape = tuple(n if i in axes else 1 for i, n in enumerate(shape))
    port_mask["mask"] = _mask(mshape, 0.5, seed=9)
    out = getattr(TF, fn)(torch.from_numpy(x), 0.5, True, fmt,
                          generator=torch.Generator().manual_seed(9))
    want = getattr(JF, fn)(paddle.to_tensor(x), 0.5, True, fmt)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want._value))


def test_dropout_draws_from_the_generator_and_needs_one():
    x = torch.ones(1 << 16)
    g = torch.Generator().manual_seed(0)
    a = TF.dropout(x, 0.25, generator=g)
    b = TF.dropout(x, 0.25, generator=g)
    assert not torch.equal(a, b)           # the stream goes on
    kept = (a != 0).float().mean().item()
    sigma = (0.25 * 0.75 / x.numel()) ** 0.5
    assert abs(kept - 0.75) < 4 * sigma
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / 0.75))
    with pytest.raises(ValueError, match="generator"):
        TF.dropout(x, 0.25)
    assert TF.dropout(x, 0.25, training=False) is x
    assert TF.dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="axis"):
        TF.dropout(x, 0.25, axis=-1, generator=g)
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(x, 0.25, mode="scale", generator=g)


def test_dropout_layers():
    g = torch.Generator().manual_seed(1)
    x = torch.ones(2, 3, 4, 4)
    for layer in (pnn.Dropout(0.5, generator=g),
                  pnn.Dropout(0.5, axis=[0, 1], generator=g),
                  pnn.Dropout2D(0.5, generator=g)):
        out = layer(x)
        assert set(out.unique().tolist()) <= {0.0, 2.0}
        assert torch.equal(layer.eval()(x), x)
    # Dropout2D drops whole channels
    out = pnn.Dropout2D(0.5, generator=g).train()(x)
    per_channel = out.reshape(2, 3, -1)
    assert torch.equal(per_channel.amin(-1), per_channel.amax(-1))
    out = pnn.Dropout3D(0.5, generator=g)(torch.ones(2, 3, 2, 2, 2))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(pnn.Dropout(0.5, mode="downscale_in_infer").eval()(x),
                       x * 0.5)
    with pytest.raises(ValueError, match="generator"):
        pnn.Dropout(0.5)(x)


# -- conv2d's padding forms ------------------------------------------------

# (x shape, weight shape, stride, padding, data_format)
PAD_CASES = {
    "pairs": ((1, 2, 5, 5), (3, 2, 3, 3), 1, [[1, 1], [2, 2]], "NCHW"),
    "per_side": ((1, 2, 5, 5), (3, 2, 3, 3), 1, [1, 1, 2, 2], "NCHW"),
    "uneven": ((2, 2, 6, 7), (3, 2, 3, 3), 1, [0, 2, 1, 0], "NCHW"),
    "same": ((1, 2, 5, 5), (3, 2, 3, 3), 1, "SAME", "NCHW"),
    "valid_lower": ((1, 2, 5, 5), (3, 2, 3, 3), 1, "valid", "NCHW"),
    "nhwc_per_side": ((1, 5, 5, 2), (3, 2, 3, 3), 1, [1, 1, 2, 2], "NHWC"),
    "nhwc_same_s2": ((1, 5, 5, 2), (3, 2, 3, 3), 2, "SAME", "NHWC"),
    "same_s2_even": ((2, 3, 16, 16), (4, 3, 3, 3), 2, "same", "NCHW"),
    "nhwc_int": ((2, 6, 6, 4), (4, 2, 3, 3), (2, 1), 1, "NHWC"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_conv2d_padding_forms_match_jax(case, dtype):
    xs, ws, stride, padding, fmt = PAD_CASES[case]
    groups = 2 if case == "nhwc_int" else 1
    rng = np.random.RandomState(3)
    x = rng.randn(*xs).astype(np.float32)
    w = (0.3 * rng.randn(*ws)).astype(np.float32)
    b = rng.randn(ws[0]).astype(np.float32)
    j = JF.conv2d(paddle.to_tensor(x).astype(dtype), paddle.to_tensor(w),
                  paddle.to_tensor(b), stride, padding, 1, groups, fmt)
    t = TF.conv2d(torch.from_numpy(x).to(getattr(torch, dtype)),
                  torch.from_numpy(w), torch.from_numpy(b), stride, padding,
                  1, groups, fmt)
    want = np.asarray(j._value.astype(jnp.float32))
    assert tuple(t.shape) == want.shape
    tol = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(t.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_same_at_stride_2_pads_the_extra_row_high():
    """lax's SAME: at k 3, stride 2 on 224 the pads are (0, 1); the
    output's first row sees input rows 0-1 only (no low pad)."""
    x = torch.zeros(1, 1, 224, 224)
    x[0, 0, 0, 0] = 1.0
    w = torch.ones(1, 1, 3, 3)
    out = TF.conv2d(x, w, stride=2, padding="SAME")
    assert tuple(out.shape) == (1, 1, 112, 112)
    assert float(out[0, 0, 0, 0]) == 1.0
    x2 = torch.zeros(1, 1, 224, 224)
    x2[0, 0, 223, 223] = 1.0             # reaches the last output via the
    out2 = TF.conv2d(x2, w, stride=2, padding="SAME")   # high pad's row
    assert float(out2[0, 0, 111, 111]) == 1.0


def test_conv2d_layer_takes_nhwc_and_same():
    jl = jnn.Conv2D(3, 4, 3, stride=2, padding="SAME", data_format="NHWC")
    tl = pnn.Conv2D(3, 4, 3, stride=2, padding="SAME", data_format="NHWC",
                    device="cpu")
    with torch.no_grad():
        for n, p in tl.named_parameters():
            p.copy_(torch.from_numpy(np.array(
                dict(jl.named_parameters())[n]._value)))
    x = np.random.RandomState(4).randn(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jl(paddle.to_tensor(x))._value)
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
