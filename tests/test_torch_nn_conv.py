"""The port's ``nn`` pieces of the DiT slice against the JAX package on
the CPU: ``conv2d`` / ``Conv2D``, ``Sequential`` / ``LayerList``,
``Silu`` / ``GELU`` and ``mse_loss`` / ``MSELoss``.

Tolerances:
- ``conv2d`` and ``Conv2D``: float32 within 1e-6 of the largest |out|;
  bfloat16 within one bf16 ulp (2**-7) of it; at a stride-p patchify, a
  padded stride-1 case and a tuple stride / padding case with dilation
  and groups;
- ``Silu`` and ``GELU`` (exact and tanh): float32 within 1e-6, bfloat16
  within one bf16 ulp of the largest |out|;
- ``mse_loss`` at each reduction: float32 rtol 1e-6, bfloat16 within one
  bf16 ulp (the result stays bfloat16, as JAX's does).
Also: the containers' names ("0", "1", ...), indexing and slices as
JAX's; the initializers' bounds; the refused padding forms and layouts.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a, dtype):
    """a numpy array as a JAX tensor and a torch tensor of dtype."""
    return (paddle.to_tensor(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close_to_scale(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want._value if hasattr(want, "_value") else want,
                      np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# (x shape, weight shape, stride, padding, dilation, groups)
CONV_CASES = {
    "patchify": ((2, 4, 8, 8), (16, 4, 2, 2), 2, 0, 1, 1),
    "padded_stride1": ((2, 3, 9, 9), (8, 3, 3, 3), 1, 1, 1, 1),
    "tuple_dilated_grouped": ((1, 4, 10, 11), (6, 2, 3, 3), (1, 2), (2, 1),
                              2, 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, dtype):
    xs, ws, stride, padding, dilation, groups = CONV_CASES[case]
    rng = np.random.RandomState(0)
    x = rng.randn(*xs).astype(np.float32)
    w = (0.3 * rng.randn(*ws)).astype(np.float32)
    b = rng.randn(ws[0]).astype(np.float32)
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, "float32")       # float32 weights, cast to x's dtype
    jb, tb = _both(b, "float32")
    j = JF.conv2d(jx, jw, jb, stride, padding, dilation, groups)
    t = TF.conv2d(tx, tw, tb, stride, padding, dilation, groups)
    assert t.dtype == getattr(torch, dtype)
    _close_to_scale(t, j, 1e-6 if dtype == "float32" else BF16_ULP)
    # no bias
    _close_to_scale(TF.conv2d(tx, tw, None, stride, padding, dilation,
                              groups),
                    JF.conv2d(jx, jw, None, stride, padding, dilation,
                              groups),
                    1e-6 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_layer_matches_jax(dtype):
    paddle.seed(0)
    jl = jnn.Conv2D(4, 16, 2, stride=2)
    tl = pnn.Conv2D(4, 16, 2, stride=2, device="cpu")
    assert [(n, tuple(p.shape)) for n, p in jl.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in tl.named_parameters()]
    with torch.no_grad():
        for n, p in tl.named_parameters():
            p.copy_(torch.from_numpy(np.array(
                dict(jl.named_parameters())[n]._value)))
    x = np.random.RandomState(1).randn(2, 4, 8, 8).astype(np.float32)
    jx, tx = _both(x, dtype)
    _close_to_scale(tl(tx), jl(jx), 1e-6 if dtype == "float32" else BF16_ULP)


def test_conv2d_layer_init_bounds_and_generator():
    g = torch.Generator().manual_seed(3)
    layer = pnn.Conv2D(4, 32, 3, generator=g, device="cpu").requires_grad_(
        False)
    fan_in = 4 * 9
    assert layer.weight.dtype == torch.float32
    assert float(layer.weight.abs().max()) <= np.sqrt(6.0 / fan_in)
    assert float(layer.weight.abs().max()) > 0.5 * np.sqrt(6.0 / fan_in)
    assert float(layer.bias.abs().max()) <= 1.0 / np.sqrt(fan_in)
    again = pnn.Conv2D(4, 32, 3, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    assert torch.equal(layer.weight, again.weight)
    assert pnn.Conv2D(4, 8, 1, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("kw", [dict(padding=[[0, 0], [0, 0], [1, 1],
                                                 [1, 1]]),
                                dict(padding="FULL"),
                                dict(data_format="CHWN")])
def test_conv2d_refuses_what_is_not_ported(kw):
    """Padding strings, per-side lists and NHWC are ported
    (tests/test_torch_nn_act_dropout.py); paddle's full four-pair form
    raises ValueError as JAX's conv2d does, and so do an unknown padding
    string and layout."""
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1)
    with pytest.raises(ValueError, match="conv2d"):
        TF.conv2d(x, w, **kw)


def test_containers_names_and_indexing_match_jax():
    paddle.seed(0)
    js = jnn.Sequential(jnn.Linear(4, 8), jnn.Silu(), jnn.Linear(8, 2))
    ts = pnn.Sequential(pnn.Linear(4, 8, device="cpu"), pnn.Silu(),
                        pnn.Linear(8, 2, device="cpu"))
    assert [n for n, _ in js.named_parameters()] == \
        [n for n, _ in ts.named_parameters()] == \
        ["0.weight", "0.bias", "2.weight", "2.bias"]
    assert len(ts) == len(js) == 3
    assert isinstance(ts[1], pnn.Silu) and ts[-1] is ts[2]
    assert isinstance(ts[1:], pnn.Sequential) and len(ts[1:]) == 2
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    ts.load_state_dict({n: torch.from_numpy(np.array(p._value))
                        for n, p in js.named_parameters()})
    _close_to_scale(ts(torch.from_numpy(x)), js(paddle.to_tensor(x)), 1e-6)
    od = pnn.Sequential(collections.OrderedDict(a=pnn.Silu(), b=pnn.GELU()))
    assert [n for n, _ in od.named_children()] == ["a", "b"]
    assert isinstance(od[1], pnn.GELU)

    jll = jnn.LayerList([jnn.Linear(2, 2) for _ in range(3)])
    tll = pnn.LayerList([pnn.Linear(2, 2, device="cpu") for _ in range(3)])
    assert [n for n, _ in jll.named_parameters()] == \
        [n for n, _ in tll.named_parameters()]
    assert len(tll) == 3 and tll[-1] is tll[2] and list(tll)[0] is tll[0]
    assert isinstance(tll[1:], pnn.LayerList) and len(tll[1:]) == 2
    with pytest.raises(NotImplementedError):
        tll(torch.zeros(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_layers_match_jax(dtype):
    x = (3 * np.random.RandomState(2).randn(4, 33)).astype(np.float32)
    jx, tx = _both(x, dtype)
    tol = 1e-6 if dtype == "float32" else BF16_ULP
    for jl, tl in ((jnn.Silu(), pnn.Silu()), (jnn.SiLU(), pnn.SiLU()),
                   (jnn.GELU(), pnn.GELU()),
                   (jnn.GELU(approximate=True), pnn.GELU(approximate=True)),
                   (jnn.GELU(True), pnn.GELU(True))):
        out = tl(tx)
        assert out.dtype == tx.dtype
        _close_to_scale(out, jl(jx), tol)
    assert not pnn.GELU().approximate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_loss_matches_jax(dtype, reduction):
    rng = np.random.RandomState(4)
    a, b = rng.randn(2, 4, 8, 8).astype(np.float32), \
        rng.randn(2, 4, 8, 8).astype(np.float32)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    j = JF.mse_loss(ja, jb, reduction)
    for t in (TF.mse_loss(ta, tb, reduction),
              pnn.MSELoss(reduction)(ta, tb)):
        assert t.dtype == ta.dtype and tuple(t.shape) == tuple(j.shape)
        if dtype == "float32":
            np.testing.assert_allclose(t.numpy(), np.asarray(j._value),
                                       rtol=1e-6)
        else:
            _close_to_scale(t, j, BF16_ULP)
    with pytest.raises(ValueError, match="reduction"):
        TF.mse_loss(ta, tb, "max")


def test_initializers():
    from paddle_tpu_torch.nn import initializer as I
    g = torch.Generator().manual_seed(0)
    u = I.Uniform(-0.5, 0.25)((1000,), "float32", g)
    assert float(u.min()) >= -0.5 and float(u.max()) <= 0.25
    k = I.KaimingUniform(nonlinearity="leaky_relu")((64, 8, 3, 3),
                                                     "float32", g)
    assert float(k.abs().max()) <= np.sqrt(6.0 / 72)
    assert I.calculate_gain("leaky_relu") == np.sqrt(2.0 / (1 + 0.01 ** 2))
    assert I.calculate_gain("tanh") == 5.0 / 3.0
