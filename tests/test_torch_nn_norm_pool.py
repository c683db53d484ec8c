"""The port's ``relu`` / ``ReLU``, ``batch_norm`` and the BatchNorm
layers, and every pooling function and layer against the JAX package on
the CPU (``paddle_tpu/nn/functional/{activation,norm,pooling}.py``,
``paddle_tpu/nn/layer/{activation,norm,pooling}.py``).

Tolerances:
- float32 outputs within 1e-5 of the largest |out|; bfloat16 within one
  bf16 ulp (2**-7) of it;
- float32 grads rtol 1e-4, atol 1e-5 of the largest |grad| of each
  input; bfloat16 grads within four bf16 ulps (2**-5) of it: each side
  rounds its bf16 backward in other places (JAX's sums of the bf16
  cotangent over the batch differ from torch's float32 accumulation by
  up to 1.1% of the largest |grad| here, the bias grad in eval mode
  included, where the forward is bit-identical);
- running stats within 1e-6 after a train-mode forward (bfloat16 stats
  bit-identical: both round the same float32 values);
- max pools and their masks (``return_mask``) equal, int32, on inputs
  without ties. On ties the port takes the window's first maximum in
  row-major order (Paddle's rule, and JAX's ``v2 > v1`` reducer), held
  against a numpy loop; XLA's reduce_window does not fix the order in
  which it meets a padded window's cells, so JAX's mask there may name
  another of the tied cells;
- avg and adaptive avg pools in bfloat16 within four bf16 ulps (2**-5)
  of the largest |out| of JAX's bfloat16 result, and within one bf16 ulp
  (2**-7) of JAX's float32 result on the same (bf16) input: the port
  averages a bf16 window in float32 and rounds once, as Paddle does,
  where JAX sums the window in bf16 (adaptive pools one axis at a time,
  each rounded), a known divergence (ROADMAP Queue 3, "In the reference,
  not the port");
- avg pools on small integers, where every window's sum is exact in
  either dtype, equal to JAX's bit for bit in float32 and bfloat16:
  edge windows, ``ceil_mode`` windows and ``exclusive`` divisors.
Pooling is held on every padding form (int, per dim, per-side pairs,
"SAME", "VALID"), on ``ceil_mode`` (whose last window may start in the
padding), on ``exclusive``, on channel-last layouts, and adaptive pools
on non-divisible bins.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

BF16_ULP = 2.0 ** -7
BF16_GRAD = 2.0 ** -5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a._value if hasattr(a, "_value") else a).astype(
        np.float32)


def _close_to_scale(got, want, tol):
    """Within tol of the largest finite |want|; NaN where want has NaN
    (an exclusive average over a window of padding only is 0 / 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1e-30, np.nanmax(np.abs(want))))


def _tol(dtype):
    return 1e-5 if dtype == "float32" else BF16_ULP


def _pair(a, dtype, grad=False):
    """a numpy array as a JAX tensor and a torch tensor of dtype."""
    j = paddle.to_tensor(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    if grad:
        j.stop_gradient = False
        t.requires_grad_()
    return j, t


def _grad_close(t, j, dtype, what):
    g, want = _np(t.grad), _np(j.grad)
    if dtype == "float32":
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    else:
        _close_to_scale(t.grad, j.grad, BF16_GRAD)
    assert np.abs(want).max() > 0, what


# -- relu ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_matches_jax(dtype):
    x = np.random.RandomState(0).randn(4, 33).astype(np.float32)
    x[0, :5] = 0.0                       # the gradient at exactly 0 is 0
    cot = np.random.RandomState(1).randn(4, 33).astype(np.float32)
    jx, tx = _pair(x, dtype, grad=True)
    jo, to = JF.relu(jx), TF.relu(tx)
    layer_out = pnn.ReLU()(tx)
    assert to.dtype == tx.dtype and torch.equal(layer_out, to)
    _close_to_scale(to, jo, 0.0)
    _close_to_scale(to, jnn.ReLU()(jx), 0.0)
    (jo.astype("float32") * paddle.to_tensor(cot)).sum().backward()
    (to.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    assert not tx.grad[0, :5].any()


# -- batch_norm ---------------------------------------------------------------

# (shape, data_format, mode): 2-D to 5-D, channel first and last, in
# training; every mode at NCHW (eval and use_global_stats read the
# running stats; no weight and bias)
BN_CASES = [((6, 3), "NC", "train"), ((2, 3, 5), "NCL", "train"),
            ((2, 4, 5, 3), "NHWC", "train"),
            ((2, 3, 2, 3, 4), "NCDHW", "train"),
            ((2, 2, 3, 4, 3), "NDHWC", "train")] + [
    ((2, 3, 4, 5), "NCHW", mode)
    for mode in ("train", "eval", "global_stats", "train_no_affine")]


def _bn_inputs(shape, fmt, seed=0):
    ch = 1 if fmt.startswith("NC") else len(shape) - 1
    c = shape[ch]
    rng = np.random.RandomState(seed)
    return dict(x=(2.0 * rng.randn(*shape) + 1.0).astype(np.float32),
                w=rng.randn(c).astype(np.float32),
                b=rng.randn(c).astype(np.float32),
                rm=rng.randn(c).astype(np.float32),
                rv=(rng.rand(c) + 0.5).astype(np.float32),
                cot=rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,fmt,mode", BN_CASES)
def test_batch_norm_matches_jax(shape, fmt, mode, dtype):
    a = _bn_inputs(shape, fmt)
    jx, tx = _pair(a["x"], dtype, grad=True)
    affine = mode != "train_no_affine"
    jw, tw = _pair(a["w"], "float32", grad=True)
    jb, tb = _pair(a["b"], "float32", grad=True)
    jrm, jrv = paddle.to_tensor(a["rm"]), paddle.to_tensor(a["rv"])
    trm, trv = torch.from_numpy(a["rm"].copy()), \
        torch.from_numpy(a["rv"].copy())
    kw = dict(training=mode != "eval",
              use_global_stats=True if mode == "global_stats" else None,
              momentum=0.9, epsilon=1e-5, data_format=fmt)
    jo = JF.batch_norm(jx, jrm, jrv, jw if affine else None,
                       jb if affine else None, **kw)
    to = TF.batch_norm(tx, trm, trv, tw if affine else None,
                       tb if affine else None, **kw)
    assert to.dtype == tx.dtype and tuple(to.shape) == shape
    _close_to_scale(to, jo, _tol(dtype))
    assert trm.dtype == trv.dtype == torch.float32
    for t, j, r in ((trm, jrm, a["rm"]), (trv, jrv, a["rv"])):
        np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=1e-6)
        assert (mode in ("train", "train_no_affine")) == \
            (not np.array_equal(_np(t), r))
    (jo.astype("float32") * paddle.to_tensor(a["cot"])).sum().backward()
    (to.float() * torch.from_numpy(a["cot"])).sum().backward()
    _grad_close(tx, jx, dtype, "x")
    if affine:
        _grad_close(tw, jw, dtype, "w")
        _grad_close(tb, jb, dtype, "b")


def test_batch_norm_layers_match_jax():
    """Names, dtypes and defaults of the layers; a train-mode forward,
    then an eval one on the updated stats, against JAX's layer; a
    bfloat16 layer keeps float32 stats."""
    for jcls, tcls, shape, kw in (
            (jnn.BatchNorm, pnn.BatchNorm, (4, 3), {}),
            (jnn.BatchNorm1D, pnn.BatchNorm1D, (2, 3, 5), {}),
            (jnn.BatchNorm2D, pnn.BatchNorm2D, (2, 3, 4, 5),
             dict(momentum=0.8, epsilon=1e-3)),
            (jnn.BatchNorm2D, pnn.BatchNorm2D, (2, 4, 5, 3),
             dict(data_format="NHWC")),
            (jnn.BatchNorm3D, pnn.BatchNorm3D, (2, 3, 2, 3, 4), {}),
            (jnn.SyncBatchNorm, pnn.SyncBatchNorm, (2, 3, 4, 5), {})):
        c = shape[-1] if kw.get("data_format") == "NHWC" else shape[1]
        jl, tl = jcls(c, **kw), tcls(c, device="cpu", **kw)
        assert [(n, tuple(p.shape)) for n, p in jl.named_parameters()] == \
            [(n, tuple(p.shape)) for n, p in tl.named_parameters()] == \
            [("weight", (c,)), ("bias", (c,))]
        assert [n for n, _ in jl.named_buffers()] == \
            [n for n, _ in tl.named_buffers()] == ["_mean", "_variance"]
        assert torch.equal(tl.weight, torch.ones(c)) and not tl.bias.any()
        assert not tl._mean.any() and torch.equal(tl._variance,
                                                  torch.ones(c))
        x = (np.random.RandomState(2).randn(*shape) * 3 + 1).astype(
            np.float32)
        jx, tx = _pair(x, "float32")
        for train in (True, False):
            jl.train() if train else jl.eval()
            tl.train(train)
            _close_to_scale(tl(tx), jl(jx), 1e-5)
            for n in ("_mean", "_variance"):
                np.testing.assert_allclose(
                    _np(getattr(tl, n)), _np(getattr(jl, n)), rtol=0,
                    atol=1e-6)
    bn = pnn.BatchNorm2D(4, weight_attr=False, bias_attr=False, device="cpu")
    assert bn.weight is None and bn.bias is None
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert pnn.BatchNorm3D(2, device="cpu").data_format == "NCDHW"
    assert pnn.SyncBatchNorm.convert_sync_batchnorm(bn) is bn
    bf = pnn.BatchNorm2D(3, device="cpu").to(torch.bfloat16)
    for n, buf in bf.named_buffers():
        buf.data = buf.data.float()
    bf(torch.randn(2, 3, 4, 4, dtype=torch.bfloat16))
    assert bf._mean.dtype == torch.float32 and bf._mean.any()


# -- pooling ------------------------------------------------------------------

# name: (n, input shape, kernel, stride, padding, ceil_mode, channel_last)
POOL_CASES = {
    "2d_resnet_k3s2p1": (2, (2, 3, 9, 9), 3, 2, 1, False, False),
    "2d_ceil_odd": (2, (2, 3, 7, 7), 2, 2, 0, True, False),
    "2d_ceil_padded": (2, (1, 2, 5, 6), 2, 2, 1, True, False),
    "2d_same": (2, (2, 3, 7, 8), 3, 2, "SAME", False, False),
    "2d_valid": (2, (2, 3, 7, 8), 3, 1, "VALID", False, False),
    "2d_per_dim": (2, (2, 3, 8, 7), (3, 2), (2, 1), (1, 0), False, False),
    "2d_per_side": (2, (2, 3, 8, 7), 3, 2, [[1, 0], [0, 2]], True, False),
    "2d_nhwc": (2, (2, 7, 7, 3), 3, 2, 1, True, True),
    "1d_ceil": (1, (2, 3, 11), 3, 2, 1, True, False),
    "1d_nlc_per_side": (1, (2, 11, 3), 4, 3, [[2, 1]], False, True),
    "3d_per_dim": (3, (1, 2, 5, 6, 7), 2, 2, (1, 0, 1), True, False),
    "3d_ndhwc_same": (3, (1, 5, 6, 4, 2), 3, (2, 1, 2), "SAME", False,
                      True),
}
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _pool_input(shape, ties, seed=3):
    rng = np.random.RandomState(seed)
    if ties:        # few distinct values: windows hold tied maxima
        return rng.randint(-2, 3, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _max_pool_reference(x, n, k, s, pads):
    """numpy: each window's max and the row-major flat index of its first
    maximum in the unpadded spatial dims (0 where the window holds
    padding only), channel first."""
    spatial = x.shape[-n:]
    xp = np.pad(x, [(0, 0)] * (x.ndim - n) + list(pads),
                constant_values=-np.inf)
    outs = [(xp.shape[-n + i] - k[i]) // s[i] + 1 for i in range(n)]
    val = np.empty(x.shape[:-n] + tuple(outs), np.float32)
    idx = np.zeros(val.shape, np.int32)
    for lead in np.ndindex(*x.shape[:-n]):
        for o in np.ndindex(*outs):
            best, arg = -np.inf, 0
            for w in np.ndindex(*k):
                pos = [o[i] * s[i] + w[i] for i in range(n)]
                v = xp[lead + tuple(pos)]
                if v > best:
                    best = v
                    arg = int(np.ravel_multi_index(
                        [pos[i] - pads[i][0] for i in range(n)], spatial))
            val[lead + o], idx[lead + o] = best, arg
    return val, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_and_mask_match_jax(case, dtype):
    n, shape, k, s, p, ceil, last = POOL_CASES[case]
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              data_format=_FORMATS[n][last])
    jfn, tfn = getattr(JF, f"max_pool{n}d"), getattr(TF, f"max_pool{n}d")
    jx, tx = _pair(_pool_input(shape, False), dtype)
    jo, jm = jfn(jx, return_mask=True, **kw)
    to, tm = tfn(tx, return_mask=True, **kw)
    assert to.dtype == tx.dtype and tm.dtype == torch.int32
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm._value))
    assert torch.equal(tfn(tx, **kw), to)
    # ties: the first maximum in row-major order, as a numpy loop finds
    x = _pool_input(shape, True)
    to, tm = tfn(torch.from_numpy(x).to(getattr(torch, dtype)),
                 return_mask=True, **kw)
    xc = np.moveaxis(x, -1, -n - 1) if last else x
    kk = (k,) * n if isinstance(k, int) else tuple(k)
    ss = (s,) * n if isinstance(s, int) else tuple(s)
    pads = TF.pooling._explicit_pads(p, n, xc.shape[-n:], kk, ss, ceil)
    val, idx = _max_pool_reference(xc, n, kk, ss, pads)
    if last:
        val, idx = np.moveaxis(val, -n - 1, -1), np.moveaxis(idx, -n - 1, -1)
    np.testing.assert_array_equal(_np(to), val)
    np.testing.assert_array_equal(tm.numpy(), idx)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool_matches_jax(case, dtype, exclusive):
    n, shape, k, s, p, ceil, last = POOL_CASES[case]
    jx, tx = _pair(_pool_input(shape, False), dtype)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              exclusive=exclusive, data_format=_FORMATS[n][last])
    jo = getattr(JF, f"avg_pool{n}d")(jx, **kw)
    to = getattr(TF, f"avg_pool{n}d")(tx, **kw)
    assert to.dtype == tx.dtype
    _close_to_scale(to, jo, 1e-5 if dtype == "float32" else BF16_GRAD)
    if dtype == "bfloat16":     # JAX's float32 average of the same input
        _close_to_scale(to, getattr(JF, f"avg_pool{n}d")(
            jx.astype("float32"), **kw), BF16_ULP)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool_divisors_exact_on_integers(case, dtype, exclusive):
    """On small integers every window's sum is exact in bf16 and float32
    alike, so each side rounds only its quotient: the port's averages,
    edge windows and exclusive divisors included, equal JAX's bit for
    bit (NaN where a window holds padding only)."""
    n, shape, k, s, p, ceil, last = POOL_CASES[case]
    x = np.random.RandomState(4).randint(-4, 5, shape).astype(np.float32)
    jx, tx = _pair(x, dtype)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              exclusive=exclusive, data_format=_FORMATS[n][last])
    jo = getattr(JF, f"avg_pool{n}d")(jx, **kw)
    to = getattr(TF, f"avg_pool{n}d")(tx, **kw)
    np.testing.assert_array_equal(_np(to), _np(jo))


def test_max_pool_windows_in_padding_only():
    """ceil_mode's last window may lie wholly in the padding: JAX keeps it
    (-inf, mask 0) where torch's own ceil_mode would drop it."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5)
    jx, tx = _pair(x, "float32")
    jo, jm = JF.max_pool1d(jx, 2, 2, 1, return_mask=True, ceil_mode=True)
    to, tm = TF.max_pool1d(tx, 2, 2, 1, return_mask=True, ceil_mode=True)
    assert tuple(to.shape) == (1, 1, 4) and float(to[0, 0, -1]) == -np.inf
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm._value))
    assert torch.nn.functional.max_pool1d(tx, 2, 2, 1,
                                          ceil_mode=True).shape[-1] == 3


# name: (n, input shape, output size, channel_last)
ADAPTIVE_CASES = {
    "1d_nondiv": (1, (2, 3, 7), 3, False),
    "2d_nondiv": (2, (2, 3, 7, 5), (3, 2), False),
    "2d_div": (2, (2, 3, 8, 8), (2, 4), False),
    "2d_global": (2, (2, 3, 7, 7), (1, 1), False),
    "2d_nhwc": (2, (2, 7, 5, 3), (3, 2), True),
    "3d_nondiv": (3, (1, 2, 5, 6, 7), (2, 4, 3), False),
    "3d_ndhwc": (3, (1, 5, 6, 7, 2), 3, True),
}


# avg in both dtypes, max (exact in any dtype) in float32; only the avg
# 2-D / 3-D forms take a data_format
_ADAPTIVE_KINDS = [(c, k, dt) for c in sorted(ADAPTIVE_CASES)
                   for k, dt in (("avg", "float32"), ("avg", "bfloat16"),
                                 ("max", "float32"))
                   if k == "avg" or not ADAPTIVE_CASES[c][3]]


@pytest.mark.parametrize("case,kind,dtype", _ADAPTIVE_KINDS)
def test_adaptive_pool_matches_jax(case, kind, dtype):
    n, shape, out, last = ADAPTIVE_CASES[case]
    jx, tx = _pair(_pool_input(shape, False), dtype)
    kw = dict(data_format=_FORMATS[n][1]) if last else {}
    tfn = getattr(TF, f"adaptive_{kind}_pool{n}d")
    jo = getattr(JF, f"adaptive_{kind}_pool{n}d")(jx, out, **kw)
    to = tfn(tx, out, **kw)
    assert to.dtype == tx.dtype
    if kind == "max":
        np.testing.assert_array_equal(_np(to), _np(jo))
    else:
        _close_to_scale(to, jo, 1e-5 if dtype == "float32" else BF16_GRAD)
        # JAX's float32 average of the same input
        _close_to_scale(to, getattr(JF, f"adaptive_{kind}_pool{n}d")(
            jx.astype("float32"), out, **kw), 1e-5 if dtype == "float32"
            else BF16_ULP)


def test_adaptive_max_pool_mask_is_refused():
    with pytest.raises(NotImplementedError, match="return_mask"):
        TF.adaptive_max_pool2d(torch.zeros(1, 1, 4, 4), 2, return_mask=True)


# (layer name, constructor args, kwargs, input shape)
LAYER_CASES = [
    ("MaxPool1D", (3,), dict(stride=2, padding=1, ceil_mode=True),
     (2, 3, 10)),
    ("MaxPool2D", (3,), dict(stride=2, padding=1), (2, 3, 9, 9)),
    ("MaxPool3D", (2,), dict(stride=2, padding="SAME"), (1, 2, 5, 4, 3)),
    ("AvgPool1D", (3,), dict(stride=1, padding=1, exclusive=False),
     (2, 3, 10)),
    ("AvgPool2D", (2,), dict(stride=2, padding=[[1, 0], [0, 1]],
                             ceil_mode=True), (2, 3, 7, 6)),
    ("AvgPool3D", (2,), dict(stride=1, padding=(1, 0, 0),
                             divisor_override=3), (1, 2, 4, 4, 3)),
    ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 7)),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 7, 7)),
    ("AdaptiveAvgPool3D", ((2, 3, 2),), dict(data_format="NDHWC"),
     (1, 5, 6, 4, 2)),
    ("AdaptiveMaxPool1D", (2,), {}, (2, 3, 7)),
    ("AdaptiveMaxPool2D", ((3, 2),), {}, (2, 3, 7, 5)),
    ("AdaptiveMaxPool3D", (2,), {}, (1, 2, 5, 4, 3)),
]


@pytest.mark.parametrize("name,args,kw,shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_pool_layers_match_jax(name, args, kw, shape):
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(pnn, name)(*args, name="pool", **kw)
    assert list(tl.parameters()) == [] and list(tl.buffers()) == []
    jx, tx = _pair(_pool_input(shape, False), "float32")
    _close_to_scale(tl(tx), jl(jx), 1e-5)
