"""The port's ResNet family (``paddle_tpu_torch/vision/models/resnet.py``)
against the JAX package's (``paddle_tpu/vision/models/resnet.py``) on the
CPU, and ``jit.TrainStep`` with BatchNorm and ``Momentum``.

Both models hold the same state: every conv and fc weight drawn from a
seeded numpy RNG (normal, scaled by sqrt(2 / fan_in)), the fc bias and
the BatchNorm parameters and running stats at their init values except
each residual branch's last BatchNorm gain, 0.1 (``RESIDUAL_GAIN``, as
"zero-init residual" recipes start it small), set into the JAX model and
carried into the port's by ``load_numpy_state``. At Paddle's init (gain
1) ResNet-50 in train mode is chaotic at the batch sizes a CPU test can
afford: a 1e-7 relative change of a b 4 x 128 x 128 input moves its
float64 grads by 6%; at gain 0.1 the port's grads are within 1e-5 of
JAX's. The JAX model is built once per constructor inside
``jax.eval_shape`` (its own init would draw every weight eagerly, a
compile per shape) and then given that state. Inputs b 2 x 3 x 64 x 64 (at 32 x 32 the last stage's
BatchNorm normalizes 2 values a channel and float32 logits are 6e-1
off float64), ``num_classes=10``.
Tolerances, each against JAX's float32 result:
- float32 logits within 1e-5 of the largest |logit|, in train mode and
  in eval mode;
- every parameter's grad of the cross entropy: rtol 1e-4, atol 1e-5 of
  the largest |grad| of that parameter;
- running stats within 1e-6 of the largest |stat| of each buffer after
  a train-mode forward, or within twice JAX's own float32 error on that
  buffer where it is larger: JAX's distance from its model run in
  float64 on the same state (``jax.enable_x64``), over the largest
  |float64 stat|, and never above 1e-5 (``_stat_tol``). A batch mean of
  conv outputs that nearly cancel is that far off float64 in float32:
  on ResNet-50, JAX's up to 1.7e-6 and the port's up to 1.5e-6;
- three ``TrainStep``s under ``Momentum(0.01, 0.9)``: losses rtol 1e-4,
  then the running stats within 1e-5 (JAX's ``functional_call`` updates
  them once a step, and so does the port's eager step);
- bf16 parameters with float32 masters in ``Momentum`` (bench.py's
  resnet row, ``resnet18`` here): two steps' losses within one bf16 ulp
  (2**-7) relative of JAX's; the parameters stay bf16, the masters and
  running stats float32.
No tolerance depends on a run of the port. Float32 itself is far from
float64 on some ResNet-50 grads: JAX's model run in float64 on the same
state puts JAX's float32 grads of layer1.0 up to 3.5% of their largest
|grad| away, and the port's likewise, while the two float32 results
agree within 6e-6.
The other eleven constructors are held on their parameter and buffer
names and shapes and their configs (JAX's under ``jax.eval_shape``, the
port's under ``FakeTensorMode``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework.core import Tensor, default_generator  # noqa: E402
from paddle_tpu.framework.core import no_grad  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision import models as jmodels  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.vision import models as tmodels  # noqa: E402

CONSTRUCTORS = ["resnet18", "resnet34", "resnet50", "resnet101",
                "resnet152", "wide_resnet50_2", "wide_resnet101_2",
                "resnext50_32x4d", "resnext101_32x4d", "resnext50_64x4d",
                "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_shape_build(name, **kw):
    """A JAX model built under jax.eval_shape (its values are tracers
    until replaced); the global key the build splits is put back."""
    out = []
    saved = default_generator._key_
    try:
        jax.eval_shape(lambda: out.append(
            getattr(jmodels, name)(num_classes=10, **kw)))
    finally:
        default_generator._key_ = saved
    return out[0]


# each residual branch's last BatchNorm gain (bn2 of a BasicBlock, bn3
# of a bottleneck): see the module docstring
RESIDUAL_GAIN = 0.1


def _state(jm, seed):
    """numpy state for every parameter and buffer of jm."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in jm.named_parameters()]
    last_bn = ".bn3.weight" if any(".bn3." in n for n in names) \
        else ".bn2.weight"
    st = {}
    for n, p in jm.named_parameters():
        if len(p.shape) > 1 and not n.startswith("fc"):   # conv [o, i, k, k]
            fan_in = int(np.prod(p.shape[1:]))
            st[n] = (rng.randn(*p.shape) * np.sqrt(2.0 / fan_in))
        elif n == "fc.weight":                             # [in, out]
            st[n] = rng.randn(*p.shape) * np.sqrt(1.0 / p.shape[0])
        elif n.endswith(last_bn) and n.startswith("layer"):
            st[n] = np.full(p.shape, RESIDUAL_GAIN)        # branch's last bn
        else:                                              # bn w / b, fc b
            st[n] = np.ones(p.shape) if n.endswith("weight") \
                else np.zeros(p.shape)
    for n, b in jm.named_buffers():
        st[n] = np.zeros(b.shape) if n.endswith("_mean") else \
            np.ones(b.shape)
    return {n: a.astype(np.float32) for n, a in st.items()}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    return _eval_shape_build(name)


def _pair(name, seed=0):
    """JAX's model and the port's holding the same numpy state."""
    jm = _jax_model(name)
    st = _state(jm, seed)
    for n, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        t._replace(jnp.asarray(st[n]))
    jm.train()
    tm = getattr(tmodels, name)(num_classes=10, device="cpu")
    tm.load_numpy_state(st)
    return jm, tm


def _inputs(b=2, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3, 64, 64).astype(np.float32),
            rng.randint(0, 10, b).astype(np.int64))


def _jax_train_forward(jm, x, y):
    """JAX's train-mode forward, its cross entropy and grads, and the
    running stats it leaves, compiled once."""
    params = [p for _, p in jm.named_parameters()]
    bufs = [b for _, b in jm.named_buffers()]

    def f(ps, bs, x, y):
        def loss_f(ps):
            out, nb = paddle.jit.functional_call(jm, ps, bs, (x,))
            with no_grad():
                loss = JF.cross_entropy(Tensor(out), Tensor(y))
            return loss._value.astype(jnp.float32), (out, nb)
        (loss, (out, nb)), g = jax.value_and_grad(loss_f, has_aux=True)(ps)
        return loss, out, nb, g

    return jax.jit(f)([p._value for p in params], [b._value for b in bufs],
                      x, y)


def _jax_f64_stats(jm, st, x):
    """The running stats JAX's train-mode forward leaves when its model
    and input are float64 (``jax.enable_x64``); jm holds its float32
    state again afterwards."""
    tensors = list(jm.named_parameters()) + list(jm.named_buffers())
    try:
        with jax.enable_x64(True):
            for n, t in tensors:
                t._replace(jnp.asarray(st[n].astype(np.float64)))
            nb = jax.jit(lambda ps, bs, a: paddle.jit.functional_call(
                jm, ps, bs, (a,))[1])(
                [p._value for _, p in jm.named_parameters()],
                [b._value for _, b in jm.named_buffers()],
                x.astype(np.float64))
            return [np.asarray(b, np.float64) for b in nb]
    finally:
        for n, t in tensors:
            t._replace(jnp.asarray(st[n]))


# running stats after one train-mode forward: within STAT_TOL of the
# largest |stat| of the buffer, or twice JAX's own float32 error on it
# where that is larger, never above STAT_TOL_CAP
STAT_TOL, STAT_TOL_CAP = 1e-6, 1e-5


def _stat_tol(j32, j64):
    err = np.abs(_np(j32) - j64).max() / np.abs(j64).max()
    return min(max(STAT_TOL, 2.0 * err), STAT_TOL_CAP)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def _close(got, want, tol, what=""):
    """got within tol of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _forward_loss_grads(m, x, y):
    out = m(x)
    loss = TF.cross_entropy(out, y)
    loss.backward()
    return out.detach(), loss.detach(), {
        n: p.grad for n, p in m.named_parameters()}


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_forward_grads_and_stats_match_jax(name):
    jm, tm = _pair(name)
    x, y = _inputs()
    j_loss, j_out, j_bufs, j_grads = _jax_train_forward(jm, x, y)
    out, loss, grads = _forward_loss_grads(
        tm, torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(out.shape) == (2, 10) and out.dtype == torch.float32
    _close(out, j_out, 1e-5, "train logits")
    _close(loss.reshape(1), np.reshape(j_loss, 1), 1e-5, "loss")
    names = [n for n, _ in jm.named_parameters()]
    assert names == [n for n, _ in tm.named_parameters()]
    for n, g in zip(names, j_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(_np(grads[n]), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=n)
        assert np.abs(g).max() > 0, n
    buf_names = [n for n, _ in tm.named_buffers()]
    assert buf_names == [n for n, _ in jm.named_buffers()]
    j64_bufs = _jax_f64_stats(jm, _state(jm, 0), x)
    for n, jb, rb in zip(buf_names, j_bufs, j64_bufs):
        _close(dict(tm.named_buffers())[n], jb, _stat_tol(jb, rb), n)
    # eval mode reads the running stats the train forward left, and
    # leaves them as they are
    for t, nb in zip([b for _, b in jm.named_buffers()], j_bufs):
        t._replace(nb)
    jm.eval()
    tm.eval()
    before = {n: b.clone() for n, b in tm.named_buffers()}
    j_eval = jax.jit(lambda ps, bs, a: paddle.jit.functional_call(
        jm, ps, bs, (a,))[0])([p._value for _, p in jm.named_parameters()],
                              [b._value for _, b in jm.named_buffers()], x)
    with torch.no_grad():
        t_eval = tm(torch.from_numpy(x))
    _close(t_eval, j_eval, 1e-5, "eval logits")
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())
    jm.train()


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_train_steps_match_jax(name):
    jm, tm = _pair(name)
    x, y = _inputs()
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: JF.cross_entropy(o, l),
        jopt.Momentum(learning_rate=0.01, momentum=0.9,
                      parameters=jm.parameters()))
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    j_losses = [float(jstep(jx, jy)) for _ in range(3)]
    step = TrainStep(tm, lambda o, l: TF.cross_entropy(o, l),
                     topt.Momentum(learning_rate=0.01, momentum=0.9,
                                   parameters=tm.parameters()))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(3)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert np.isfinite(losses).all()
    for (n, t), (_, jb) in zip(tm.named_buffers(), jm.named_buffers()):
        _close(t, jb._value, 1e-5, n)


def test_bf16_parameters_with_momentum_masters():
    """bench.py's resnet row at a small size: bf16 parameters, float32
    buffers, Momentum's float32 masters, cross entropy in float32. Two
    steps' losses against JAX's within one bf16 ulp (2**-7) relative."""
    jm, tm = _pair("resnet18", seed=2)
    for n, p in jm.named_parameters():
        p._replace(p._value.astype(jnp.bfloat16))
    tm = tm.to(torch.bfloat16)
    for n, b in tm.named_buffers():       # .to() cast the buffers too
        b.data = b.data.float()
    x, y = _inputs(seed=3)
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: JF.cross_entropy(o.astype("float32"), l),
        jopt.Momentum(learning_rate=0.01, momentum=0.9,
                      parameters=jm.parameters()))
    j_losses = [float(jstep(paddle.to_tensor(x).astype("bfloat16"),
                            paddle.to_tensor(y))) for _ in range(2)]
    opt = topt.Momentum(learning_rate=0.01, momentum=0.9,
                        parameters=tm.parameters())
    step = TrainStep(tm, lambda o, l: TF.cross_entropy(o.float(), l), opt)
    losses = [float(step(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(y))) for _ in range(2)]
    np.testing.assert_allclose(losses, j_losses, rtol=2 ** -7)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    assert all(m.dtype == torch.float32 for m in opt._state["master"])
    assert all(v.dtype == torch.float32 for v in opt._state["velocity"])
    assert float(tm.bn1._mean.abs().max()) > 0


def _config(m):
    return (type(m).__name__, m.groups, m.base_width, m.num_classes,
            m.with_pool, type(m.layer1[0]).__name__,
            m.layer2[0].conv2.groups if hasattr(m.layer2[0], "conv3")
            else None)


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_names_shapes_and_configs_match_jax(name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    jm = _eval_shape_build(name) if name not in ("resnet18", "resnet50") \
        else _jax_model(name)
    with FakeTensorMode():
        tm = getattr(tmodels, name)(num_classes=10, device="cpu")
        t_named = ([(n, tuple(p.shape)) for n, p in tm.named_parameters()],
                   [(n, tuple(b.shape)) for n, b in tm.named_buffers()])
    j_named = ([(n, tuple(p.shape)) for n, p in jm.named_parameters()],
               [(n, tuple(b.shape)) for n, b in jm.named_buffers()])
    assert t_named == j_named
    assert _config(tm) == _config(jm)
    assert ("fc.weight", (2048 if "18" not in name and "34" not in name
                          else 512, 10)) in t_named[0]
    assert "layer1.0.bn1._mean" in dict(t_named[1])
    with pytest.raises(NotImplementedError):
        getattr(tmodels, name)(pretrained=True, device="cpu")


def test_no_pool_no_head_and_buffers_dtype():
    m = tmodels.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    out = m.eval()(torch.zeros(1, 3, 64, 64))
    assert tuple(out.shape) == (1, 512, 2, 2)
    pooled = tmodels.resnet18(num_classes=0, device="cpu").eval()(
        torch.zeros(1, 3, 64, 64))
    assert tuple(pooled.shape) == (1, 512, 1, 1)
    assert all(b.dtype == torch.float32 for b in m.buffers())
    a = tmodels.resnet18(seed=3, device="cpu")
    b = tmodels.resnet18(seed=3, device="cpu")
    c = tmodels.resnet18(seed=4, device="cpu")
    assert torch.equal(a.conv1.weight, b.conv1.weight)
    assert not torch.equal(a.conv1.weight, c.conv1.weight)


def test_load_numpy_state_requires_every_buffer():
    jm, tm = _pair("resnet18")
    st = _state(jm, 0)
    missing = dict(st)
    del missing["layer1.0.bn1._mean"]
    with pytest.raises(ValueError, match=r"missing \['layer1.0.bn1._mean'\]"):
        tm.load_numpy_state(missing)
    extra = dict(st, **{"layer1.0.bn1._variance2": st["bn1._variance"]})
    with pytest.raises(ValueError, match="unexpected"):
        tm.load_numpy_state(extra)
    bad = dict(st, **{"bn1._variance": st["bn1._variance"][:3]})
    with pytest.raises(ValueError, match="bn1._variance"):
        tm.load_numpy_state(bad)
    st["bn1._variance"] = np.full(64, 2.5, np.float32)
    tm.load_numpy_state(st)
    assert torch.equal(tm.bn1._variance, torch.full((64,), 2.5))
    # a state of parameters only leaves out every running stat
    params = {n: a for n, a in st.items() if not n.endswith(
        ("_mean", "_variance"))}
    with pytest.raises(ValueError, match=r"missing \['bn1._mean'"):
        tm.load_numpy_state(params)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.resnet50()
