"""The port's vision model zoo (``paddle_tpu_torch/vision/models``:
LeNet, AlexNet, VGG, MobileNetV1/V2/V3, SqueezeNet, DenseNet, GoogLeNet,
InceptionV3, ShuffleNetV2) against the JAX package's on the CPU.

One model of each family at a narrow width (``FAMILIES``), float32,
JAX's model built inside ``jax.eval_shape`` and given numpy state with
``Tensor._replace``, the port's given the same state by
``load_numpy_state``: conv weights normal · sqrt(2 / fan_in), Linear
weights [in, out] normal · sqrt(1 / in), biases normal · 0.05,
BatchNorm gains 1 + 0.1 z and shifts ``BN_SHIFT`` + 0.1 z; every
Dropout's ``p`` set to 0 on both sides (the port draws its masks from a
``torch.Generator``, JAX from threefry). The shift of 1 is PR 21's
remedy for BatchNorm stacks that are chaotic in train mode at a batch of
4, carried to stacks without a residual branch: at shift 0 a BatchNorm
followed by ReLU, a per-channel op and another BatchNorm has gain grads
that are 0 in exact arithmetic (scale invariance) and MobileNetV1's
grads sat 3000x the tolerance off JAX's own float64 run; at shift 1 the
ReLUs run mostly linear and JAX's float32 meets the tolerance against
its float64 (MobileNetV1 0.34x, MobileNetV2 0.45x, ShuffleNetV2 0.39x).

Tolerances, each against JAX's float32 result:
- logits within 1e-5 of the largest |logit|, in train mode and, after
  it, in eval mode on the running stats it left;
- every parameter's grad of the cross entropy: rtol 1e-4, atol 1e-5 of
  its largest |grad|. A grad that JAX's float32 puts below ``ZERO_GRAD``
  (1e-5) of the model's largest |grad| is 0 in exact arithmetic (a shift
  that a train-mode BatchNorm downstream removes: MobileNetV2/V3's
  projection BatchNorms, ShuffleNet's depthwise ones, VGG-BN's conv
  biases; JAX's float64 run puts them below 1e-9) and the port's is held
  to that bound;
- running stats within 1e-6 of the largest |stat| of each buffer (and
  a grad within its tolerance), or, where that misses, within twice JAX's
  own float32 miss of it, read off JAX's run of the same state in float64
  (``jax.enable_x64``); stats never above 1e-5 (``_stat_tol``, as
  ``tests/test_torch_vision.py``). JAX's float32 reductions on the CPU
  are less exact than torch's: DenseNet's stem BatchNorm gain grad is
  off JAX's float64 by thousands of tolerances in both packages;
- three steps of ``Momentum(0.01, 0.9)``: losses rtol 1e-4, the running
  stats after them within 1e-5; JAX's side composes what its
  ``TrainStep`` does, the compiled forward and backward and
  ``Momentum.update`` (compiled once), so each family compiles one
  program;
- GoogLeNet: its aux outputs in training (the loss is main + 0.3 x
  (aux1 + aux2), Szegedy et al.), ``None`` in eval.
No tolerance depends on a run of the port. InceptionV3's train-mode
grads are chaotic in float32 for both packages at a batch the CPU
affords (JAX's own float32 137x the tolerance off its float64 at 128 x
128, 1,486-21,265x at other sizes and shifts), so its grads and steps are
taken in eval mode (``EVAL_GRADS``) on the running stats the state
holds; its train-mode logits and stats are held as the others'.

Narrow widths: MobileNets and ShuffleNetV2 at ``scale`` 0.25-0.5; VGG as
``VGG(make_layers(cfg, batch_norm=True), num_classes=0)`` with a short
``cfg`` (its classifier, 25088 x 4096 weights, is held on the card by
``chip_smoke.py``, and the same Dropout / Linear / ReLU classifier at
9216 x 4096 here by AlexNet); DenseNet at a table entry the test adds to
both packages' ``_CFG`` (stem 16, growth 8, two layers a block) at 128 x
128 (at 64 x 64 its last block normalizes 4 values a channel). LeNet,
AlexNet, SqueezeNet, GoogLeNet and InceptionV3 have no width argument
and run whole, InceptionV3 at 128 x 128 (its last stage at 2 x 2).

At full width (num_classes 1000) one constructor of each family gives
JAX's parameter and buffer names and shapes (JAX's under
``jax.eval_shape``, the port's under ``FakeTensorMode``); the other
constructors are held on their configuration tables (VGG's cfgs,
DenseNet's blocks and growth, MobileNetV3's rows) and on their widths
at other scales.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework.core import Tensor, default_generator  # noqa: E402
from paddle_tpu.framework.core import no_grad  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision import models as jmodels  # noqa: E402
from paddle_tpu.vision.models import densenet as jdensenet  # noqa: E402
from paddle_tpu.vision.models import mobilenetv3 as jmbv3  # noqa: E402
from paddle_tpu.vision.models import vgg as jvgg  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.vision import models as tmodels  # noqa: E402
from paddle_tpu_torch.vision.models import densenet as tdensenet  # noqa: E402
from paddle_tpu_torch.vision.models import mobilenetv3 as tmbv3  # noqa: E402
from paddle_tpu_torch.vision.models import shufflenetv2 as tshuffle  # noqa: E402
from paddle_tpu_torch.vision.models import vgg as tvgg  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the narrow DenseNet's table entry: stem 16, growth 8, two layers a block
NARROW_DENSENET = 0, (16, 8, [2, 2, 2, 2])
NARROW_VGG = [8, "M", 16, "M", 512, "M"]
# BatchNorm gains 1 + BN_SPREAD z and shifts BN_SHIFT + BN_SPREAD z
# (module docstring)
BN_SPREAD = 0.1
BN_SHIFT = 1.0
# families whose train-mode grads float32 cannot settle (module
# docstring): their grads and Momentum steps are taken in eval mode
EVAL_GRADS = {"inception_v3"}
# a grad below ZERO_GRAD of the model's largest |grad| in JAX's float32 is
# 0 in exact arithmetic (module docstring) and held to that bound
ZERO_GRAD = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _narrow_densenet():
    key, cfg = NARROW_DENSENET
    for table in (jdensenet._CFG, tdensenet._CFG):
        table[key] = cfg
    yield
    for table in (jdensenet._CFG, tdensenet._CFG):
        del table[key]


def _jax_build(fn):
    """A JAX model built under jax.eval_shape (its values are tracers
    until replaced); the global key the build splits is put back."""
    out = []
    saved = default_generator._key_
    try:
        jax.eval_shape(lambda: out.append(fn()))
    finally:
        default_generator._key_ = saved
    return out[0]


# family: (JAX model, port model (given device=), input shape, classes)
FAMILIES = {
    "lenet": (lambda: jmodels.LeNet(),
              lambda **d: tmodels.LeNet(**d), (4, 1, 28, 28), 10),
    "alexnet": (lambda: jmodels.alexnet(num_classes=10),
                lambda **d: tmodels.alexnet(num_classes=10, **d),
                (2, 3, 64, 64), 10),
    "vgg": (lambda: jvgg.VGG(jvgg.make_layers(NARROW_VGG, True),
                             num_classes=0),
            lambda **d: tvgg.VGG(tvgg.make_layers(NARROW_VGG, True, **d),
                                 num_classes=0, **d),
            (4, 3, 32, 32), 0),
    "mobilenet_v1": (lambda: jmodels.mobilenet_v1(scale=0.25,
                                                  num_classes=10),
                     lambda **d: tmodels.mobilenet_v1(
                         scale=0.25, num_classes=10, **d),
                     (4, 3, 64, 64), 10),
    "mobilenet_v2": (lambda: jmodels.mobilenet_v2(scale=0.25,
                                                  num_classes=10),
                     lambda **d: tmodels.mobilenet_v2(
                         scale=0.25, num_classes=10, **d),
                     (4, 3, 64, 64), 10),
    "mobilenet_v3": (lambda: jmodels.mobilenet_v3_large(scale=0.5,
                                                        num_classes=10),
                     lambda **d: tmodels.mobilenet_v3_large(
                         scale=0.5, num_classes=10, **d),
                     (4, 3, 64, 64), 10),
    "squeezenet": (lambda: jmodels.squeezenet1_1(num_classes=10),
                   lambda **d: tmodels.squeezenet1_1(num_classes=10, **d),
                   (4, 3, 64, 64), 10),
    "densenet": (lambda: jmodels.DenseNet(NARROW_DENSENET[0],
                                          num_classes=10),
                 lambda **d: tmodels.DenseNet(NARROW_DENSENET[0],
                                              num_classes=10, **d),
                 (4, 3, 128, 128), 10),
    "googlenet": (lambda: jmodels.googlenet(num_classes=10),
                  lambda **d: tmodels.googlenet(num_classes=10, **d),
                  (4, 3, 64, 64), 10),
    "inception_v3": (lambda: jmodels.inception_v3(num_classes=10),
                     lambda **d: tmodels.inception_v3(num_classes=10, **d),
                     (4, 3, 128, 128), 10),
    "shufflenet_v2": (lambda: jmodels.ShuffleNetV2(scale=0.25, act="swish",
                                                   num_classes=10),
                      lambda **d: tmodels.ShuffleNetV2(
                          scale=0.25, act="swish", num_classes=10, **d),
                      (4, 3, 64, 64), 10),
}


def _state(jm, seed=0):
    """numpy state for every parameter and buffer of jm (module
    docstring)."""
    rng = np.random.default_rng(seed)
    bufs = {n for n, _ in jm.named_buffers()}
    st = {}
    for n, p in jm.named_parameters():
        shape = tuple(p.shape)
        prefix = n.rsplit(".", 1)[0]
        if prefix + "._mean" in bufs:                      # BatchNorm
            st[n] = (1.0 if n.endswith("weight") else BN_SHIFT) + \
                BN_SPREAD * rng.standard_normal(shape, np.float32)
        elif len(shape) == 4:                              # conv weight
            st[n] = rng.standard_normal(shape, np.float32) * np.sqrt(
                2.0 / np.prod(shape[1:]))
        elif len(shape) == 2:                              # Linear [in, out]
            st[n] = rng.standard_normal(shape, np.float32) * np.sqrt(
                1.0 / shape[0])
        else:                                              # bias
            st[n] = 0.05 * rng.standard_normal(shape, np.float32)
    for n, b in jm.named_buffers():
        st[n] = np.zeros(b.shape) if n.endswith("_mean") else \
            np.ones(b.shape)
    return {n: a.astype(np.float32) for n, a in st.items()}


def _no_dropout(m, dropout_types):
    for layer in (m.sublayers() if hasattr(m, "sublayers")
                  else m.modules()):
        if isinstance(layer, dropout_types):
            layer.p = 0.0


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    jm = _jax_build(FAMILIES[family][0])
    _no_dropout(jm, jnn.Dropout)
    return jm


def _pair(family):
    """JAX's model and the port's holding the same numpy state, in
    train mode, with no dropout."""
    jm = _jax_model(family)
    st = _state(jm)
    for n, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        t._replace(jnp.asarray(st[n]))
    jm.train()
    tm = FAMILIES[family][1](device="cpu")
    _no_dropout(tm, pnn.Dropout)
    tm.load_numpy_state(st)
    return jm, tm, st


def _inputs(family, seed=1):
    shape, classes = FAMILIES[family][2:]
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    # VGG at num_classes=0: the classes are the flattened 7 x 7 features
    n = classes or 512 * 7 * 7
    return x, rng.randint(0, n, shape[0]).astype(np.int64)


def _loss(F, out, y):
    """Cross entropy of the logits; GoogLeNet's main + 0.3 x (aux1 +
    aux2) in training."""
    if isinstance(out, (tuple, list)):
        main, aux1, aux2 = out
        loss = F.cross_entropy(main, y)
        if aux1 is not None:
            loss = loss + 0.3 * (F.cross_entropy(aux1, y)
                                 + F.cross_entropy(aux2, y))
        return loss
    return F.cross_entropy(out.flatten(1), y)


def _jax_loss(out, y):
    return _loss(JF, out, y)


def _torch_loss(out, y):
    return _loss(TF, out, y)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@functools.lru_cache(maxsize=None)
def _jax_step_fn(family):
    """JAX's train-mode forward (logits, the running stats it leaves),
    the eval forward on those stats, and the loss and grads of the
    train-mode forward (of the eval forward for ``EVAL_GRADS``), as one
    compiled program of (params, buffers, x, y); compiled once a
    family."""
    jm = _jax_model(family)

    def f(ps, bs, x, y):
        def loss_f(ps, bs, train):
            if not train:
                jm.eval()
            try:
                out, nb = paddle.jit.functional_call(jm, ps, bs, (x,))
            finally:
                jm.train()
            with no_grad():
                wrap = tuple(None if o is None else Tensor(o) for o in out) \
                    if isinstance(out, (tuple, list)) else Tensor(out)
                loss = _jax_loss(wrap, Tensor(y))
            return loss._value.astype(jnp.float32), (out, nb)
        if family in EVAL_GRADS:
            _, (out, nb) = loss_f(ps, bs, True)
            (loss, (out_eval, _)), g = jax.value_and_grad(
                lambda p: loss_f(p, bs, False), has_aux=True)(ps)
        else:
            (loss, (out, nb)), g = jax.value_and_grad(
                lambda p: loss_f(p, bs, True), has_aux=True)(ps)
            _, (out_eval, _) = loss_f(ps, nb, False)
        return loss, out, nb, g, out_eval

    return jax.jit(f)


def _jax_train_and_eval(family, jm, x, y):
    return _jax_step_fn(family)([p._value for _, p in jm.named_parameters()],
                                [b._value for _, b in jm.named_buffers()],
                                x, y)


def _jax_f64(family, jm, st, x, y):
    """(running stats, grads) of JAX's train-mode step when its model and
    input are float64 (``jax.enable_x64``); jm holds its float32 state
    again after."""
    tensors = list(jm.named_parameters()) + list(jm.named_buffers())
    try:
        with jax.enable_x64(True):
            for n, t in tensors:
                t._replace(jnp.asarray(st[n].astype(np.float64)))
            _, _, nb, g, _ = _jax_train_and_eval(family, jm,
                                                 x.astype(np.float64), y)
            return ([np.asarray(b, np.float64) for b in nb],
                    [np.asarray(a, np.float64) for a in g])
    finally:
        for n, t in tensors:
            t._replace(jnp.asarray(st[n]))


def _grad_miss(got, want):
    """How many times over the grad tolerance (rtol 1e-4, atol 1e-5 of
    the largest |want|) got is from want; <= 1 passes."""
    got, want = _np(got), _np(want)
    tol = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    return float((np.abs(got - want) / tol).max())


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


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_grads_and_stats_match_jax(family):
    jm, tm, st = _pair(family)
    x, y = _inputs(family)
    j_loss, j_out, j_bufs, j_grads, j_eval = _jax_train_and_eval(
        family, jm, x, y)
    if family in EVAL_GRADS:         # eval on the stats the state holds
        tm.eval()
        t_eval = tm(torch.from_numpy(x))
        loss = _torch_loss(t_eval, torch.from_numpy(y))
        tm.train()
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
    else:
        out = tm(torch.from_numpy(x))
        loss = _torch_loss(out, torch.from_numpy(y))
    loss.backward()
    loss = loss.detach()
    if family == "googlenet":            # the aux heads run in training
        assert all(o is not None for o in out) and \
            all(o is not None for o in j_out)
        for k, (a, b) in enumerate(zip(out[1:], j_out[1:])):
            _close(a, b, 1e-5, f"aux{k + 1}")
    _close(_first(out), _first(j_out), 1e-5, "train logits")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    names = [n for n, _ in jm.named_parameters()]
    assert names == [n for n, _ in tm.named_parameters()]
    grads = {n: p.grad for n, p in tm.named_parameters()}
    g_max = max(np.abs(np.asarray(g)).max() for g in j_grads)
    missed = {}
    for n, g in zip(names, j_grads):
        g = np.asarray(g)
        if np.abs(g).max() < ZERO_GRAD * g_max:   # exactly 0: a shift a
            assert _np(grads[n]).__abs__().max() <= \
                ZERO_GRAD * g_max, n                # BatchNorm removes
        elif _grad_miss(grads[n], g) > 1.0:
            missed[n] = _grad_miss(grads[n], g)
    buf_names = [n for n, _ in tm.named_buffers()]
    assert buf_names == [n for n, _ in jm.named_buffers()]
    t_bufs = dict(tm.named_buffers())
    errs = [np.abs(_np(t_bufs[n]) - _np(jb)).max() / np.abs(_np(jb)).max()
            for n, jb in zip(buf_names, j_bufs)]
    if missed or max(errs, default=0.0) > STAT_TOL:
        # widen only from JAX's own float32 error, against its float64
        b64, g64 = _jax_f64(family, jm, st, x, y)
        for n, jb, rb in zip(buf_names, j_bufs, b64):
            _close(t_bufs[n], jb, _stat_tol(jb, rb), n)
        own = {n: _grad_miss(g, r) for n, g, r in zip(names, j_grads, g64)}
        for n, miss in missed.items():
            assert miss <= 2.0 * own[n], (n, miss, own[n])
    # eval reads the running stats the train forward left and keeps them
    tm.eval()
    before = {n: b.clone() for n, b in tm.named_buffers()}
    if family not in EVAL_GRADS:
        with torch.no_grad():
            t_eval = tm(torch.from_numpy(x))
    if family == "googlenet":
        assert t_eval[1] is None and t_eval[2] is None
        assert j_eval[1] is None and j_eval[2] is None
    _close(_first(t_eval), _first(j_eval), 1e-5, "eval logits")
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_jax(family):
    """Three steps of Momentum(0.01, 0.9): the port's ``TrainStep``
    against what JAX's ``TrainStep`` composes, its compiled forward and
    backward (the program the test above compiled) and
    ``Momentum.update``, the running stats carried from step to step."""
    jm, tm, _ = _pair(family)
    x, y = _inputs(family, seed=2)
    jopt_ = jopt.Momentum(learning_rate=0.01, momentum=0.9,
                          parameters=jm.parameters())
    ps = [p._value for _, p in jm.named_parameters()]
    bs = [b._value for _, b in jm.named_buffers()]
    state = jopt_.init_state(ps)
    lr = jnp.asarray(jopt_.get_lr(), jnp.float32)
    update = jax.jit(jopt_.update)
    j_losses = []
    for _ in range(3):
        loss, _, nb, grads, _ = _jax_step_fn(family)(ps, bs, x, y)
        if family not in EVAL_GRADS:     # eval steps keep the stats
            bs = nb
        ps, state = update(ps, list(grads), state, lr)
        j_losses.append(float(loss))
    tm.train(family not in EVAL_GRADS)
    step = TrainStep(tm, _torch_loss,
                     topt.Momentum(learning_rate=0.01, momentum=0.9,
                                   parameters=tm.parameters()))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(3)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert np.isfinite(losses).all()
    for (n, t), jb in zip(tm.named_buffers(), bs):
        _close(t, jb, 1e-5, n)


# one constructor of each family at full width, num_classes 1000
FULL_WIDTH = ["LeNet", "alexnet", "vgg16", "mobilenet_v1", "mobilenet_v2",
              "mobilenet_v3_large", "squeezenet1_0", "densenet121",
              "googlenet", "inception_v3", "shufflenet_v2_x1_0"]


def _named_shapes(m):
    return ([(n, tuple(p.shape)) for n, p in m.named_parameters()],
            [(n, tuple(b.shape)) for n, b in m.named_buffers()])


def _port_fake(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _named_shapes(fn())


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_full_width_names_and_shapes_match_jax(name):
    kw = {} if name == "LeNet" else {"num_classes": 1000}
    jm = _jax_build(lambda: getattr(jmodels, name)(**kw))
    assert _port_fake(lambda: getattr(tmodels, name)(device="cpu", **kw)) \
        == _named_shapes(jm)
    if name != "LeNet":
        with pytest.raises(NotImplementedError):
            getattr(tmodels, name)(pretrained=True, device="cpu")


def test_every_jax_constructor_is_exported():
    for name in jmodels.__dict__:
        if not name.startswith("_") and callable(getattr(jmodels, name)) \
                and getattr(getattr(jmodels, name), "__module__", "") \
                .startswith("paddle_tpu.vision.models"):
            assert callable(getattr(tmodels, name, None)), name


def test_configuration_tables_match_jax():
    assert tvgg._CFGS == jvgg._CFGS
    assert {k: v for k, v in tdensenet._CFG.items()
            if k != NARROW_DENSENET[0]} == \
        {k: v for k, v in jdensenet._CFG.items()
         if k != NARROW_DENSENET[0]}
    assert tmbv3._SMALL_CFG == jmbv3._SMALL_CFG
    assert tmbv3._LARGE_CFG == jmbv3._LARGE_CFG


# widths after make_divisible / the scale tables: every other scale's
# shapes, without the head
SCALED = [("mobilenet_v1", dict(scale=0.75)),
          ("mobilenet_v2", dict(scale=0.75)),
          ("mobilenet_v2", dict(scale=1.4)),
          ("mobilenet_v3_small", dict(scale=0.75)),
          ("mobilenet_v3_large", dict(scale=1.25))] + [
    (n, {}) for n in tshuffle.__all__[1:]]


@pytest.mark.parametrize("name,kw", SCALED,
                         ids=[f"{n}-{kw}" for n, kw in SCALED])
def test_widths_at_other_scales_match_jax(name, kw):
    kw = dict(kw, num_classes=0)
    jm = _jax_build(lambda: getattr(jmodels, name)(**kw))
    assert _port_fake(lambda: getattr(tmodels, name)(device="cpu", **kw)) \
        == _named_shapes(jm)


def test_dropout_layers_share_the_model_generator():
    m = tmodels.googlenet(num_classes=10, device="cpu")
    drops = [d for d in m.modules() if isinstance(d, pnn.Dropout)]
    assert len(drops) == 3 and len({id(d.generator) for d in drops}) == 1
    g = torch.Generator().manual_seed(7)
    m = tmodels.mobilenet_v3_small(scale=0.5, num_classes=10, device="cpu",
                                   generator=g)
    assert [d.generator for d in m.modules()
            if isinstance(d, pnn.Dropout)] == [g]
    # the mask is drawn from it: two runs from one seed are equal
    x = torch.randn(2, 3, 32, 32)
    outs = []
    for _ in range(2):
        g.manual_seed(3)
        outs.append(m.train()(x))
    assert torch.equal(outs[0], outs[1])
    a = tmodels.mobilenet_v3_small(seed=3, device="cpu")
    b = tmodels.mobilenet_v3_small(seed=3, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.mobilenet_v3_large()
