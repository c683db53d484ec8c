"""The port's ``SGD`` / ``Momentum`` functional core against JAX's
(``paddle_tpu/optimizer/optimizer.py`` :181-238) on the same numpy
parameters and gradients, three ``update`` steps, and the eager
``step()`` under an ``lr`` scheduler.

Cases: float32 parameters; ``use_nesterov`` on and off; coupled
``weight_decay``; bfloat16 parameters with float32 masters (and a bf16
velocity without ``multi_precision``); ``ClipGradByGlobalNorm`` and
``ClipGradByValue``; a ``None`` gradient. Tolerance: parameters,
masters and velocities bit-identical, or, under the global-norm clip
(whose float32 norm sums in another order than XLA's), within 1e-6 of
their largest |JAX value|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu import regularizer as jreg  # noqa: E402
from paddle_tpu.framework.core import Parameter  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.numpy_bridge import tensor_from_numpy  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402

SHAPES = [(8, 16), (16,), (4, 4, 3)]
LR = 0.1


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check(t, j, what, exact):
    t, j = _np(t), _np(j)
    if exact:
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-6 * np.abs(j).max(),
                                   err_msg=what)


CASES = {
    "sgd": ("SGD", {}, "float32"),
    "sgd_wd": ("SGD", dict(weight_decay=0.01), "float32"),
    "sgd_bf16": ("SGD", dict(weight_decay=0.01), "bfloat16"),
    "sgd_clip_value": ("SGD", dict(grad_clip="value"), "float32"),
    "momentum": ("Momentum", dict(momentum=0.9), "float32"),
    "nesterov": ("Momentum", dict(momentum=0.9, use_nesterov=True),
                 "float32"),
    "momentum_wd": ("Momentum", dict(momentum=0.9, weight_decay=1e-4),
                    "float32"),
    "momentum_bf16": ("Momentum", dict(momentum=0.9, weight_decay=1e-4),
                      "bfloat16"),
    "nesterov_bf16": ("Momentum", dict(momentum=0.9, use_nesterov=True),
                      "bfloat16"),
    "momentum_bf16_no_master": ("Momentum",
                                dict(momentum=0.9, multi_precision=False),
                                "bfloat16"),
    "momentum_clip": ("Momentum", dict(momentum=0.9, grad_clip="global"),
                      "float32"),
    "nesterov_bf16_clip": ("Momentum", dict(momentum=0.9, use_nesterov=True,
                                            grad_clip="global"), "bfloat16"),
}

_CLIPS = {"value": lambda m: m.ClipGradByValue(0.05),
          "global": lambda m: m.ClipGradByGlobalNorm(0.5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case):
    cls, kw, dtype = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    clip = kw.get("grad_clip")
    if clip:
        jkw["grad_clip"] = _CLIPS[clip](jopt)
        tkw["grad_clip"] = _CLIPS[clip](topt)
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jparams = [Parameter(jnp.asarray(a, jdt)) for a in init]
    tparams = [torch.nn.Parameter(torch.tensor(a).to(tdt)) for a in init]
    jo = getattr(jopt, cls)(learning_rate=LR, parameters=jparams, **jkw)
    to = getattr(topt, cls)(learning_rate=LR, parameters=tparams, **tkw)
    j_raw = [p._value for p in jparams]
    j_state = jo.init_state(j_raw)
    t_state = to.init_state(tparams)
    assert ("master" in t_state) == ("master" in j_state)
    for k, step_grads in enumerate(grads):
        jg = [jnp.asarray(g, jdt) for g in step_grads]
        if k == 1:          # a parameter without a gradient is untouched
            jg[1] = None
        tg = [None if g is None else tensor_from_numpy(np.asarray(g), "cpu")
              for g in jg]
        new, j_state = jo.update(j_raw, jg, j_state,
                                 jnp.asarray(LR, jnp.float32))
        j_raw = [old if n is None else n for old, n in zip(j_raw, new)]
        to.update(tparams, tg, t_state, LR)
    exact = clip != "global"
    assert t_state["step"] == int(j_state["step"]) == 3
    for i, (t, j) in enumerate(zip(tparams, j_raw)):
        assert t.dtype == tdt
        _check(t, j, f"param {i}", exact)
        if cls == "Momentum":
            assert t_state["velocity"][i].dtype == \
                (torch.float32 if "master" in t_state else tdt)
            _check(t_state["velocity"][i], j_state["velocity"][i],
                   f"velocity {i}", exact)
        if "master" in t_state:
            _check(t_state["master"][i], j_state["master"][i],
                   f"master {i}", exact)


@pytest.mark.parametrize("cls", ["SGD", "Momentum"])
def test_eager_steps_with_scheduler_match_jax(cls):
    """step() over p.grad with a StepDecay read at every step and
    stepped after it, as a training loop does."""
    rng = np.random.RandomState(1)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [Parameter(jnp.asarray(a)) for a in init]
    tparams = [torch.nn.Parameter(torch.tensor(a)) for a in init]
    jsched = jlr.StepDecay(learning_rate=LR, step_size=1, gamma=0.5)
    tsched = tlr.StepDecay(learning_rate=LR, step_size=1, gamma=0.5)
    kw = dict(momentum=0.9) if cls == "Momentum" else {}
    jo = getattr(jopt, cls)(learning_rate=jsched, parameters=jparams, **kw)
    to = getattr(topt, cls)(learning_rate=tsched, parameters=tparams, **kw)
    for _ in range(3):
        gs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        for jp, tp, g in zip(jparams, tparams, gs):
            jp.grad = Parameter(jnp.asarray(g))
            tp.grad = torch.tensor(g)
        jo.step()
        to.step()
        jsched.step()
        tsched.step()
    for tp, jp in zip(tparams, jparams):
        _check(tp, jp._value, "param", True)


@pytest.mark.parametrize("cls", ["SGD", "Momentum"])
def test_regularizer_objects_raise(cls):
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(NotImplementedError, match="regularizer"):
        getattr(topt, cls)(parameters=[p], weight_decay=jreg.L2Decay(1e-4))
