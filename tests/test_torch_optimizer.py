"""The port's ``Adam`` / ``AdamW`` functional core against JAX's
(``paddle_tpu/optimizer/optimizer.py``) on the same numpy parameters and
gradients, three ``update`` steps.

Cases: float32 parameters (AdamW, Adam with coupled decay, AMSGrad);
bfloat16 parameters with float32 masters; ``moment_dtype="bfloat16"``;
an ``apply_decay_param_fun`` mask by parameter name. Tolerance: none.
Parameters, masters and moments must be bit-identical: both sides do the
same float32 arithmetic in the same order (the bias corrections and
``1 - lr * wd`` are float32 scalars on both), and a bfloat16 parameter or
moment is the rounding of an identical float32 value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework.core import Parameter  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.numpy_bridge import tensor_from_numpy  # noqa: E402

SHAPES = [(8, 16), (16,), (4, 4, 3)]
NAMES = ["linear_0.w_0", "norm_0.b_0", "conv_0.w_0"]
LR = 1e-3


def _to_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_equal(t, j, what):
    np.testing.assert_array_equal(_to_np(t), _to_np(j), err_msg=what)


@pytest.mark.parametrize("cls,kw,dtype", [
    ("AdamW", dict(weight_decay=0.01), "float32"),
    ("Adam", dict(weight_decay=0.01), "float32"),
    ("AdamW", dict(weight_decay=0.01, amsgrad=True), "float32"),
    ("AdamW", dict(weight_decay=0.01), "bfloat16"),
    ("AdamW", dict(weight_decay=0.01, moment_dtype="bfloat16"), "float32"),
    ("AdamW", dict(weight_decay=0.05,
                   apply_decay_param_fun=lambda n: n.endswith(".w_0")),
     "float32"),
])
def test_update_matches_jax(cls, kw, dtype):
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    jparams = [Parameter(jnp.asarray(a, jdt), name=n)
               for a, n in zip(init, NAMES)]
    tparams = [torch.nn.Parameter(torch.tensor(a).to(tdt)) for a in init]
    jo = getattr(jopt, cls)(learning_rate=LR, parameters=jparams, **kw)
    to = getattr(topt, cls)(learning_rate=LR,
                            parameters=list(zip(NAMES, tparams)), **kw)
    j_raw = [p._value for p in jparams]
    j_state = jo.init_state(j_raw)
    t_state = to.init_state(tparams)
    assert ("master" in t_state) == ("master" in j_state)
    for step_grads in grads:
        jg = [jnp.asarray(g, jdt) for g in step_grads]
        tg = [tensor_from_numpy(np.asarray(g), "cpu") for g in jg]
        j_raw, j_state = jo.update(j_raw, jg, j_state,
                                   jnp.asarray(LR, jnp.float32))
        to.update(tparams, tg, t_state, LR)
    for i, (t, j) in enumerate(zip(tparams, j_raw)):
        assert t.dtype == tdt
        _assert_equal(t.detach(), j, f"param {i}")
        keys = ("m", "v") + (("vmax",) if kw.get("amsgrad") else ()) \
            + (("master",) if dtype == "bfloat16" else ())
        for key in keys:
            _assert_equal(t_state[key][i], j_state[key][i], f"{key} {i}")
        if kw.get("moment_dtype"):
            assert t_state["m"][i].dtype == torch.bfloat16
    assert t_state["step"] == int(j_state["step"]) == 3
    if "apply_decay_param_fun" in kw:
        assert to._decay == [True, False, True]


def test_eager_step_and_unported_options():
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.AdamW(learning_rate=0.1, parameters=[w])
    w.grad = torch.ones(3)
    opt.step()
    assert opt._step_count == 1 and bool((w < 1).all())
    opt.clear_grad()
    assert w.grad is None
    # a grad_clip is accepted and clips (tests/test_torch_clip_lr.py
    # holds the clips against JAX's)
    clip = topt.ClipGradByGlobalNorm(1.0)
    opt = topt.AdamW(learning_rate=0.1, parameters=[w], grad_clip=clip)
    w.grad = torch.full((3,), 4.0)
    opt.step()
    np.testing.assert_allclose(float(clip.last_global_norm), 48 ** 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(float(clip.last_scale), 48 ** -0.5,
                               rtol=1e-6)
    with pytest.raises(NotImplementedError):
        topt.Adam(parameters=[w], weight_decay=object())
