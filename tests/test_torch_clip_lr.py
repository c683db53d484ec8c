"""The port's gradient clips (``paddle_tpu_torch/optimizer/clip.py``,
``incubate/distributed/models/moe/grad_clip.py``) and learning-rate
schedulers (``optimizer/lr.py``) against the JAX package's on the CPU.

Tolerances:
- each clip's ``apply`` on seeded gradients with ``None`` entries:
  float32 within 1e-6 of the largest |JAX gradient| (the port's float32
  norms sum in another order than XLA's, so a scale may differ in its
  last bit); bfloat16 within one bf16 step (2**-8) of the largest |JAX
  gradient| (that last bit may round a product the other way);
  ``ClipGradForMOEByGlobalNorm.partition_norms`` within 1e-6 relative;
- three ``AdamW.update`` steps with each clip: parameters and moments
  within 1e-6 of their largest |JAX value|;
- every scheduler: 40 values equal to JAX's exactly (the same Python
  float arithmetic), its ``state_dict`` equal, and a scheduler rebuilt
  from a ``state_dict`` taken at step 20 gives the same 20 values after;
- four ``TrainStep`` losses of ``moe_tiny`` (dense and ragged dispatch)
  under ``AdamW`` + ``LinearWarmup(MultiStepDecay)`` +
  ``ClipGradForMOEByGlobalNorm(0.5)``, stepping the scheduler after each
  step: within 1e-5 relative of JAX's ``TrainStep``, and the clip scales
  every step (its scale below 1).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework.core import Parameter  # noqa: E402
from paddle_tpu.incubate.distributed.models import moe as jmoe_clip  # noqa: E402,E501
from paddle_tpu.models import moe_lm as jmoe_lm  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe_clip  # noqa: E402,E501
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import moe_lm as tmoe_lm  # noqa: E402
from paddle_tpu_torch.numpy_bridge import tensor_from_numpy  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402

SHAPES = [(8, 16), (16,), (4, 4, 3), (32, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(1e-30, np.abs(want).max()))


def _grads(dtype, seed=0, scale=3.0):
    """JAX gradients and the port's, bit for bit, with None at 1 and 4."""
    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jg = [jnp.asarray(rng.randn(*s).astype(np.float32) * scale, jdt)
          for s in SHAPES]
    jg.insert(1, None)
    jg.append(None)
    tg = [None if g is None else tensor_from_numpy(np.asarray(g), "cpu")
          for g in jg]
    return jg, tg


# -- clips -------------------------------------------------------------------

CLIPS = {
    "value": lambda m, ex: m.ClipGradByValue(2.5, -1.5),
    "norm": lambda m, ex: m.ClipGradByNorm(4.0),
    "global_norm": lambda m, ex: m.ClipGradByGlobalNorm(5.0),
    "moe_global_norm": lambda m, ex: m.ClipGradForMOEByGlobalNorm(
        5.0, is_expert_param_func=ex),
}


def _clip(side, name, ex=None):
    mod = {"jax": (jopt, jmoe_clip), "port": (topt, tmoe_clip)}[side]
    return CLIPS[name](mod[1] if name.startswith("moe") else mod[0], ex)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_apply_matches_jax(name, dtype):
    jg, tg = _grads(dtype)
    want = _clip("jax", name).apply(jg)
    got = _clip("port", name).apply(tg)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        assert a.dtype == tg[i].dtype
        _close(a, b, tol, f"grad {i}")
    if name != "value":     # the clip must have scaled something
        assert any(not torch.equal(a, g) for a, g in zip(got, tg)
                   if g is not None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_partition_norms_match_jax(dtype):
    jg, tg = _grads(dtype, seed=1)
    # the "parameters" are the gradients themselves: experts are 0 and 3
    jex = _clip("jax", "moe_global_norm",
                lambda p: any(p is jg[i] for i in (0, 3)))
    tex = _clip("port", "moe_global_norm",
                lambda p: any(p is tg[i] for i in (0, 3)))
    want = jex.partition_norms(jg, jg)
    got = tex.partition_norms(tg, tg)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # the clip's own norm is the plain global norm over both parts
    tex.apply(tg)
    np.testing.assert_allclose(float(tex.last_global_norm) ** 2,
                               float(got[0] + got[1]), rtol=1e-5)
    assert float(got[0]) > 0 and float(got[1]) > 0


def test_global_norm_of_no_gradients_passes_through():
    for clip in (topt.ClipGradByGlobalNorm(1.0),
                 tmoe_clip.ClipGradForMOEByGlobalNorm(1.0)):
        assert clip.apply([None, None]) == [None, None]
        assert clip.last_global_norm is None


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_adamw_update_with_clip_matches_jax(name):
    rng = np.random.RandomState(2)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [Parameter(jnp.asarray(a)) for a in init]
    tparams = [torch.nn.Parameter(torch.tensor(a)) for a in init]
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jparams,
                    weight_decay=0.1, grad_clip=_clip("jax", name))
    to = topt.AdamW(learning_rate=1e-2, parameters=tparams,
                    weight_decay=0.1, grad_clip=_clip("port", name))
    j_raw = [p._value for p in jparams]
    j_state, t_state = jo.init_state(j_raw), to.init_state(tparams)
    for step in range(3):
        jg, tg = _grads("float32", seed=10 + step)
        jg, tg = [g for g in jg if g is not None], \
            [g for g in tg if g is not None]
        tg[2] = None                 # a parameter without a gradient
        jg[2] = None
        new, j_state = jo.update(j_raw, jg, j_state,
                                 jnp.asarray(1e-2, jnp.float32))
        j_raw = [o if n is None else n for o, n in zip(j_raw, new)]
        to.update(tparams, tg, t_state, 1e-2)
    for i, (t, j) in enumerate(zip(tparams, j_raw)):
        _close(t, j, 1e-6, f"param {i}")
        for key in ("m", "v"):
            _close(t_state[key][i], j_state[key][i], 1e-6, f"{key} {i}")
    np.testing.assert_array_equal(tparams[2].detach().numpy(), init[2])


def test_eager_step_clips_and_reads_scheduler():
    sched = tlr.LinearWarmup(tlr.MultiStepDecay(0.1, milestones=[3]),
                             warmup_steps=2, start_lr=0.0, end_lr=0.1)
    w = torch.nn.Parameter(torch.ones(4))
    clip = topt.ClipGradByGlobalNorm(1.0)
    opt = topt.AdamW(learning_rate=sched, parameters=[w], grad_clip=clip)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    lrs = []
    for _ in range(5):
        w.grad = torch.full((4,), 10.0)
        lrs.append(opt.get_lr())
        opt.step()
        sched.step()
    assert lrs == pytest.approx([0.0, 0.05, 0.1, 0.1, 0.01])
    np.testing.assert_allclose(float(clip.last_global_norm), 20.0)
    np.testing.assert_allclose(float(clip.last_scale), 0.05, rtol=1e-6)
    assert w.grad.eq(10.0).all()       # the clip leaves p.grad as it was
    plain = topt.AdamW(learning_rate=0.5, parameters=[w])
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25


# -- schedulers --------------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 30],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.5, decay_steps=12, end_lr=0.01, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.MultiStepDecay(4.2e-4, milestones=[8, 9], gamma=0.316),
        warmup_steps=4, start_lr=0.0, end_lr=4.2e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [6, 15, 25],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        1.0, factor=0.5, patience=2, cooldown=1, threshold=0.01),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=15, eta_min=0.01),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 3 else 1.0),
    "OneCycleLR": lambda m: m.OneCycleLR(1.0, total_steps=30,
                                         anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
    "LinearLR": lambda m: m.LinearLR(0.5, total_steps=25),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.001),
}
# ReduceOnPlateau's metrics: falling, then flat, then rising
METRICS = [3.0, 2.5, 2.4, 2.4, 2.41, 2.39, 2.5, 2.6, 1.0, 1.0] * 4


def _step(sched, i, port):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        m = METRICS[i]
        # the port's takes a tensor as well as a float
        sched.step(torch.tensor(m) if port and i % 2 else m)
    else:
        sched.step()


def test_every_scheduler_is_ported():
    assert sorted(SCHEDULERS) == sorted(set(jlr.__all__) - {"LRScheduler"})
    assert tlr.__all__ == jlr.__all__


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    jv, tv = [], []
    for i in range(40):
        jv.append(j())
        tv.append(t())
        assert t.state_dict() == j.state_dict(), i
        _step(j, i, False)
        _step(t, i, True)
        if i == 19:
            saved = t.state_dict()
    assert tv == jv
    assert len(set(tv)) > 2, tv         # the schedule moved
    # a scheduler rebuilt from step 20's state continues identically
    again = SCHEDULERS[name](tlr)
    again.set_state_dict(saved)
    rebuilt = []
    for i in range(20, 40):
        rebuilt.append(again())
        _step(again, i, True)
    assert rebuilt == tv[20:]


# -- MoE training with the recipe's optimizer ---------------------------------

@functools.lru_cache(maxsize=None)
def _jax_model(mode):
    paddle.seed(0)
    return jmoe_lm.MoEForCausalLM(jmoe_lm.moe_tiny(moe_dispatch_mode=mode))


def _recipe(m, sched_mod, clip_mod, is_expert):
    sched = sched_mod.LinearWarmup(
        sched_mod.MultiStepDecay(1e-2, milestones=[2, 3], gamma=0.316),
        warmup_steps=1, start_lr=1e-3, end_lr=1e-2)
    clip = clip_mod.ClipGradForMOEByGlobalNorm(
        0.5, is_expert_param_func=is_expert)
    opt_mod = jopt if sched_mod is jlr else topt
    return sched, clip, opt_mod.AdamW(
        learning_rate=sched, beta1=0.9, beta2=0.95, weight_decay=0.1,
        parameters=m.parameters(), grad_clip=clip)


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_moe_train_steps_with_clip_and_schedule_match_jax(mode):
    jm = _jax_model(mode)
    tm = tmoe_lm.MoEForCausalLM(tmoe_lm.moe_tiny(moe_dispatch_mode=mode),
                                device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    experts = {id(p) for n, p in tm.named_parameters()
               if ".moe.w" in n}
    j_sched, _, j_opt = _recipe(jm, jlr, jmoe_clip, None)
    t_sched, t_clip, t_opt = _recipe(tm, tlr, tmoe_clip,
                                     lambda p: id(p) in experts)
    jstep = paddle.jit.TrainStep(jm, lambda o, l: jm.loss(o, l), j_opt)
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l), t_opt)
    ids = np.random.RandomState(3).randint(0, 512, (2, 16)).astype(np.int32)
    jx, tx = paddle.to_tensor(ids), torch.from_numpy(ids)
    j_losses, t_losses, lrs, scales = [], [], [], []
    for _ in range(4):
        lrs.append((j_opt.get_lr(), t_opt.get_lr()))
        j_losses.append(float(jstep(jx, jx)))
        t_losses.append(float(tstep(tx, tx)))
        scales.append(float(t_clip.last_scale))
        j_sched.step()
        t_sched.step()
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert len({a for a, _ in lrs}) == 4, lrs
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert all(s < 1.0 for s in scales), scales
    assert t_losses[-1] < t_losses[0]
