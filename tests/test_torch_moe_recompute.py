"""The port's MoE recompute (``paddle_tpu_torch/models/moe_lm.py``,
``MoEDecoderLayer.forward`` and ``_MoEBlockFn``) and the full-width MoE
configs against the JAX package's on the CPU, one torch thread.

JAX's model parameters are carried into the port's by
``load_numpy_state``; JAX's loss and grads come from its compiled
``TrainStep._make_loss_and_grads``. Tolerances, as in
``tests/test_torch_moe.py``:
- logits within 1e-5 of the largest |JAX logit|, the loss (with its aux
  term) within 1e-5 relative, every parameter's grad within 1e-4 of its
  largest |JAX grad|: for each recompute granularity ("full",
  "full_attn", "core_attn") under dense and ragged dispatch, and for a
  DeepSeek-shaped (16 experts at top-6, 2 shared, the first layer dense)
  and a Qwen-shaped (no dense layer, 14 / 2 heads: group 7) tiny config
  under "full";
- the router's grad from the aux loss alone under "full" equals the one
  without recompute within 1e-6 of its largest value, and is nonzero;
- ``aux_losses()`` read before and after ``backward()``: the same
  tensors (the recomputation stores nothing over them);
- three ``TrainStep``s of ``AdamW(1e-3)`` with recompute "full": losses
  within 1e-5 relative of JAX's;
- ``num_params`` / ``num_activated_params`` of
  ``deepseek_moe_16b_like(num_hidden_layers=3)`` and
  ``qwen2_moe_a14b_like(num_hidden_layers=2)`` equal JAX's exactly.
  Neither side allocates the weights: JAX's model is built under
  ``jax.eval_shape`` and the port's under ``FakeTensorMode``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework import core as jcore  # noqa: E402
from paddle_tpu.models import moe_lm as jmoe_lm  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import moe_lm as tmoe_lm  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

GRANULARITIES = ("full", "full_attn", "core_attn")
# tiny configs shaped like the two full-width ones
SHAPED = {
    "deepseek": dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                     moe_intermediate_size=16, num_hidden_layers=3,
                     num_attention_heads=4, num_key_value_heads=4,
                     num_experts=16, num_experts_per_tok=6,
                     num_shared_experts=2, first_k_dense_replace=1,
                     max_position_embeddings=64),
    "qwen": dict(vocab_size=256, hidden_size=112, intermediate_size=96,
                 moe_intermediate_size=16, num_hidden_layers=2,
                 num_attention_heads=14, num_key_value_heads=2,
                 num_experts=16, num_experts_per_tok=8,
                 num_shared_experts=1, first_k_dense_replace=0,
                 max_position_embeddings=64),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(1e-30, np.abs(want).max()))


def _cfg(mod, shape, **kw):
    if shape == "tiny":
        return mod.moe_tiny(**kw)
    return mod.MoEConfig(**SHAPED[shape], **kw)


@functools.lru_cache(maxsize=None)
def _jax_model(shape, **kw):
    """One JAX model per config (its eager init takes seconds)."""
    paddle.seed(0)
    return jmoe_lm.MoEForCausalLM(_cfg(jmoe_lm, shape, **kw))


def _pair(shape="tiny", **kw):
    jm = _jax_model(shape, **kw)
    tm = tmoe_lm.MoEForCausalLM(_cfg(tmoe_lm, shape, **kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _ids(vocab, b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _jax_out_loss_grads(jm, ids):
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    params = [p._value for p in jstep._p_tensors]
    out, _ = jax.jit(lambda ps, x: paddle.jit.functional_call(
        jm, ps, [], (x,)))(params, ids)
    loss, _, grads = jax.jit(jstep._make_loss_and_grads())(
        params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    return out, float(loss), dict(zip(jstep._param_names, grads))


def _check_against_jax(jm, tm, vocab):
    ids = _ids(vocab)
    j_out, j_loss, j_grads = _jax_out_loss_grads(jm, ids)
    x = torch.from_numpy(ids)
    out = tm(x)
    loss = tm.loss(out, x)
    before = tm.model.aux_losses()
    loss.backward()
    after = tm.model.aux_losses()
    assert len(before) == len(after) > 0
    assert all(a is b for a, b in zip(before, after))
    _close(out.detach().numpy(), j_out, 1e-5, "logits")
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert list(grads) == list(j_grads)
    for name, g in j_grads.items():
        _close(grads[name].numpy(), g, 1e-4, name)
        assert np.abs(np.asarray(g)).max() > 0, name


@pytest.mark.parametrize("mode", ["dense", "ragged"])
@pytest.mark.parametrize("gran", GRANULARITIES)
def test_recompute_loss_grads_match_jax(gran, mode):
    jm, tm = _pair(moe_dispatch_mode=mode, use_recompute=True,
                   recompute_granularity=gran)
    _check_against_jax(jm, tm, 512)


@pytest.mark.parametrize("mode", ["dense", "ragged"])
@pytest.mark.parametrize("shape", sorted(SHAPED))
def test_full_width_shapes_match_jax(shape, mode):
    jm, tm = _pair(shape, moe_dispatch_mode=mode, use_recompute=True,
                   recompute_granularity="full")
    if shape == "qwen":
        assert not any(layer.is_dense for layer in tm.model.layers)
        attn = tm.model.layers[0].self_attn
        assert (attn.num_heads, attn.num_kv_heads) == (14, 2)
    _check_against_jax(jm, tm, 256)


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_aux_loss_reaches_router_through_checkpoint(mode):
    ids = torch.from_numpy(_ids(512, seed=4))
    grads = []
    for rc in (False, True):
        _, tm = _pair(moe_dispatch_mode=mode, use_recompute=rc)
        moe = tm.model.layers[1].mlp.moe
        tm.model(ids)
        (aux,) = tm.model.aux_losses()
        grads.append(torch.autograd.grad(aux, moe.gate_weight)[0])
    assert grads[1].abs().max() > 0
    _close(grads[1].numpy(), grads[0].numpy(), 1e-6, "router grad")


def test_unknown_granularity_raises():
    _, tm = _pair(use_recompute=True, recompute_granularity="full")
    for layer in tm.model.layers:
        layer.recompute_granularity = "selective"
    with pytest.raises(ValueError, match="recompute_granularity"):
        tm(torch.from_numpy(_ids(512)))


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_recompute_train_steps_match_jax(mode):
    jm, tm = _pair(moe_dispatch_mode=mode, use_recompute=True,
                   recompute_granularity="full")
    ids = _ids(512, seed=1)
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    jx, tx = paddle.to_tensor(ids), torch.from_numpy(ids)
    j_losses = [float(jstep(jx, jx)) for _ in range(3)]
    t_losses = [float(tstep(tx, tx)) for _ in range(3)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]


def _jax_counts(cfg):
    """JAX's parameter counts and names of cfg's model, built abstractly
    (jax.eval_shape); the global key the build splits is put back."""
    out = []

    def build():
        m = jmoe_lm.MoEForCausalLM(cfg)
        out.append((m.num_params(), m.num_activated_params(),
                    [(n, tuple(p.shape)) for n, p in m.named_parameters()]))
        return 0

    gen = jcore.default_generator
    saved = gen._key_
    try:
        jax.eval_shape(build)
    finally:
        gen._key_ = saved
    return out[0]


@pytest.mark.parametrize("name,depth", [("deepseek_moe_16b_like", 3),
                                        ("qwen2_moe_a14b_like", 2)])
def test_full_width_param_counts_match_jax(name, depth):
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg = dataclasses.replace(getattr(jmoe_lm, name)(),
                               num_hidden_layers=depth)
    tcfg = getattr(tmoe_lm, name)(num_hidden_layers=depth)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    n, n_act, shapes = _jax_counts(jcfg)
    with FakeTensorMode():
        tm = tmoe_lm.MoEForCausalLM(tcfg, device="cpu")
        got = (tm.num_params(), tm.num_activated_params(),
               [(k, tuple(p.shape)) for k, p in tm.named_parameters()])
    assert got == (n, n_act, shapes)
    assert n > 1.3e9 and n_act < n
