"""The port's training slice against the JAX package on the CPU.

The JAX ``LlamaForCausalLM(llama_tiny())`` (float32) is built from
``paddle.seed(0)`` and its ``named_parameters()`` are carried into the
port's model by ``load_numpy_state``. Then, on the same token ids:
- logits atol=1e-4 and the shifted cross-entropy loss atol=1e-4;
- every parameter's grad atol=5e-5, rtol=5e-4: torch autograd against
  JAX's ``value_and_grad`` of the same loss as its ``TrainStep`` takes it
  (compiled: eager JAX compiles op by op and takes ~10 s here);
- 5 ``TrainStep``s with ``AdamW(1e-3)`` on each side: losses within
  rtol=1e-4 at every step;
- ``llama_tiny(dtype="bfloat16")`` (float32 Linear/Embedding weights,
  bfloat16 RMSNorm gains carried bit for bit, bfloat16 activations): one
  ``TrainStep`` gives a loss within 2e-2 of JAX's (bfloat16 rounds at
  other places in the two frameworks).
On the CPU the port's attention runs ``flash_attention_plain``, JAX's its
dense ``_sdpa_core``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch import models as tmodels  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402


def _ids(cfg, b=2, s=16):
    return np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _pair(dtype="float32"):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(dtype=dtype))
    tm = LlamaForCausalLM(llama_tiny(dtype=dtype), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _train(jm, tm, ids, steps):
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, lambda o, l: jm.loss(o, l), jo)
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l), to)
    jx = paddle.to_tensor(ids)
    tx = torch.as_tensor(ids)
    return ([float(jstep(jx, jx)) for _ in range(steps)],
            [float(tstep(tx, tx)) for _ in range(steps)])


def test_forward_loss_and_grads_match_jax():
    jm, tm = _pair()
    ids = _ids(tm.cfg)
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    j_params = [p._value for p in jstep._p_tensors]
    j_logits, _ = jax.jit(
        lambda ps, x: paddle.jit.functional_call(jm, ps, [], (x,)))(
        j_params, ids)
    j_loss, _, j_grads = jax.jit(jstep._make_loss_and_grads())(
        j_params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    t_logits = tm(torch.as_tensor(ids))
    t_loss = tm.loss(t_logits, torch.as_tensor(ids))
    t_loss.backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-4)
    t_params = dict(tm.named_parameters())
    assert jstep._param_names == list(t_params)
    for name, g in zip(jstep._param_names, j_grads):
        np.testing.assert_allclose(t_params[name].grad.numpy(),
                                   np.asarray(g), atol=5e-5, rtol=5e-4,
                                   err_msg=name)


def test_train_steps_match_jax():
    jm, tm = _pair()
    j_losses, t_losses = _train(jm, tm, _ids(tm.cfg), 5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]


def test_bf16_step_matches_jax():
    jm, tm = _pair("bfloat16")
    assert tm.model.layers[0].input_layernorm.weight.dtype == torch.bfloat16
    assert tm.model.layers[0].mlp.up_proj.weight.dtype == torch.float32
    j_losses, t_losses = _train(jm, tm, _ids(tm.cfg), 1)
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-2)


def test_weights_carry_is_checked():
    jm, tm = _pair()
    state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    bad = dict(state)
    bad.pop("model.norm.weight")
    with pytest.raises(ValueError, match="missing"):
        tm.load_numpy_state(bad)
    bad = dict(state, **{"model.norm.weight": state["model.norm.weight"]
                         .astype(np.float64)})
    with pytest.raises(ValueError, match="model.norm.weight"):
        tm.load_numpy_state(bad)


@pytest.mark.parametrize("field", [
    dict(use_recompute=True), dict(tensor_parallel=True),
    dict(tie_word_embeddings=True)])
def test_unported_training_configs_raise(field):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaForCausalLM(llama_tiny(**field), device="cpu")


@pytest.mark.parametrize("name", ["llama_tiny", "llama_small", "llama_mid",
                                  "llama_1b", "llama_3_8b"])
def test_configs_equal_jax(name):
    kw = dict(dtype="bfloat16")
    assert dataclasses.asdict(getattr(tmodels, name)(**kw)) == \
        dataclasses.asdict(getattr(jmodels, name)(**kw))
