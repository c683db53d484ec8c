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
- The options JAX's config takes: tied embeddings (no ``lm_head``, the
  head ``h @ embed.T``) and recompute at each granularity ("full",
  "full_attn", "core_attn", and tied with "full_attn") at the same
  tolerances; tied with chunked cross entropy: the loss within 1e-5 of
  JAX's and the embedding grad within rtol 1e-3 of the port's dense tied
  head (JAX's compiled step drops the head's share of that grad, as it
  drops lm_head's under chunked CE: ROADMAP queue 3). Recompute gives
  the grads of the plain forward (rtol 1e-6), an unknown granularity
  raises ``ValueError``, and a full_attn model under a sep-2 fleet mesh
  on ``["cpu"] * 2`` gives JAX's sep-2 loss (rtol 2e-4).
- ``fleet.recompute`` replays an explicit generator's draws (attention
  dropout) in the recomputation when it is named in ``generators``: the
  grads equal the plain run's, which they do not without it.
- ``tensor_parallel`` / ``sequence_parallel`` with no fleet mesh give
  JAX's logits, loss and grads (the plain model, as JAX's gating
  builds); under an mp mesh that does not divide the kv heads the model
  raises ``ValueError`` as JAX's does (``tests/test_torch_tp.py`` holds
  the tp model itself).
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
from paddle_tpu_torch.distributed import fleet as tfleet  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
import paddle_tpu.distributed.fleet as jfleet  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402


def _ids(cfg, b=2, s=16):
    return np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _pair(dtype="float32", **kw):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(dtype=dtype, **kw))
    tm = LlamaForCausalLM(llama_tiny(dtype=dtype, **kw), device="cpu")
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


def _jax_grads(jm, ids, labels):
    """JAX's loss and {name: grad} as its compiled TrainStep takes them."""
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    loss, _, grads = jax.jit(jstep._make_loss_and_grads())(
        [p._value for p in jstep._p_tensors], [], jax.random.PRNGKey(0),
        (ids,), (labels,))
    return float(loss), dict(zip(jstep._param_names, grads))


def _port_grads(tm, ids):
    for p in tm.parameters():
        p.grad = None
    tx = torch.as_tensor(ids)
    out = tm(tx)
    loss = tm.loss(out, tx)
    loss.backward()
    return out.detach(), float(loss), {n: p.grad.clone() for n, p in
                                       tm.named_parameters()}


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


OPTIONS = {
    "tied": dict(tie_word_embeddings=True),
    "recompute_full": dict(use_recompute=True, recompute_granularity="full"),
    "recompute_full_attn": dict(use_recompute=True,
                                recompute_granularity="full_attn"),
    "recompute_core_attn": dict(use_recompute=True,
                                recompute_granularity="core_attn"),
    "tied_full_attn": dict(tie_word_embeddings=True, use_recompute=True,
                           recompute_granularity="full_attn"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_match_jax(option):
    jm, tm = _pair(**OPTIONS[option])
    if tm.cfg.tie_word_embeddings:
        assert tm.lm_head is None and jm.lm_head is None
    ids = _ids(tm.cfg)
    j_loss, j_grads = _jax_grads(jm, ids, ids)
    j_logits = np.asarray(jax.jit(
        lambda ps, x: paddle.jit.functional_call(
            jm, ps, [], (x,)))([p._value for p in jm.parameters()], ids)[0])
    t_logits, t_loss, t_grads = _port_grads(tm, ids)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=1e-4)
    np.testing.assert_allclose(t_loss, j_loss, atol=1e-4)
    assert list(t_grads) == list(j_grads)
    for name, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[name]),
                                   atol=5e-5, rtol=5e-4, err_msg=name)


def test_tied_chunked_ce_matches_jax():
    jm, tm = _pair(tie_word_embeddings=True, chunked_ce_tokens=8)
    ids = _ids(tm.cfg, s=13)             # 24 shifted tokens: 3 chunks
    j_loss, _ = _jax_grads(jm, ids, ids)
    hidden, t_loss, t_grads = _port_grads(tm, ids)
    assert hidden.shape == (2, 13, tm.cfg.hidden_size)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    dense = LlamaForCausalLM(llama_tiny(tie_word_embeddings=True),
                             device="cpu")
    dense.load_numpy_state({n: p.detach().numpy() for n, p in
                            tm.named_parameters()})
    _, d_loss, d_grads = _port_grads(dense, ids)
    np.testing.assert_allclose(t_loss, d_loss, rtol=1e-5)
    name = "model.embed_tokens.weight"
    np.testing.assert_allclose(t_grads[name].numpy(), d_grads[name].numpy(),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("granularity", ["full", "full_attn", "core_attn"])
def test_recompute_equals_plain(granularity):
    ids = _ids(llama_tiny())
    plain = LlamaForCausalLM(llama_tiny(), seed=2, device="cpu")
    remat = LlamaForCausalLM(llama_tiny(
        use_recompute=True, recompute_granularity=granularity), seed=2,
        device="cpu")
    _, p_loss, p_grads = _port_grads(plain, ids)
    _, r_loss, r_grads = _port_grads(remat, ids)
    assert r_loss == p_loss
    for name, g in r_grads.items():
        np.testing.assert_allclose(g.numpy(), p_grads[name].numpy(),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_unknown_granularity_raises():
    m = LlamaForCausalLM(llama_tiny(use_recompute=True,
                                    recompute_granularity="selective"),
                         device="cpu")
    with pytest.raises(ValueError, match="recompute_granularity"):
        m(torch.zeros((1, 4), dtype=torch.int64))


def test_full_attn_recompute_on_sep2_matches_jax():
    ids = np.random.RandomState(1).randint(0, 512, (2, 64)).astype(np.int32)
    try:
        strategy = jdist.fleet.DistributedStrategy()
        strategy.hybrid_configs = dict(dp_degree=2, sep_degree=2,
                                       mp_degree=2)
        jfleet.init(is_collective=True, strategy=strategy)
        ts = tfleet.DistributedStrategy()
        ts.hybrid_configs = {"sep_degree": 2}
        tfleet.init(strategy=ts, devices=["cpu"] * 2)
        jm, tm = _pair(sep_degree=2, max_position_embeddings=64,
                       use_recompute=True, recompute_granularity="full_attn")
        j_loss, j_grads = _jax_grads(jm, ids, ids)
        _, t_loss, t_grads = _port_grads(tm, ids)
    finally:
        jfleet._hcg = None
        tfleet._hcg = None
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-4)
    name = "model.layers.0.self_attn.q_proj.weight"
    np.testing.assert_allclose(t_grads[name].numpy(),
                               np.asarray(j_grads[name]), rtol=5e-3,
                               atol=1e-5)


def test_recompute_replays_generator_draws():
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(1, 16, 2, 8).astype(np.float32))
               for _ in range(3))

    def grads(mode):
        gen = torch.Generator().manual_seed(7)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def attn(a, b, c):
            return TF.scaled_dot_product_attention(
                a, b, c, dropout_p=0.3, is_causal=True, generator=gen)

        if mode == "plain":
            out = attn(*leaves)
        else:
            named = (gen,) if mode == "named" else ()
            out = tfleet.recompute(attn, *leaves, generators=named)
        (out * out).sum().backward()
        after = torch.rand(4, generator=gen)      # later draws unmoved
        return [x.grad for x in leaves], after

    plain, after_plain = grads("plain")
    named, after_named = grads("named")
    for a, b in zip(named, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(after_named.numpy(), after_plain.numpy())
    unnamed, _ = grads("unnamed")
    assert not all(torch.equal(a, b) for a, b in zip(unnamed, plain))


@pytest.mark.parametrize("field", [
    dict(tensor_parallel=True),
    dict(tensor_parallel=True, sequence_parallel=True)])
def test_unported_training_configs_raise(field):
    """tp is ported; under an mp mesh the kv heads (2) must divide mp 4,
    as JAX checks; sequence_parallel is read by nothing, as in JAX."""
    strategy = tfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 4}
    tfleet.init(strategy=strategy, devices=["cpu"] * 4)
    try:
        with pytest.raises(ValueError, match="must divide mp degree 4"):
            LlamaForCausalLM(llama_tiny(**field), device="cpu")
    finally:
        tfleet._hcg = tfleet._strategy = None


@pytest.mark.parametrize("field", [
    dict(tensor_parallel=True), dict(sequence_parallel=True)])
def test_inert_parallel_flags_match_jax(field):
    """With no fleet mesh both flags build the plain model, as JAX's
    _mp_active() gating (and its Llama, which never reads
    sequence_parallel) does: JAX's logits, loss and grads."""
    jm, tm = _pair(**field)
    ids = _ids(tm.cfg)
    j_loss, j_grads = _jax_grads(jm, ids, ids)
    t_logits, t_loss, t_grads = _port_grads(tm, ids)
    np.testing.assert_allclose(float(t_loss), j_loss, atol=1e-4)
    for n, g in j_grads.items():
        np.testing.assert_allclose(t_grads[n].numpy(), np.asarray(g),
                                   atol=5e-5, rtol=5e-4, err_msg=n)


@pytest.mark.parametrize("name", ["llama_tiny", "llama_small", "llama_mid",
                                  "llama_1b", "llama_3_8b"])
def test_configs_equal_jax(name):
    kw = dict(dtype="bfloat16")
    assert dataclasses.asdict(getattr(tmodels, name)(**kw)) == \
        dataclasses.asdict(getattr(jmodels, name)(**kw))
