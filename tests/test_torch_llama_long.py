"""The port's long-context training options against the JAX package on
the CPU: context parallelism (``LlamaConfig.sep_degree``, zigzag ring
attention over the fleet mesh's sep axis) and chunked cross entropy
(``chunked_ce_tokens``).

JAX models are built from ``paddle.seed`` and their
``named_parameters()`` carried into the port's models by
``load_numpy_state``.
- ``llama_tiny(sep_degree=2)`` under JAX's dp2 x sep2 x mp2 fleet mesh
  (8 virtual devices) against the port's under a sep-2 mesh on
  ``["cpu"] * 2``: loss within rtol 2e-4 and the layer-0 q_proj grad
  within rtol 5e-3, atol 1e-5 (JAX's ``test_cp_matches_single_device``).
- A sep axis of another size raises a ``ValueError`` naming "sep"; a
  sep config without a fleet mesh runs plain attention, as in JAX.
- ``chunked_ce_tokens=32`` at b2 x s33 (odd, so the chunks pad):
  loss within rtol 1e-5 and the embedding grad within rtol 1e-3, atol
  1e-5 of JAX's (tests/test_models.py:180-205), also with
  ``ignore_index`` labels and the transposed (tied) weight layout of
  the functional. The lm_head grad is held against the port's dense
  head: JAX's compiled TrainStep gives lm_head a zero gradient under
  chunked CE (ROADMAP queue 3).
- Three AdamW TrainSteps of the sep-2, chunked-CE model give the losses
  of the plain model (rtol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
import paddle_tpu.distributed.fleet as jfleet  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.nn.functional import loss as jloss  # noqa: E402
from paddle_tpu_torch.distributed import fleet as tfleet  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402


@pytest.fixture
def meshes():
    """Leaves no fleet mesh behind in either package."""
    yield
    jfleet._hcg = None
    tfleet._hcg = None


def _jax_fleet(**degrees):
    strategy = jdist.fleet.DistributedStrategy()
    strategy.hybrid_configs = degrees
    jfleet.init(is_collective=True, strategy=strategy)


def _port_fleet(sep):
    strategy = tfleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": sep}
    tfleet.init(strategy=strategy, devices=["cpu"] * sep)


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**kw))
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _jax_loss_and_grads(jm, ids, labels):
    """JAX's loss and {name: grad} as its TrainStep takes them, compiled
    (eager JAX compiles op by op)."""
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    loss, _, grads = jax.jit(jstep._make_loss_and_grads())(
        [p._value for p in jstep._p_tensors], [], jax.random.PRNGKey(0),
        (ids,), (labels,))
    return loss, dict(zip(jstep._param_names, grads))


def test_cp_matches_jax(meshes):
    ids = np.random.RandomState(1).randint(0, 512, (2, 64)).astype(np.int32)
    _jax_fleet(dp_degree=2, sep_degree=2, mp_degree=2)
    _port_fleet(2)
    jm, tm = _pair(5, sep_degree=2, max_position_embeddings=64)
    j_loss, j_grads = _jax_loss_and_grads(jm, ids, ids)
    tx = torch.as_tensor(ids)
    t_loss = tm.loss(tm(tx), tx)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=2e-4)
    name = "model.layers.0.self_attn.q_proj.weight"
    j_g = np.asarray(j_grads[name])
    t_g = dict(tm.named_parameters())[name].grad.numpy()
    np.testing.assert_allclose(t_g, j_g, rtol=5e-3, atol=1e-5)


def test_sep_mismatch_is_loud_and_no_mesh_is_plain(meshes):
    ids = torch.zeros((1, 64), dtype=torch.int32)
    cp = LlamaForCausalLM(llama_tiny(sep_degree=2), seed=0, device="cpu")
    plain = LlamaForCausalLM(llama_tiny(), seed=0, device="cpu")
    with torch.no_grad():
        assert torch.equal(cp(ids), plain(ids))      # no fleet mesh
    _port_fleet(4)
    with pytest.raises(ValueError, match="sep"):
        cp(ids)


@pytest.mark.parametrize("ignore_tail", [0, 7])
def test_chunked_ce_matches_jax(ignore_tail):
    jm, tm = _pair(0, chunked_ce_tokens=32)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 33)).astype(np.int32)   # 64 tokens + pad
    labels = ids.copy()
    if ignore_tail:
        labels[0, -ignore_tail:] = -100
    j_loss, j_grads = _jax_loss_and_grads(jm, ids, labels)
    hidden = tm(torch.as_tensor(ids))
    assert hidden.shape == (2, 33, tm.cfg.hidden_size)
    t_loss = tm.loss(hidden, torch.as_tensor(labels))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    name = "model.embed_tokens.weight"
    t_params = dict(tm.named_parameters())
    np.testing.assert_allclose(t_params[name].grad.numpy(),
                               np.asarray(j_grads[name]), rtol=1e-3,
                               atol=1e-5)
    # JAX's compiled step gives lm_head no gradient under chunked CE (the
    # loss reads the weight outside the functional call); the port's is
    # the dense head's, as JAX's eager backward gives it
    dense = LlamaForCausalLM(llama_tiny(), device="cpu")
    dense.load_numpy_state({n: p.detach().numpy() for n, p in
                            tm.named_parameters()})
    d_loss = dense.loss(dense(torch.as_tensor(ids)), torch.as_tensor(labels))
    d_loss.backward()
    np.testing.assert_allclose(t_loss.item(), d_loss.item(), rtol=1e-5)
    np.testing.assert_allclose(tm.lm_head.weight.grad.numpy(),
                               dense.lm_head.weight.grad.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_chunked_ce_transposed_weight_matches_jax():
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 20, 16).astype(np.float32)
    emb = rng.randn(40, 16).astype(np.float32) * 0.3
    labels = rng.randint(0, 40, (2, 20)).astype(np.int32)
    labels[1, -5:] = -100
    j = jloss.chunked_causal_lm_loss(
        paddle.to_tensor(hidden), paddle.to_tensor(labels), None,
        paddle.to_tensor(emb), 16)
    t = TF.chunked_causal_lm_loss(torch.tensor(hidden),
                                  torch.tensor(labels), None,
                                  torch.tensor(emb), 16)
    np.testing.assert_allclose(t.item(), float(j.numpy()), rtol=1e-5)
    dense = TF.cross_entropy(
        torch.tensor(hidden)[:, :-1].reshape(-1, 16) @ torch.tensor(emb).t(),
        torch.tensor(labels)[:, 1:].reshape(-1))
    np.testing.assert_allclose(t.item(), dense.item(), rtol=1e-5)


def test_cp_chunked_train_steps_equal_plain(meshes):
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 512, (2, 64)))
    losses = []
    for kw in (dict(), dict(sep_degree=2, chunked_ce_tokens=48)):
        if kw:
            _port_fleet(2)
        m = LlamaForCausalLM(llama_tiny(**kw), seed=4, device="cpu")
        step = TrainStep(m, m.loss, AdamW(learning_rate=1e-3,
                                          parameters=m.parameters()))
        losses.append([float(step(ids, ids)) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0]
